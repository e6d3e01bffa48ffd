"""The superstep executor: the one outer iteration loop.

    init -> [ while not quiescent and iteration < max_iters: step ] -> done

:func:`run_engine` is host-driven: it reads ``quiescent`` once per global
iteration (one host sync, as the reference's host loop does; the paper's
barrier needs it anyway) and calls :class:`ExecHook` methods between
steps.  The reference's ``device_loop`` lowering has no counterpart in
eager PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from repro_torch.core.runtime import EngineState, quiescent
from repro_torch.exec.policy import EnginePolicy
from repro_torch.exec.syncs import host_read

__all__ = ["run_engine", "ExecContext", "ExecHook"]


@dataclasses.dataclass
class ExecContext:
    """Mutable view of a run, handed to every hook.

    ``iteration`` mirrors ``int(es.counters.iterations)`` after every step;
    ``tick`` counts host-loop trips (including trips a hook turned into a
    restore instead of a step).
    """

    graph: Any
    prog: Any
    policy: EnginePolicy | None
    vdata: Any
    es: EngineState
    iteration: int = 0
    tick: int = 0


class ExecHook:
    """Executor hook protocol — subclass and override what you need.

    ``on_start`` runs once before the loop; ``before_step`` runs every tick
    and may return ``False`` to skip this tick's step; ``after_step`` runs
    after each completed step; ``on_exit`` runs once after the loop.
    """

    def on_start(self, ctx: ExecContext) -> None: ...

    def before_step(self, ctx: ExecContext) -> bool | None: ...

    def after_step(self, ctx: ExecContext) -> None: ...

    def on_exit(self, ctx: ExecContext) -> None: ...


def run_engine(
    graph,
    prog,
    policy: EnginePolicy,
    vdata: Any = None,
    *,
    max_iters: int = 100_000,
    hooks: Sequence[ExecHook] = (),
    es: EngineState | None = None,
) -> ExecContext:
    """Run ``policy`` to quiescence (``policy.halt`` when it has one);
    returns the final :class:`ExecContext` (``ctx.es``,
    ``ctx.iteration``).  ``es`` seeds the loop (default:
    ``policy.init``)."""
    if es is None:
        es = policy.init(graph, prog, vdata)
    ctx = ExecContext(graph=graph, prog=prog, policy=policy, vdata=vdata,
                      es=es, iteration=int(es.counters.iterations))
    for h in hooks:
        h.on_start(ctx)

    def done(es) -> bool:
        if policy.halt is not None:
            return policy.halt(prog, es)
        return host_read(quiescent(prog, es))

    while ctx.iteration < max_iters and not done(ctx.es):
        ctx.tick += 1
        # evaluate every hook (clocks must advance even when another hook
        # consumes the tick), then skip the step if any said so
        if False in [h.before_step(ctx) for h in hooks]:
            continue
        ctx.es = policy.step(graph, prog, ctx.es, vdata)
        # the iteration count advances by exactly 1 per step (the policy
        # contract), so it is tracked on the host without a device read
        ctx.iteration += 1
        for h in hooks:
            h.after_step(ctx)

    for h in hooks:
        h.on_exit(ctx)
    return ctx
