"""The superstep executor: the one outer iteration loop.

    init -> [ while not quiescent and iteration < max_iters: step ] -> done

Two lowerings of the same loop, as in the reference:

* :func:`run_engine` — host-driven by default: it reads ``quiescent`` once
  per global iteration (one host sync) and calls :class:`ExecHook` methods
  between steps.  ``device_loop=True`` runs the whole loop on the device
  instead, through :func:`while_engine`, and reads the host once, at the
  end; it rejects hooks that need to run between steps.
* :func:`while_engine` — the loop as
  :func:`repro_torch.exec.device_loop.while_loop`: on the card a WHILE
  node of a CUDA graph whose body is the step (the local phase's own loop
  nested inside it), on the CPU a host loop.

Both run inside one :func:`~repro_torch.exec.device_loop.graph_cache`, so a
run builds each local-phase graph once, not once per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from repro_torch.core.runtime import EngineState, build_ell_plans, quiescent
from repro_torch.exec.device_loop import graph_cache, while_loop
from repro_torch.exec.policy import EnginePolicy
from repro_torch.exec.syncs import host_read, host_read_int

__all__ = ["run_engine", "while_engine", "ExecContext", "ExecHook"]


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


def while_engine(prog, step: Callable, es: EngineState, max_iters: int):
    """The device-side loop: iterate ``step`` (``es -> es``) until
    quiescence or ``max_iters``, as one
    :func:`~repro_torch.exec.device_loop.while_loop` (a WHILE node of a
    CUDA graph on the card).  Called inside another loop's capture, it
    nests there."""
    def cond(e):
        return torch.logical_and(torch.logical_not(quiescent(prog, e)),
                                 e.counters.iterations < max_iters)

    return while_loop(cond, step, es)


def run_engine(
    graph,
    prog,
    policy: EnginePolicy,
    vdata: Any = None,
    *,
    max_iters: int = 100_000,
    hooks: Sequence[ExecHook] = (),
    es: EngineState | None = None,
    jit_step: Callable | None = None,
    device_loop: bool = False,
) -> ExecContext:
    """Run ``policy`` to quiescence (``policy.halt`` when it has one);
    returns the final :class:`ExecContext` (``ctx.es``,
    ``ctx.iteration``).

    ``es`` seeds the loop (default: ``policy.init``); ``jit_step``
    overrides the step ``es -> es`` (default: ``policy.step`` on this
    graph, program and ``vdata``).  ``device_loop=True`` runs the whole
    loop on the device (:func:`while_engine`) and reads the host once, at
    the end; hooks then only see ``on_start`` / ``on_exit`` (there is no
    host boundary between steps), so it rejects hooks that override the
    per-step methods, and a policy whose ``halt`` reads the host.
    """
    build_ell_plans(graph)        # before any capture reads them
    fresh = es is None
    if fresh:
        es = policy.init(graph, prog, vdata)
    if jit_step is None:
        def jit_step(e):
            return policy.step(graph, prog, e, vdata)

    # a fresh state is at iteration 0: no read needed to know it
    ctx = ExecContext(graph=graph, prog=prog, policy=policy, vdata=vdata,
                      es=es, iteration=0 if fresh
                      else int(es.counters.iterations))
    for h in hooks:
        h.on_start(ctx)

    if device_loop:
        stepwise = [h for h in hooks
                    if type(h).before_step is not ExecHook.before_step
                    or type(h).after_step is not ExecHook.after_step]
        if stepwise:
            raise ValueError(
                f"device_loop=True runs with no host boundary between "
                f"steps; hooks {[type(h).__name__ for h in stepwise]} "
                f"override before_step/after_step and need the host loop")
        if policy.halt is not None:
            raise ValueError(
                f"device_loop=True decides quiescence on the device; policy "
                f"{policy.name!r} halts through a host read and needs the "
                f"host loop")
        with graph_cache():
            ctx.es = while_engine(prog, jit_step, ctx.es, max_iters)
            ctx.iteration = host_read_int(ctx.es.counters.iterations)
    else:
        def done(es) -> bool:
            if policy.halt is not None:
                return policy.halt(prog, es)
            return host_read(quiescent(prog, es))

        with graph_cache():
            while ctx.iteration < max_iters and not done(ctx.es):
                ctx.tick += 1
                # evaluate every hook (clocks must advance even when another
                # hook consumes the tick), then skip the step if any said so
                if False in [h.before_step(ctx) for h in hooks]:
                    continue
                ctx.es = jit_step(ctx.es)
                # the iteration count advances by exactly 1 per step (the
                # policy contract), so it is tracked on the host without a
                # device read
                ctx.iteration += 1
                for h in hooks:
                    h.after_step(ctx)

    for h in hooks:
        h.on_exit(ctx)
    return ctx
