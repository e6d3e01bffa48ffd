"""Engines as policy objects.

GraphHP, Hama and AM-Hama share one execution skeleton — initialize, then
iterate a synchronization-delimited step until quiescence — and differ
only in what one step does.  An :class:`EnginePolicy` is an ``init``
building the starting :class:`~repro_torch.core.runtime.EngineState` and a
``step`` advancing it by one superstep or global iteration; the driver
(:func:`repro_torch.exec.driver.run_engine`) owns the loop, the halt rule
and the hook points.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

from repro_torch.core.runtime import init_state
from repro_torch.exec.iteration import (am_superstep, bsp_superstep,
                                        hybrid_iteration, init_hybrid)

__all__ = ["EnginePolicy", "bsp_policy", "am_policy", "hybrid_policy",
           "POLICIES", "make_policy"]


@dataclasses.dataclass(frozen=True)
class EnginePolicy:
    """One engine = two functions.

    ``init(graph, prog, vdata) -> EngineState`` builds iteration 0's state;
    ``step(graph, prog, es, vdata) -> EngineState`` advances one
    synchronization-delimited unit and must increment
    ``counters.iterations`` by exactly 1.  ``halt(prog, es) -> bool`` is
    the termination check; ``None`` reads the engine state's own
    ``quiescent`` (the distributed step's halt is the cross-rank
    :func:`repro_torch.core.distributed.dist_quiescent`).
    """

    name: str
    init: Callable
    step: Callable
    halt: Callable | None = None


def bsp_policy(use_ell: bool = True, collect_metrics: bool = True,
               gather_table: Callable | None = None) -> EnginePolicy:
    """Hama: one exchange + one bulk Compute() per superstep."""
    return EnginePolicy(
        name="bsp", init=_state_init,
        step=partial(_bsp_step, gather_table=gather_table, use_ell=use_ell,
                     collect_metrics=collect_metrics))


def am_policy(use_ell: bool = True, collect_metrics: bool = True,
              gather_table: Callable | None = None) -> EnginePolicy:
    """AM-Hama: Hama's cadence + in-memory same-superstep local delivery."""
    return EnginePolicy(
        name="am", init=_state_init,
        step=partial(_am_step, gather_table=gather_table, use_ell=use_ell,
                     collect_metrics=collect_metrics))


def hybrid_policy(use_ell: bool = True, collect_metrics: bool = True,
                  max_local_steps: int = 100_000,
                  gather_table: Callable | None = None,
                  wire_dtype=None) -> EnginePolicy:
    """GraphHP: one exchange per global iteration, then pseudo-supersteps
    to per-partition quiescence (fused kernel local phase where eligible)."""
    return EnginePolicy(
        name="hybrid",
        init=partial(_hybrid_init, use_ell=use_ell,
                     collect_metrics=collect_metrics),
        step=partial(_hybrid_step, gather_table=gather_table,
                     max_local_steps=max_local_steps, wire_dtype=wire_dtype,
                     use_ell=use_ell, collect_metrics=collect_metrics))


# module-level step adapters (not closures), so the partials stay picklable
def _state_init(graph, prog, vdata):
    return init_state(graph, prog, vdata)


def _bsp_step(graph, prog, es, vdata, **kw):
    return bsp_superstep(graph, prog, es, vdata, **kw)


def _am_step(graph, prog, es, vdata, **kw):
    return am_superstep(graph, prog, es, vdata, **kw)


def _hybrid_step(graph, prog, es, vdata, **kw):
    return hybrid_iteration(graph, prog, es, vdata, **kw)


def _hybrid_init(graph, prog, vdata, **kw):
    return init_hybrid(graph, prog, vdata, **kw)


POLICIES: dict[str, Callable[..., EnginePolicy]] = {
    "bsp": bsp_policy,
    "am": am_policy,
    "hybrid": hybrid_policy,
}


def make_policy(name: str, **knobs: Any) -> EnginePolicy:
    """Build a policy by engine name ('bsp' | 'am' | 'hybrid')."""
    if name not in POLICIES:
        raise KeyError(f"unknown engine {name!r}; have {sorted(POLICIES)}")
    return POLICIES[name](**knobs)
