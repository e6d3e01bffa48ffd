"""Engines as policy objects (the hybrid one, in this slice of the port).

An :class:`EnginePolicy` is an ``init`` building the starting
:class:`~repro_torch.core.runtime.EngineState` and a ``step`` advancing it
by one global iteration; the driver (:func:`repro_torch.exec.driver.
run_engine`) owns the loop, the halt rule and the hook points.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

from repro_torch.exec.iteration import hybrid_iteration, init_hybrid

__all__ = ["EnginePolicy", "hybrid_policy"]


@dataclasses.dataclass(frozen=True)
class EnginePolicy:
    """One engine = two functions.

    ``init(graph, prog, vdata) -> EngineState`` builds iteration 0's state;
    ``step(graph, prog, es, vdata) -> EngineState`` advances one
    synchronization-delimited unit and must increment
    ``counters.iterations`` by exactly 1.
    """

    name: str
    init: Callable
    step: Callable


def hybrid_policy(use_ell: bool = True, collect_metrics: bool = True,
                  max_local_steps: int = 100_000) -> EnginePolicy:
    """GraphHP: one exchange per global iteration, then pseudo-supersteps
    to per-partition quiescence (fused kernel local phase where eligible)."""
    return EnginePolicy(
        name="hybrid",
        init=partial(_hybrid_init, use_ell=use_ell,
                     collect_metrics=collect_metrics),
        step=partial(_hybrid_step, max_local_steps=max_local_steps,
                     use_ell=use_ell, collect_metrics=collect_metrics))


def _hybrid_step(graph, prog, es, vdata, **kw):
    return hybrid_iteration(graph, prog, es, vdata, **kw)


def _hybrid_init(graph, prog, vdata, **kw):
    return init_hybrid(graph, prog, vdata, **kw)
