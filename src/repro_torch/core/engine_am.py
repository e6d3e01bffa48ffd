"""AM-Hama: Hama + asynchronous in-memory messaging (paper §4.2 / §7).

Same superstep/exchange cadence as standard BSP, but messages between
co-located vertices are delivered in memory, and a message sent earlier in
a superstep may be consumed by a not-yet-processed vertex *within the same
superstep* (the Grace mechanism).

Vectorized adaptation: each partition's slots split into two ordered
half-blocks A|B.  A computes first, its in-partition messages are
delivered in memory, then B computes — every vertex still runs Compute()
at most once per superstep, and forward-crossing messages land in the same
superstep.  Cross-partition messages keep Hama's superstep latency.

Configuration only: the superstep body lives in
:mod:`repro_torch.exec.iteration` and the loop in
:mod:`repro_torch.exec.driver`.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.runtime import EngineState
from repro_torch.core.vertex_program import VertexProgram
from repro_torch.device import check_graph_device
from repro_torch.exec.driver import run_engine
from repro_torch.exec.iteration import am_superstep
from repro_torch.exec.policy import am_policy

__all__ = ["am_superstep", "run_am"]


def run_am(
    graph,
    prog: VertexProgram,
    vdata: Any = None,
    max_iters: int = 100_000,
    use_ell: bool = True,
    collect_metrics: bool = True,
    device: str | torch.device | None = None,
) -> tuple[EngineState, int]:
    """Host-driven loop: init superstep + AM supersteps until quiescence.

    Arguments, return value and device rules as
    :func:`repro_torch.core.engine_bsp.run_bsp`."""
    check_graph_device(graph, device)
    ctx = run_engine(graph, prog,
                     am_policy(use_ell=use_ell,
                               collect_metrics=collect_metrics),
                     vdata, max_iters=max_iters)
    return ctx.es, ctx.iteration
