"""Standard BSP engine (the paper's Hama baseline).

Every superstep = one exchange + one bulk Compute() over all (active ∨
messaged) vertices.  Synchronization/communication frequency is
O(#supersteps) — the inefficiency GraphHP attacks.

Message accounting follows the paper's Hama baseline: *all* messages
travel through the distributed mechanism (RPC "by default", §4.1), so M
counts both same-partition and cross-partition combined groups.

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
from repro_torch.exec.iteration import bsp_superstep
from repro_torch.exec.policy import bsp_policy

__all__ = ["bsp_superstep", "run_bsp"]


def run_bsp(
    graph,
    prog: VertexProgram,
    vdata: Any = None,
    max_iters: int = 100_000,
    use_ell: bool = True,
    collect_metrics: bool = True,
    device: str | torch.device | None = None,
) -> tuple[EngineState, int]:
    """Host-driven loop: init superstep + supersteps until quiescence.

    ``device`` is where the run happens — ``cuda`` unless ``"cpu"`` is
    passed; the graph must already live there.  Returns ``(es,
    iterations)`` as :func:`repro_torch.core.engine_hybrid.run_hybrid`
    does; raises ``RuntimeError`` when CUDA is asked for and absent."""
    check_graph_device(graph, device)
    ctx = run_engine(graph, prog,
                     bsp_policy(use_ell=use_ell,
                                collect_metrics=collect_metrics),
                     vdata, max_iters=max_iters)
    return ctx.es, ctx.iteration
