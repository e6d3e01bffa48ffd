"""GraphHP hybrid engine — the paper's contribution (§4.2, §5.2, Algorithm 2).

One *global iteration* =
  1. exchange of the export buffers (the ONLY cross-partition
     communication and the only synchronization point),
  2. **global phase**: each active boundary vertex runs Compute() exactly
     once, consuming the messages buffered since the previous iteration,
  3. **local phase**: pseudo-supersteps iterated per partition, in memory,
     until every participating vertex is inactive and no local message is
     in transit (Algorithm 2's inner while loop).

Configuration only: the iteration body lives in
:mod:`repro_torch.exec.iteration`, the local phase and its fused kernels
in :mod:`repro_torch.exec.local_phase`, and the loop in
:mod:`repro_torch.exec.driver`.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.runtime import EngineState
from repro_torch.core.vertex_program import VertexProgram
from repro_torch.device import check_graph_device
from repro_torch.exec.driver import run_engine
from repro_torch.exec.iteration import hybrid_iteration, init_hybrid
from repro_torch.exec.local_phase import fused_step_fn
from repro_torch.exec.policy import hybrid_policy

__all__ = ["hybrid_iteration", "run_hybrid", "init_hybrid", "fused_step_fn"]


def run_hybrid(
    graph,
    prog: VertexProgram,
    vdata: Any = None,
    max_iters: int = 100_000,
    max_local_steps: int = 100_000,
    use_ell: bool = True,
    collect_metrics: bool = True,
    device_loop: bool = True,
    device: str | torch.device | None = None,
) -> tuple[EngineState, int]:
    """Run global iterations to quiescence.

    The reference's signature, plus ``device``.  ``device_loop=True``
    (default) runs the whole outer loop on the device: on the card one
    CUDA graph whose WHILE node iterates the global iteration, with each
    local phase's WHILE node nested in it, so the host syncs exactly once,
    at the end.  ``device_loop=False`` keeps the host-driven outer loop (one
    ``quiescent`` read per global iteration; each local phase still loops
    on the device), for stepping iteration by iteration.

    Args:
        graph: the ``PartitionedGraph`` to iterate over, on ``device``.
        prog: the ``VertexProgram``; its channels decide kernel dispatch.
        vdata: optional per-run auxiliary tensors for the program's hooks.
        max_iters: upper bound on global iterations.
        max_local_steps: per-iteration cap on local pseudo-supersteps
            (with rollback semantics for the fused kernels).
        use_ell: deliver through the sliced-ELL kernels where the program
            qualifies; ``False`` forces the dense gather/segment path
            (identical results and counters).
        collect_metrics: maintain the paper's message counters.
        device_loop: see above; both loops give the same state, iterations
            and counters.
        device: where the run happens — ``cuda`` unless ``"cpu"`` is
            passed; the graph must already live there.

    Returns:
        ``(es, iterations)`` — the final ``EngineState`` (per-channel state
        stacked ``(P, Vp[, L])``; read it back in global vertex order with
        ``repro_torch.core.graph.unpack_vertex``) and the number of global
        iterations executed.

    Raises:
        RuntimeError: CUDA asked for (the default) and absent.
        ValueError: the graph lives on another device.
    """
    check_graph_device(graph, device)
    policy = hybrid_policy(use_ell=use_ell, collect_metrics=collect_metrics,
                           max_local_steps=max_local_steps)
    ctx = run_engine(graph, prog, policy, vdata, max_iters=max_iters,
                     device_loop=device_loop)
    return ctx.es, ctx.iteration
