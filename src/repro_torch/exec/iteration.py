"""The GraphHP global iteration, the PyTorch counterpart of the hybrid half
of ``repro.exec.iteration``.

:func:`hybrid_iteration` is one unit of progress — exchange, remote
delivery, the global phase on boundary vertices, the local phase — over
the runtime primitives (``exchange`` / ``deliver`` / ``apply_phase``).  The
executor (:mod:`repro_torch.exec.driver`) iterates it; nothing here loops
to quiescence.  The Hama and AM-Hama superstep bodies wait for a later
slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.graph import PartitionedGraph
from repro_torch.core.runtime import (EngineState, apply_phase, deliver,
                                      exchange, init_state)
from repro_torch.core.vertex_program import StepInfo, VertexProgram
from repro_torch.exec.local_phase import local_phase

__all__ = ["hybrid_iteration", "init_hybrid", "reset_export",
           "exchange_phase", "hybrid_remote_delivery", "hybrid_global_phase",
           "hybrid_local"]


def reset_export(prog: VertexProgram, es: EngineState) -> EngineState:
    """Clear the export buffer after an exchange: values to the channel
    identity, send flags off."""
    return dataclasses.replace(
        es, export_out=prog.export_identity(es.export_out),
        export_send=torch.zeros_like(es.export_send))


def exchange_phase(graph, prog, es) -> EngineState:
    """The one communication of a global iteration: gather export buffers
    through the halo plan, then clear them."""
    return reset_export(prog, exchange(graph, es))


def hybrid_remote_delivery(graph, prog, es, use_ell: bool = True,
                           collect_metrics: bool = True) -> EngineState:
    """GraphHP: deliver the just-exchanged remote messages into pending."""
    es, _ = deliver(graph, prog, es, edges="remote", use_ell=use_ell,
                    collect_metrics=collect_metrics)
    return es


def hybrid_global_phase(graph, prog, es, vdata, use_ell: bool = True,
                        collect_metrics: bool = True) -> EngineState:
    """GraphHP's global phase: boundary vertices Compute() exactly once,
    then their same-partition messages are delivered for the immediate
    local phase (paper §4.2)."""
    it = es.counters.iterations + 1
    gmask = graph.is_boundary
    gonly = prog.global_only_active(es.state, vdata)
    if gonly is not None:
        gmask = torch.logical_or(gmask, torch.logical_and(es.active, gonly))
    info_g = StepInfo(superstep=it, pseudo_step=0, phase="global")
    es = apply_phase(graph, prog, es, gmask, info_g, vdata)
    es, _ = deliver(graph, prog, es, edges="local", use_ell=use_ell,
                    collect_metrics=collect_metrics)
    return es


def hybrid_local(graph, prog, es, vdata, max_local_steps: int = 100_000,
                 use_ell: bool = True,
                 collect_metrics: bool = True) -> EngineState:
    """GraphHP's local phase — pseudo-supersteps to per-partition
    quiescence — plus the global-iteration counter bump."""
    it = es.counters.iterations + 1
    es = local_phase(graph, prog, es, vdata, it,
                     max_local_steps=max_local_steps, use_ell=use_ell,
                     collect_metrics=collect_metrics)
    c = es.counters
    return dataclasses.replace(
        es, counters=dataclasses.replace(c, iterations=c.iterations + 1))


def hybrid_iteration(
    graph: PartitionedGraph,
    prog: VertexProgram,
    es: EngineState,
    vdata: Any,
    max_local_steps: int = 100_000,
    use_ell: bool = True,
    collect_metrics: bool = True,
) -> EngineState:
    """One global iteration: exchange -> global phase -> local phase.

    Delivery runs through the ELL kernels and the local phase through the
    fused `pr_step` / `min_step` kernels for programs declaring
    ``fused_kernel``; ``collect_metrics=False`` drops the paper's message
    accounting (counters other than iterations/pseudo-supersteps stay put).
    """
    # -- 1. the one exchange ----------------------------------------------
    es = exchange_phase(graph, prog, es)
    es = hybrid_remote_delivery(graph, prog, es, use_ell=use_ell,
                                collect_metrics=collect_metrics)
    # -- 2. global phase: boundary vertices, exactly once -----------------
    es = hybrid_global_phase(graph, prog, es, vdata, use_ell=use_ell,
                             collect_metrics=collect_metrics)
    # -- 3. local phase: pseudo-supersteps until per-partition quiescence --
    return hybrid_local(graph, prog, es, vdata,
                        max_local_steps=max_local_steps, use_ell=use_ell,
                        collect_metrics=collect_metrics)


def init_hybrid(graph: PartitionedGraph, prog: VertexProgram, vdata: Any,
                use_ell: bool = True,
                collect_metrics: bool = True) -> EngineState:
    """Initialization iteration (iteration 0): in-partition messages go to
    pending for iteration 1's phases, crossing messages ride the export
    buffer."""
    es = init_state(graph, prog, vdata)
    es, _ = deliver(graph, prog, es, edges="local", use_ell=use_ell,
                    collect_metrics=collect_metrics)
    return es
