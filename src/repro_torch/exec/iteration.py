"""The superstep bodies behind every run path, the PyTorch counterpart of
``repro.exec.iteration``.

Each function here is one unit of progress — a Hama superstep
(:func:`bsp_superstep`), an AM-Hama superstep (:func:`am_superstep`), or a
GraphHP global iteration (:func:`hybrid_iteration`) — over the same
runtime primitives (``exchange`` / ``deliver`` / ``apply_phase``),
differing only in how often they synchronize and how far the local phase
runs between synchronizations.  The executor
(:mod:`repro_torch.exec.driver`) iterates whichever body its policy names;
nothing here loops to quiescence.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.graph import PartitionedGraph
from repro_torch.core.runtime import (EngineState, apply_phase, deliver,
                                      ell_channels, exchange, init_state)
from repro_torch.core.vertex_program import StepInfo, VertexProgram
from repro_torch.exec.local_phase import local_phase

__all__ = ["bsp_superstep", "am_superstep", "hybrid_iteration",
           "init_hybrid", "reset_export", "exchange_phase", "bsp_delivery",
           "bsp_compute", "hybrid_remote_delivery", "hybrid_global_phase",
           "hybrid_local"]


def reset_export(prog: VertexProgram, es: EngineState) -> EngineState:
    """Clear the export buffer after an exchange: values to the channel
    identity, send flags off."""
    return dataclasses.replace(
        es, export_out=prog.export_identity(es.export_out),
        export_send=torch.zeros_like(es.export_send))


def _deliver_split(graph, prog, es, use_ell, collect_metrics):
    """Superstep delivery: remote + local halves when a channel can ride
    the ELL layouts (combine groups never mix local and remote edges, so
    counters are unchanged), else one dense 'all' pass."""
    if use_ell and ell_channels(graph, prog, es.out, es.send):
        es, _ = deliver(graph, prog, es, edges="remote", use_ell=True,
                        collect_metrics=collect_metrics)
        es, _ = deliver(graph, prog, es, edges="local", use_ell=True,
                        collect_metrics=collect_metrics)
    else:
        es, _ = deliver(graph, prog, es, edges="all",
                        collect_metrics=collect_metrics)
    return es


def _bump(es: EngineState, pseudo: bool) -> EngineState:
    """Count one global iteration (and, for a superstep, one
    pseudo-superstep in every partition)."""
    c = es.counters
    c = dataclasses.replace(c, iterations=c.iterations + 1)
    if pseudo:
        c = dataclasses.replace(c,
                                pseudo_supersteps=c.pseudo_supersteps + 1)
    return dataclasses.replace(es, counters=c)


def exchange_phase(graph, prog, es, gather_table=None,
                   wire_dtype=None) -> EngineState:
    """The one communication of a superstep / global iteration: gather
    export buffers through the halo plan (across ranks through
    ``gather_table``, quantized to ``wire_dtype``), then clear them."""
    es = exchange(graph, es, gather_table, wire_dtype=wire_dtype)
    return reset_export(prog, es)


def bsp_delivery(graph, prog, es, use_ell: bool = True,
                 collect_metrics: bool = True) -> EngineState:
    """Hama's delivery: every edge (remote + local halves on the ELL path,
    one dense 'all' pass otherwise)."""
    return _deliver_split(graph, prog, es, use_ell, collect_metrics)


def bsp_compute(graph, prog, es, vdata) -> EngineState:
    """Hama's bulk Compute() over all (active ∨ messaged) vertices, plus
    the superstep counter bump."""
    info = StepInfo(superstep=es.counters.iterations + 1, pseudo_step=0,
                    phase="superstep")
    es = apply_phase(graph, prog, es, graph.vertex_mask, info, vdata)
    return _bump(es, pseudo=True)


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
    return _bump(es, pseudo=False)


def bsp_superstep(
    graph: PartitionedGraph,
    prog: VertexProgram,
    es: EngineState,
    vdata: Any,
    gather_table: Callable | None = None,
    use_ell: bool = True,
    collect_metrics: bool = True,
) -> EngineState:
    """One Hama superstep: exchange -> deliver(all) -> Compute(all).

    With ``use_ell`` the delivery splits into remote + local halves so each
    half can run through its ELL layout; counters are unchanged, float
    'sum' inboxes may differ from the dense pass in the last bit (another
    fold order)."""
    es = exchange_phase(graph, prog, es, gather_table)
    es = bsp_delivery(graph, prog, es, use_ell, collect_metrics)
    return bsp_compute(graph, prog, es, vdata)


def am_superstep(
    graph: PartitionedGraph,
    prog: VertexProgram,
    es: EngineState,
    vdata: Any,
    gather_table: Callable | None = None,
    use_ell: bool = True,
    collect_metrics: bool = True,
) -> EngineState:
    """One AM-Hama superstep: Hama's cadence + in-memory delivery between
    two ordered half-blocks A|B of each partition's slots (the Grace
    mechanism, vectorized — see :mod:`repro_torch.core.engine_am`)."""
    es = exchange_phase(graph, prog, es, gather_table)
    es = bsp_delivery(graph, prog, es, use_ell, collect_metrics)

    slot = torch.arange(graph.vp, device=graph.device)[None, :]
    first = slot < graph.vp // 2
    half_a = torch.logical_and(graph.vertex_mask, first)
    half_b = torch.logical_and(graph.vertex_mask, torch.logical_not(first))

    info = StepInfo(superstep=es.counters.iterations + 1, pseudo_step=0,
                    phase="superstep")
    es = apply_phase(graph, prog, es, half_a, info, vdata)
    es, _ = deliver(graph, prog, es, edges="local", use_ell=use_ell,
                    collect_metrics=collect_metrics)   # A's, in memory
    es = apply_phase(graph, prog, es, half_b, info, vdata)
    # es.send is now B's senders only: A's in-partition messages were
    # delivered above, its cross-partition ones ride the export buffer
    return _bump(es, pseudo=True)


def hybrid_iteration(
    graph: PartitionedGraph,
    prog: VertexProgram,
    es: EngineState,
    vdata: Any,
    gather_table: Callable | None = None,
    max_local_steps: int = 100_000,
    wire_dtype=None,
    use_ell: bool = True,
    collect_metrics: bool = True,
) -> EngineState:
    """One global iteration: exchange -> global phase -> local phase.

    Delivery runs through the ELL kernels and the local phase through the
    fused `pr_step` / `min_step` kernels for programs declaring
    ``fused_kernel``; ``collect_metrics=False`` drops the paper's message
    accounting (counters other than iterations/pseudo-supersteps stay put).
    ``gather_table`` and ``wire_dtype`` go to the exchange
    (:func:`repro_torch.core.runtime.exchange`).
    """
    # -- 1. the one exchange ----------------------------------------------
    es = exchange_phase(graph, prog, es, gather_table, wire_dtype=wire_dtype)
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
