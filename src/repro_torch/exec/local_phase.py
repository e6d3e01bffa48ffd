"""The GraphHP local phase: pseudo-supersteps to per-partition quiescence.

Everything that happens *inside* a partition between two synchronization
points — the participation/scheduling masks, the fused local phases through
the `pr_step` / `min_step` CUDA kernels, and the generic apply -> deliver
loop — behind one entry point, :func:`local_phase`.  The hybrid policy
calls it once per global iteration; ``chip_smoke.py`` calls
:func:`fused_step_fn` directly and holds it against the same step built
over the kernels' plain versions, so the steps it checks are the ones the
engine runs.

Each loop is the reference's ``lax.while_loop``, written as ``cond`` /
``body`` over a carry and run by
:func:`repro_torch.exec.device_loop.while_loop`: on the card a conditional
WHILE node of a CUDA graph, so no pseudo-superstep reads the host (the
condition, ``running.any() and k < max_local_steps``, is computed on the
device); on the CPU the same functions in a host loop.  Results, trip
counts and counters are the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.graph import PartitionedGraph
from repro_torch.core.runtime import (EngineState, _has_any_pending,
                                      apply_phase, deliver,
                                      ell_combine_bins, ell_plans,
                                      ell_send_accounting, slice_flat)
from repro_torch.core.vertex_program import StepInfo, VertexProgram
from repro_torch.exec.device_loop import while_loop
from repro_torch.kernels.common import (MONOTONE_SEMIRINGS, SEMIRINGS, f32,
                                        semiring_improves)
from repro_torch.kernels.ell_spmv import ell_spmv_ref
from repro_torch.kernels.min_step import fused_min_step, fused_min_step_ref
from repro_torch.kernels.pr_step import fused_pr_step, fused_pr_step_ref

__all__ = ["local_phase", "fused_step_fn", "participation_mask",
           "partition_running", "fused_local_kernel"]


def participation_mask(graph: PartitionedGraph,
                       prog: VertexProgram) -> torch.Tensor:
    """Vertices eligible for local-phase computation (paper §4.2: boundary
    vertices join local phases for incremental algorithms)."""
    if prog.boundary_participates:
        return graph.vertex_mask
    return torch.logical_and(graph.vertex_mask,
                             torch.logical_not(graph.is_boundary))


def partition_running(graph, prog, es, participate, vdata) -> torch.Tensor:
    """(P,) — does any participating vertex still need a pseudo-superstep?"""
    act = es.active
    gonly = prog.global_only_active(es.state, vdata)
    if gonly is not None:
        act = torch.logical_and(act, torch.logical_not(gonly))
    need = torch.logical_or(act, _has_any_pending(prog, es.pending))
    return torch.any(torch.logical_and(need, participate), dim=1)


def fused_local_kernel(graph: PartitionedGraph, prog: VertexProgram,
                       use_ell: bool, max_local_steps: int) -> str | None:
    """Static gate for the fully-fused local phase: the kernel name
    ('pr_step' | 'min_step') when the program declares one and the graph
    carries a dense-base sliced-ELL layout, else None (generic loop)."""
    if not (use_ell and graph.has_ell and max_local_steps > 0
            and len(prog.channels) == 1 and prog.boundary_participates
            and graph.local_ell[0].dense):
        return None
    kern = getattr(prog, "fused_kernel", None)
    if kern == "min_step":
        ch = prog.channels[0]
        # any monotone semiring fuses, provided the channel's combiner is
        # that semiring's ⊕ (the kernel's adopt-if-better state update)
        if (ch.semiring not in MONOTONE_SEMIRINGS
                or ch.combiner != ch.semiring.split("_")[0]):
            return None
        # the fused loop keeps the whole vertex state in float32: integer
        # states need every vertex id exactly representable
        (dt, _), = ch.components
        if not dt.is_floating_point and graph.n_vertices - 1 > (1 << 24):
            return None
    return kern if kern in ("pr_step", "min_step") else None


def _spill_extra(graph: PartitionedGraph, prog, ch, slices, views, out_d,
                 send, p, spmv=None):
    """⊕-combined spill-bin contributions (P*Vp, ...) for a fused kernel's
    ``extra`` operand — None when the layout is a single dense bin."""
    if len(slices) == 1:
        return None
    _, _, ident = SEMIRINGS[ch.semiring]
    x = prog.ell_payload(ch, out_d, send)
    x = x.reshape((-1,) + tuple(x.shape[2:])).to(torch.float32)
    extra = torch.full((p * graph.vp,) + tuple(x.shape[1:]), ident,
                       dtype=torch.float32, device=x.device)
    return ell_combine_bins(prog, ch, slices[1:], views[1:], x, extra,
                            spmv=spmv, plans=ell_plans(graph, "local")[1:])


def fused_step_fn(graph: PartitionedGraph, prog: VertexProgram, kind: str,
                  p: int, *, plain: bool = False):
    """The single fused pseudo-superstep over the graph's sliced-ELL layout
    — the one implementation the engine's local phases and ``chip_smoke.py``
    both run.

    'pr_step': ``step(rank, delta, send) -> (rank', d_in, send')``;
    'min_step': ``step(x, send) -> (x', d_in, send')``.  All tensors are
    (p, Vp) — or (p, Vp, L) for a lane channel — and spill bins beyond the
    dense base feed the kernel's ``extra`` operand through ``ell_spmv``
    (the ⊕ identity when there are none, still combined in).  ``plain``
    builds the same step over the kernels' plain versions (``*_ref``).
    Returns ``(step, slices, views)``.
    """
    ch = prog.channels[0]
    vp = graph.vp
    slices = graph.local_ell
    views = [slice_flat(s, graph, p) for s in slices]
    _, idx, msk = views[0]
    spmv = ell_spmv_ref if plain else None
    flat = lambda a: a.reshape((-1,) + tuple(a.shape[2:]))
    unflat = lambda a: a.reshape((p, vp) + tuple(a.shape[1:]))

    if kind == "pr_step":
        val = slices[0].val.reshape(-1, slices[0].kb)
        kern = fused_pr_step_ref if plain else fused_pr_step

        def step(rank, delta, send):
            extra = _spill_extra(graph, prog, ch, slices, views,
                                 {ch.name: delta}, send, p, spmv)
            if extra is None:
                extra = torch.zeros_like(flat(rank))
            r, d, s = kern(idx, val, msk, flat(delta), flat(send),
                           flat(rank), extra, damping=prog.damping,
                           tol=prog.tol)
            return unflat(r), unflat(d), unflat(s)
    elif kind == "min_step":
        val = prog.ell_edge_values(ch, slices[0].val).reshape(
            -1, slices[0].kb)
        kern = fused_min_step_ref if plain else fused_min_step
        ident = SEMIRINGS[ch.semiring][2]

        def step(x, send):
            xf = flat(x)
            extra = _spill_extra(graph, prog, ch, slices, views,
                                 {ch.name: x}, send, p, spmv)
            if extra is None:
                extra = torch.full_like(xf, ident)
            xn, d, s = kern(idx, val, msk, xf, flat(send), xf, extra,
                            semiring=ch.semiring)
            return unflat(xn), unflat(d), unflat(s)
    else:
        raise ValueError(kind)
    return step, slices, views


def _lane_views(lanes: int):
    """``ex`` broadcasts vertex masks against lane arrays, ``vany``
    collapses lane flags to the vertex level; both the identity for a
    scalar channel."""
    if lanes:
        return (lambda a: a[..., None]), (lambda a: torch.any(a, dim=-1))
    return (lambda a: a), (lambda a: a)


def _fused_pr_local_phase(graph, prog, es, running0, max_local_steps,
                          collect_metrics) -> EngineState:
    """Local phase fused through the `pr_step` kernel: one kernel call per
    pseudo-superstep performs deliver(s) + apply(s+1).

    Kernel contract (``prog.fused_kernel == 'pr_step'``): single 'sum'
    channel, always-valid emit ``x[src] * w`` with w > 0 and sent deltas
    > tol > 0 (so d_in > 0 <=> has-message), apply ``rank += delta; send =
    delta > tol``, never self-activating, additive SourceCombine, boundary
    vertices participating.  The bootstrap runs the first apply (consuming
    the inbox filled by the global phase) in plain torch, then the loop
    iterates the kernel; trip count and counters match the generic path.
    """
    p = es.send.shape[0]
    ch = prog.channels[0]
    kstep, slices, views = fused_step_fn(graph, prog, "pr_step", p)
    tol = f32(prog.tol)
    name = ch.name
    ex, vany = _lane_views(ch.lanes)

    (p0,), has0 = es.pending[name]
    # bootstrap: apply_1 consumes the inbox (payload is 0 wherever ~has)
    rank = es.state["rank"] + p0
    send = p0 > tol
    if ch.lanes:
        out_delta = torch.where(ex(has0), torch.where(send, p0, 0.0),
                                es.out["delta"])
    else:
        out_delta = torch.where(has0, p0, es.out["delta"])
    exp_out = es.export_out["delta"] + torch.where(send, p0, 0.0)
    exp_send = torch.logical_or(es.export_send, vany(send))
    c0 = es.counters
    dev = rank.device

    def cond(carry):
        running, k = carry[7], carry[10]
        return torch.logical_and(torch.any(running), k < max_local_steps)

    def body(carry):
        (rank, delta, send, has, out_d, eo, esend, running, pseudo,
         metrics, k, _prev) = carry
        # pre-step apply state, so a max_local_steps cutoff can roll the
        # final fused apply back to generic-path semantics (see below)
        prev = (rank, out_d, eo, esend, send)
        rank_n, d_in, send_n = kstep(rank, delta, send)
        net_local, mem = metrics
        if collect_metrics:
            has_n, mem_inc = ell_send_accounting(graph, slices, views,
                                                 vany(send).reshape(-1), p)
            net_local = net_local + has_n.sum()
            mem = mem + mem_inc
        else:
            has_n = vany(d_in > 0)     # positive-contribution invariant
        if ch.lanes:
            out_d = torch.where(ex(has_n), torch.where(send_n, d_in, 0.0),
                                out_d)
        else:
            out_d = torch.where(has_n, d_in, out_d)
        eo = eo + torch.where(send_n, d_in, 0.0)
        esend = torch.logical_or(esend, vany(send_n))
        running = torch.any(has_n, dim=1)
        pseudo = pseudo + running.to(pseudo.dtype)
        return (rank_n, d_in, send_n, has_n, out_d, eo, esend, running,
                pseudo, (net_local, mem), k + 1, prev)

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    carry0 = (rank, p0, send, has0, out_delta, exp_out, exp_send, running0,
              c0.pseudo_supersteps, (zero, zero), zero,
              (rank, out_delta, exp_out, exp_send, send))
    (rank, delta, send, has, out_delta, exp_out, exp_send, _, pseudo,
     (net_local, mem), _, prev) = while_loop(cond, body, carry0)

    # max_local_steps cutoff: the kernel already folded the final delivery
    # into rank/out/export, but the generic path leaves it pending-only for
    # the next iteration's apply — roll the non-pending state back one step.
    # At a quiescent exit `has` is all-False and this is the identity.
    cut = torch.any(has)
    rank_p, out_p, eo_p, esend_p, send_p = prev
    rank = torch.where(cut, rank_p, rank)
    out_delta = torch.where(cut, out_p, out_delta)
    exp_out = torch.where(cut, eo_p, exp_out)
    exp_send = torch.where(cut, esend_p, exp_send)
    send = torch.where(cut, send_p, send)

    counters = dataclasses.replace(
        c0, pseudo_supersteps=pseudo,
        net_local_messages=c0.net_local_messages + net_local,
        mem_messages=c0.mem_messages + mem)
    return dataclasses.replace(
        es, state={"rank": rank}, out={"delta": out_delta}, send=vany(send),
        pending={name: ((delta,), has)},
        export_out={"delta": exp_out}, export_send=exp_send,
        counters=counters)


def _fused_min_local_phase(graph, prog, es, running0, max_local_steps,
                           collect_metrics) -> EngineState:
    """Local phase fused through the `min_step` kernel — the monotone-
    semiring twin of :func:`_fused_pr_local_phase` (SSSP and the other
    adopt-if-better programs), with the same cutoff rollback.

    Kernel contract (``prog.fused_kernel == 'min_step'``): one single-
    component channel whose combiner is the ⊕ of its monotone semiring and
    whose state, out and channel share one name and value, always-valid
    emit ``x[src] ⊗ edge_val``, apply ``new = state ⊕ msg; send = new
    improves state``, never self-activating, keep-latest SourceCombine,
    boundary vertices participating.  The state rides the loop as float32
    and is cast back under the vertex mask on exit.
    """
    ch = prog.channels[0]
    name = ch.name
    dt, ident = ch.components[0]
    combine, _, sr_ident = SEMIRINGS[ch.semiring]
    improves = semiring_improves(ch.semiring)
    p = es.send.shape[0]
    kstep, slices, views = fused_step_fn(graph, prog, "min_step", p)
    vmask = graph.vertex_mask
    ex, vany = _lane_views(ch.lanes)

    (m0,), has0 = es.pending[name]
    x0 = es.state[name].to(torch.float32)
    eo0 = es.export_out[name]
    # bootstrap: apply_1 consumes the inbox (payload is the ⊕ identity
    # wherever ~has, so the combines need no explicit compute mask)
    m0f = torch.where(ex(has0), m0.to(torch.float32), sr_ident)
    x1 = combine(x0, m0f)
    send1 = improves(x1, x0)
    eo = torch.where(ex(vany(send1)), x1, eo0.to(torch.float32))
    esend = torch.logical_or(es.export_send, vany(send1))
    c0 = es.counters

    def cond(carry):
        running, k = carry[6], carry[9]
        return torch.logical_and(torch.any(running), k < max_local_steps)

    def body(carry):
        (x, d_in, send, has, eo, esend, running, pseudo, metrics, k,
         _prev) = carry
        # pre-step apply state for the max_local_steps cutoff rollback
        prev = (x, eo, esend, send)
        x_n, d_n, send_n = kstep(x, send)
        net_local, mem = metrics
        if collect_metrics:
            has_n, mem_inc = ell_send_accounting(graph, slices, views,
                                                 vany(send).reshape(-1), p)
            net_local = net_local + has_n.sum()
            mem = mem + mem_inc
        else:
            # some sender beat the identity (any lane)
            has_n = vany(improves(d_n, sr_ident))
        eo = torch.where(ex(vany(send_n)), x_n, eo)
        esend = torch.logical_or(esend, vany(send_n))
        running = torch.any(has_n, dim=1)
        pseudo = pseudo + running.to(pseudo.dtype)
        return (x_n, d_n, send_n, has_n, eo, esend, running, pseudo,
                (net_local, mem), k + 1, prev)

    zero = torch.zeros((), dtype=torch.int64, device=x1.device)
    carry0 = (x1, m0f, send1, has0, eo, esend, running0,
              c0.pseudo_supersteps, (zero, zero), zero,
              (x1, eo, esend, send1))
    (x, d_in, send, has, eo, esend, _, pseudo, (net_local, mem), _,
     prev) = while_loop(cond, body, carry0)

    # max_local_steps cutoff: roll the final fused apply back so the still-
    # pending delivery is not applied twice (identity at a quiescent exit)
    cut = torch.any(has)
    x_p, eo_p, esend_p, send_p = prev
    x = torch.where(cut, x_p, x)
    eo = torch.where(cut, eo_p, eo)
    esend = torch.where(cut, esend_p, esend)
    send = torch.where(cut, send_p, send)

    # leave the float32 loop: integer states cast back exactly (gate) under
    # the vertex mask, so padded sentinel slots keep their original bits
    state = torch.where(ex(vmask), x.to(dt), es.state[name])
    exp_out = torch.where(ex(vmask), eo.to(dt), eo0)
    payload = torch.where(ex(has), d_in.to(dt), ident)

    counters = dataclasses.replace(
        c0, pseudo_supersteps=pseudo,
        net_local_messages=c0.net_local_messages + net_local,
        mem_messages=c0.mem_messages + mem)
    return dataclasses.replace(
        es, state={name: state}, out={name: state}, send=vany(send),
        pending={name: ((payload,), has)},
        export_out={name: exp_out}, export_send=esend,
        counters=counters)


def local_phase(
    graph: PartitionedGraph,
    prog: VertexProgram,
    es: EngineState,
    vdata: Any,
    superstep,
    max_local_steps: int = 100_000,
    use_ell: bool = True,
    collect_metrics: bool = True,
) -> EngineState:
    """Pseudo-supersteps to per-partition quiescence (Algorithm 2's inner
    while loop) — the defining move of the hybrid policy.

    Dispatches to a fused kernel phase when the program and graph qualify
    (:func:`fused_local_kernel`), else iterates the generic apply ->
    local-deliver loop with a per-partition ``running`` mask.
    """
    participate = participation_mask(graph, prog)
    running0 = partition_running(graph, prog, es, participate, vdata)
    c0 = es.counters
    es = dataclasses.replace(es, counters=dataclasses.replace(
        c0, pseudo_supersteps=c0.pseudo_supersteps
        + running0.to(c0.pseudo_supersteps.dtype)))

    fused = fused_local_kernel(graph, prog, use_ell, max_local_steps)
    if fused == "pr_step":
        return _fused_pr_local_phase(graph, prog, es, running0,
                                     max_local_steps, collect_metrics)
    if fused == "min_step":
        return _fused_min_local_phase(graph, prog, es, running0,
                                      max_local_steps, collect_metrics)

    def cond(carry):
        _, running, k, _, _ = carry
        return torch.logical_and(torch.any(running), k < max_local_steps)

    def body(carry):
        es_, running, k, step, participate = carry
        mask = torch.logical_and(participate, running[:, None])
        info_l = StepInfo(superstep=step, pseudo_step=k + 1, phase="local")
        es_ = apply_phase(graph, prog, es_, mask, info_l, vdata)
        es_, _ = deliver(graph, prog, es_, edges="local", use_ell=use_ell,
                         collect_metrics=collect_metrics)
        running = partition_running(graph, prog, es_, mask, vdata)
        c = es_.counters
        es_ = dataclasses.replace(es_, counters=dataclasses.replace(
            c, pseudo_supersteps=c.pseudo_supersteps
            + running.to(c.pseudo_supersteps.dtype)))
        return es_, running, k + 1, step, participate

    k0 = torch.zeros((), dtype=torch.int64, device=running0.device)
    step0 = torch.as_tensor(superstep, device=running0.device)
    # the participation mask rides the carry (unchanged, so never copied
    # back): a fresh mask in the closure would key a new graph every call
    es, _, _, _, _ = while_loop(cond, body,
                                (es, running0, k0, step0, participate))
    return es
