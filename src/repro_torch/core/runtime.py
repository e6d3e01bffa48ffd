"""Shared execution primitives of the three engines (Hama / AM-Hama /
GraphHP), the PyTorch counterpart of ``repro.core.runtime``:

  ``exchange``     gather exported out-states across the partition cut
                   (the once-per-iteration communication),
  ``deliver``      generate + combine messages along all, the local or the
                   remote edges into the per-vertex pending inboxes —
                   semiring channels through the sliced-ELL ``ell_spmv``
                   kernel, the rest through the dense gather/segment path,
  ``apply_phase``  run the vertex program on a masked vertex set, consuming
                   pending inboxes (Pregel reactivation rules).

All primitives run on partition-major tensors ``(P, ...)``, so the same
code serves the single-process run (every partition on one device) and
the distributed step (:mod:`repro_torch.core.distributed`: a block of
partitions per rank, with the static sizes of the graph kept global);
only the export-table gather differs, which is injected as
``gather_table``.  Not ported: the reference's ``use_halo=False``
delivery.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.graph import EllSlice, PartitionedGraph
from repro_torch.core.vertex_program import (Channel, SegmentPlan, StepInfo,
                                             VertexProgram, combine_segments,
                                             segment_plan, segment_sum)
from repro_torch.kernels.common import (FOLD_SLICES, SEMIRINGS, maximum,
                                        minimum)
from repro_torch.kernels.ell_spmv.plan import (ell_block_plan,
                                               stream_capturing)

__all__ = ["Counters", "EngineState", "init_state", "exchange",
           "WIRE_DTYPES", "deliver",
           "apply_phase", "merge_inbox", "quiescent", "gather_per_partition",
           "ell_channels", "ell_f32_exact", "ell_slices", "slice_flat",
           "block_flat",
           "ell_combine_bins", "ell_send_accounting", "ell_group_accounting",
           "ell_plans", "build_ell_plans", "DensePlan", "dense_plan"]


def _map(fn, *trees: dict) -> dict:
    """``fn`` over the leaves of same-keyed dicts (state, out, export)."""
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


@dataclasses.dataclass(frozen=True)
class Counters:
    """The paper's metrics: I (global iterations), M (network messages), plus
    in-memory message and pseudo-superstep counts.

    Device tensors, so counting costs no host sync.  They are int64 where
    the reference's are int32: a full-size run can count more than 2**31
    in-memory messages, past which int32 would wrap."""

    iterations: torch.Tensor          # () int64
    pseudo_supersteps: torch.Tensor   # (P,) int64
    net_messages: torch.Tensor        # () int64 — combined, crossing the cut
    net_local_messages: torch.Tensor  # () int64 — combined, same-partition
    mem_messages: torch.Tensor        # () int64 — raw in-memory deliveries

    @staticmethod
    def zeros(p: int, device: torch.device) -> "Counters":
        z = lambda *s: torch.zeros(s, dtype=torch.int64, device=device)
        return Counters(z(), z(p), z(), z(), z())


@dataclasses.dataclass(frozen=True)
class EngineState:
    state: Any                 # app vertex state: dict of (P, Vp, ...)
    out: Any                   # current out-state: dict of (P, Vp, ...)
    send: torch.Tensor         # (P, Vp) bool — sent in the last apply
    active: torch.Tensor       # (P, Vp) bool
    export_out: Any            # accumulated out-state for the next exchange
    export_send: torch.Tensor  # (P, Vp) bool accumulated
    pending: Any               # {ch: (payload tuple (P,Vp,...), has (P,Vp))}
    halo_out: Any              # dict of (P, H, ...) — gathered remote out-states
    halo_send: torch.Tensor    # (P, H) bool
    counters: Counters


def gather_per_partition(leaf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """leaf (P, N, ...) gathered with idx (P, K) -> (P, K, ...)."""
    rows = torch.arange(leaf.shape[0], device=leaf.device)[:, None]
    return leaf[rows, idx.long()]


def _empty_inbox(prog: VertexProgram, p: int, vp: int, device):
    return {
        ch.name: (ch.identity_like((p, vp), device),
                  torch.zeros((p, vp), dtype=torch.bool, device=device))
        for ch in prog.channels
    }


def init_state(graph: PartitionedGraph, prog: VertexProgram,
               vdata: Any) -> EngineState:
    """Run the paper's initialization iteration (superstep 0).  ``p`` is
    the leading size of the graph's vertex families: on a rank's block
    (:func:`repro_torch.core.distributed.block_view`) the block's own
    partition count."""
    state, out, send, active = prog.init(graph.vertex_gid, graph.vertex_mask,
                                         vdata)
    send = torch.logical_and(send, graph.vertex_mask)
    active = torch.logical_and(active, graph.vertex_mask)
    p, vp, h, dev = (graph.vertex_gid.shape[0], graph.vp, graph.hp,
                     graph.device)
    halo_out = _map(lambda l: torch.zeros((p, h) + tuple(l.shape[2:]),
                                          dtype=l.dtype, device=dev), out)
    return EngineState(
        state=state, out=out, send=send, active=active,
        export_out=out, export_send=send,
        pending=_empty_inbox(prog, p, vp, dev),
        halo_out=halo_out,
        halo_send=torch.zeros((p, h), dtype=torch.bool, device=dev),
        counters=Counters.zeros(p, dev),
    )


# ---------------------------------------------------------------------------
# exchange: the once-per-global-iteration communication.
# ---------------------------------------------------------------------------

#: Wire encodings ``exchange`` accepts: the reference's ``jnp.bfloat16``,
#: ``jnp.float8_e4m3fn`` and ``jnp.float8_e5m2``.
WIRE_DTYPES = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def exchange(graph: PartitionedGraph, es: EngineState,
             gather_table: Callable[[Any], Any] | None = None,
             wire_dtype: torch.dtype | None = None) -> EngineState:
    """Gather exported out-states through the halo plan.

    ``gather_table`` maps the per-partition export tables of this block,
    a ``(exports, send flags)`` pair of ``(P_local, X, ...)`` tensors, to
    the global ``(P, X, ...)`` ones: the identity when every partition is
    on one device, one all-gather in the distributed step.

    ``wire_dtype`` (one of :data:`WIRE_DTYPES`) rounds float payloads to
    that type before the gather and back after it, as the reference's
    quantized exchange does; integer leaves travel as they are, decided
    by each leaf's own dtype (so a genuine ``uint16`` or ``uint8``
    payload is never decoded).  The byte carrier of the wire is the
    gather's business (:func:`repro_torch.core.distributed.all_gather_rows`).
    """
    exports = _map(lambda l: gather_per_partition(l, graph.export_slot),
                   es.export_out)
    exp_send = torch.logical_and(
        gather_per_partition(es.export_send, graph.export_slot),
        graph.export_mask)
    if wire_dtype is not None:
        if wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"wire_dtype {wire_dtype} is not one of "
                             f"{WIRE_DTYPES}")
        dtypes = {k: l.dtype for k, l in exports.items()}
        exports = {k: l.to(wire_dtype) if l.dtype.is_floating_point else l
                   for k, l in exports.items()}
    if gather_table is not None:
        exports, exp_send = gather_table((exports, exp_send))
    if wire_dtype is not None:
        exports = {k: l.to(dtypes[k]) if dtypes[k].is_floating_point else l
                   for k, l in exports.items()}
    halo_ptr = graph.halo_ptr.long()

    def pull(leaf):
        return leaf.reshape((-1,) + tuple(leaf.shape[2:]))[halo_ptr]

    return dataclasses.replace(
        es, halo_out=_map(pull, exports),
        halo_send=torch.logical_and(pull(exp_send), graph.halo_mask))


# ---------------------------------------------------------------------------
# deliver: emit + combine along a selected edge set into pending inboxes.
# ---------------------------------------------------------------------------

def merge_inbox(ch: Channel, a, b):
    """Pairwise monoid merge of two combined inboxes (payloads, has)."""
    (pa, ha), (pb, hb) = a, b
    has = torch.logical_or(ha, hb)
    if ch.combiner == "sum":
        out = tuple(x + y for x, y in zip(pa, pb))
    elif ch.combiner == "min":
        out = tuple(minimum(x, y) for x, y in zip(pa, pb))
    elif ch.combiner == "max":
        out = tuple(maximum(x, y) for x, y in zip(pa, pb))
    elif ch.combiner == "lexmin":
        a_lt_b = _lex_lt(pa, pb)
        out = tuple(torch.where(a_lt_b, x, y) for x, y in zip(pa, pb))
    else:
        raise ValueError(ch.combiner)
    return out, has


def _lex_lt(pa, pb):
    lt = torch.zeros(pa[0].shape, dtype=torch.bool, device=pa[0].device)
    eq = torch.ones(pa[0].shape, dtype=torch.bool, device=pa[0].device)
    for x, y in zip(pa, pb):
        lt = torch.logical_or(lt, torch.logical_and(eq, x < y))
        eq = torch.logical_and(eq, x == y)
    return torch.logical_or(lt, eq)  # ties keep a


def ell_f32_exact(ch: Channel, payload_bound: int) -> bool:
    """Integer payloads ride the kernel as float32, exact only up to 2**24:
    judged per ELL degree bin by the largest source gid feeding it."""
    (dt, _), = ch.components
    if dt.is_floating_point:
        return True
    return payload_bound <= (1 << 24)


def ell_slices(graph: PartitionedGraph, edges: str) -> tuple[EllSlice, ...]:
    return graph.local_ell if edges == "local" else graph.remote_ell


def ell_channels(graph: PartitionedGraph, prog: VertexProgram,
                 out, send, edges: str = "local") -> list[Channel]:
    """Channels eligible for kernel-backed delivery of ``edges``
    ('local' | 'remote'): the graph carries that side's sliced-ELL layout
    and the channel declares a single-component semiring whose
    ``ell_payload`` hook is implemented and whose payloads survive every
    bin's float32 carriage exactly."""
    slices = ell_slices(graph, edges)
    if not slices:
        return []
    return [ch for ch in prog.channels
            if ch.semiring is not None and len(ch.components) == 1
            and all(ell_f32_exact(ch, s.payload_bound) for s in slices)
            and prog.ell_payload(ch, out, send) is not None]


def slice_flat(s: EllSlice, graph: PartitionedGraph, p: int):
    """Flattened (rows, idx, msk) views of one ELL slice over a block of
    ``p`` partitions.  When the block is the whole graph these are the
    build-time flat views.  On a rank's block (``p < n_partitions``) they
    are the block's own, re-offset once when
    :func:`repro_torch.core.distributed.block_view` cut the block (see
    :func:`block_flat`); any other graph of ``p < n_partitions`` is
    refused, since its flat views would hold global offsets."""
    if p != graph.n_partitions and not graph.__dict__.get("_block_local"):
        raise ValueError(
            f"a block of {p} of {graph.n_partitions} partitions needs its "
            f"own flat ELL views: cut it with "
            f"repro_torch.core.distributed.block_view")
    return s.flat_rows, s.flat_idx, s.msk.reshape(-1, s.kb)


def block_flat(s: EllSlice, vp: int, p: int):
    """The (rows, idx) flat views of one block-sliced ELL slice over its
    block of ``p`` partitions, after the reference's ``slice_flat`` inside
    ``shard_map``: each tile row's partition comes from its block-relative
    row id (``row // Vp``, the sentinel clipped to the block's last
    partition, where the mask drops it), sources move by ``partition *
    stride`` and padded rows get the sentinel ``p * Vp``.  The re-offset
    changes the indices a kernel reads, never its fold order."""
    kb = s.kb
    b = s.rows.shape[0]                   # block rows on this rank
    ppb = p // b
    bvp = ppb * vp
    blk = torch.arange(b, dtype=torch.int32, device=s.rows.device)[:, None]
    prel = torch.clamp(torch.div(s.rows, vp, rounding_mode="floor"),
                       0, ppb - 1)
    pabs = blk * ppb + prel
    idx = (s.idx + (pabs * s.stride)[..., None]).reshape(-1, kb)
    rows = torch.where(s.rows < bvp, s.rows + blk * bvp, p * vp).reshape(-1)
    return rows, idx


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an int32 index tile, without the int64 copy of
    the whole tile that advanced indexing makes."""
    return table.index_select(0, idx.reshape(-1)).reshape(idx.shape)


def _scatter(semiring: str, y: torch.Tensor, rows: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """⊕-scatter spill-bin partials ``v`` onto ``y`` at ``rows``.  Padded
    rows carry the sentinel ``len(y)``: they land in one extra trash row,
    dropped again (the reference's ``mode="drop"``).  Rows are unique
    within a bin, so min/max is a gather, the semiring's ⊕ and a copy
    back, deterministic everywhere but in the trash row."""
    n = y.shape[0]
    combine, _, ident = SEMIRINGS[semiring]
    ext = torch.cat([y, y.new_full((1,) + tuple(y.shape[1:]), ident)])
    rows = rows.long().clamp(max=n)
    if semiring == "add_mul":
        ext.index_add_(0, rows, v)
    else:
        ext.index_copy_(0, rows, combine(ext.index_select(0, rows), v))
    return ext[:n]


def ell_plans(graph: PartitionedGraph, edges: str) -> tuple:
    """The block plans of ``edges``' ELL bins, one per bin
    (:class:`~repro_torch.kernels.ell_spmv.EllBlockPlan`, None for a bin
    of K <= 128), built from the bins' flat masks at the first call and
    kept on the graph, as the dense plan is: in ``graph.__dict__``, which
    ``graph_digest`` does not read and no copy of the graph carries (a
    copy or a block view builds its own).  The masks never change, so
    neither do the plans.  A miss under a stream capture raises: building
    a plan reads the host, so the engines build them first
    (:func:`build_ell_plans`)."""
    cache = graph.__dict__.setdefault("_ell_plans", {})
    plans = cache.get(edges)
    if plans is None:
        if stream_capturing():
            raise RuntimeError(
                f"the graph's {edges} ELL block plans were not built before "
                f"this stream capture: call build_ell_plans(graph) first")
        plans = tuple(ell_block_plan(s.msk.reshape(-1, s.kb))
                      if s.kb > FOLD_SLICES else None
                      for s in ell_slices(graph, edges))
        cache[edges] = plans
    return plans


def build_ell_plans(graph: PartitionedGraph) -> None:
    """Build (once) the block plans of both edge sides' bins: where a
    graph enters an engine, before any capture."""
    for edges in ("local", "remote"):
        ell_plans(graph, edges)


def ell_combine_bins(prog, ch, slices, views, x, y, spmv=None, plans=None):
    """⊕-combine each bin's ``ell_spmv`` partials onto the flat destination
    vector ``y`` — the dense base bin via the semiring combine, spill bins
    via the semiring scatter over their row lists.  The one implementation
    behind `deliver`'s kernel path and the fused phases' spill operand.
    ``spmv`` replaces the per-bin product (``ell_spmv_ref`` to run the
    plain version on the same tensors); ``plans`` are the bins' block
    plans (:func:`ell_plans`, the same bins)."""
    from repro_torch.kernels.ell_spmv import ell_spmv

    spmv = spmv or ell_spmv
    plans = plans or (None,) * len(slices)
    combine, _, _ = SEMIRINGS[ch.semiring]
    for s, (rows, idx, msk), plan in zip(slices, views, plans):
        v = prog.ell_edge_values(ch, s.val).reshape(-1, s.kb)
        yb = spmv(idx, v, msk, x, semiring=ch.semiring, plan=plan)
        y = combine(y, yb) if s.dense else _scatter(ch.semiring, y, rows, yb)
    return y


def ell_send_accounting(graph: PartitionedGraph, slices, views, send_flat,
                        p: int):
    """Per-destination has-flags (one combined local group per messaged
    dst) and the raw in-memory message count (every valid sender edge
    slot), read off the ELL layout — exact parity with the reference."""
    n = p * graph.vp
    has = torch.zeros((n + 1,), dtype=torch.bool, device=send_flat.device)
    mem = torch.zeros((), dtype=torch.int64, device=send_flat.device)
    for s, (rows, idx, msk) in zip(slices, views):
        # one reduction per tile gives both the row flags and the count
        sent_per_row = torch.logical_and(_gather(send_flat, idx), msk).sum(-1)
        row_has = sent_per_row > 0
        if s.dense:
            has[:n] |= row_has
        else:
            r = rows.long().clamp(max=n)
            has[r] = torch.logical_or(has[r], row_has)
        mem += sent_per_row.sum()
    return has[:n].reshape(p, graph.vp), mem


#: Trash slots that the group accounting spreads non-sending slots over.
_TRASH_SPREAD = 4096


def ell_group_accounting(graph: PartitionedGraph, slices, views, send_flat,
                         p: int) -> torch.Tensor:
    """Combined-message count at the paper's Combine() granularity — one per
    (destination vertex, source partition) group with a sending edge —
    read off the ELL tiles' per-slot ``grp`` ids with a count-then-threshold
    reduction.  Slots that send nothing — on hub bins nearly all of them
    are padding, whose group id is 0 — add into trash counters spread by
    slot position instead, so the atomic adds do not all contend for one
    address; integer adds keep the count deterministic."""
    dev = send_flat.device
    if not slices:
        return torch.zeros((), dtype=torch.int64, device=dev)
    b = slices[0].grp.shape[0]
    n_groups = b * graph.gp
    offs = (torch.arange(b, dtype=torch.int32, device=dev)
            * graph.gp)[:, None, None]
    sent = torch.zeros((n_groups + _TRASH_SPREAD,), dtype=torch.int32,
                       device=dev)
    for s, (_, idx, msk) in zip(slices, views):
        tile = torch.logical_and(_gather(send_flat, idx), msk).reshape(-1)
        trash = torch.arange(tile.numel(), dtype=torch.int32, device=dev)
        trash.bitwise_and_(_TRASH_SPREAD - 1).add_(n_groups)
        target = torch.where(tile, (s.grp + offs).reshape(-1), trash)
        sent.index_add_(0, target, tile.to(torch.int32))
    return (sent[:n_groups] > 0).sum()


def _ell_deliver(graph, prog, chs, es, pending, delivered, collect_metrics,
                 edges: str):
    """Kernel-backed delivery for semiring channels along ``edges``.

    Local deliveries read the (P*Vp,) out-state frontier; remote deliveries
    the concat(out, halo_out) frontier of stride Vp + H, with sources
    halo-encoded as Vp + halo_slot.  Each degree bin runs one `ell_spmv`
    over its flattened tiles; spill-bin partials are ⊕-scattered onto the
    dense base bin's output."""
    p, vp = es.send.shape
    slices = ell_slices(graph, edges)
    if edges == "local":
        out_tab, send_tab = es.out, es.send
    else:
        cat = lambda a, b: torch.cat([a, b], dim=1)
        out_tab = _map(cat, es.out, es.halo_out)
        send_tab = cat(es.send, es.halo_send)
    send_flat = send_tab.reshape(-1)

    # has-message flags per destination, shared by every kernel channel
    views = [slice_flat(s, graph, p) for s in slices]
    plans = ell_plans(graph, edges)
    has_fresh, mem_edges = ell_send_accounting(graph, slices, views,
                                               send_flat, p)
    delivered = torch.logical_or(delivered, torch.any(has_fresh, dim=1))

    dev = send_flat.device
    net = torch.zeros((), dtype=torch.int64, device=dev)
    net_local = torch.zeros((), dtype=torch.int64, device=dev)
    mem = torch.zeros((), dtype=torch.int64, device=dev)
    for ch in chs:
        _, _, ident = SEMIRINGS[ch.semiring]
        x = prog.ell_payload(ch, out_tab, send_tab)
        # lane channels keep their trailing (L,) axis through the SpMM
        x = x.reshape((-1,) + tuple(x.shape[2:])).to(torch.float32)
        y = torch.full((p * vp,) + tuple(x.shape[1:]), ident,
                       dtype=torch.float32, device=dev)
        y = ell_combine_bins(prog, ch, slices, views, x, y, plans=plans)
        y = y.reshape((p, vp) + tuple(y.shape[1:]))
        dt, ident_ch = ch.components[0]
        has_b = has_fresh.reshape(
            has_fresh.shape + (1,) * (y.dim() - has_fresh.dim()))
        payload = torch.where(has_b, y.to(dt), ident_ch)
        pending[ch.name] = merge_inbox(ch, pending[ch.name],
                                       ((payload,), has_fresh))
        if collect_metrics and edges == "local":
            # one combine group per messaged destination, every valid edge
            # an in-memory message
            net_local += has_fresh.sum()
            mem += mem_edges

    if collect_metrics and edges == "remote" and chs:
        # per (source-partition, destination) combine group, read off the
        # tiles' group ids; one tile pass covers every kernel channel
        net += len(chs) * ell_group_accounting(graph, slices, views,
                                               send_flat, p)

    return pending, delivered, net, net_local, mem


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """Flat per-edge indices of the block-ragged edge family, computed once
    per graph: the edge family is B block rows of ``P // B`` consecutive
    partitions side by side, and ``edge_part`` recovers each slot's
    absolute partition, from which the source-table and destination
    indices follow."""

    src: torch.Tensor        # (E,) int64 into the (P * (Vp + H),) table
    dst: torch.Tensor        # (E,) int64 into the (P * Vp,) inboxes
    dst_plan: SegmentPlan    # stable sort of ``dst``: the sum fold order
    grp_plan: SegmentPlan    # stable sort of the flat (B * Gp,) group ids


def dense_plan(graph: PartitionedGraph) -> DensePlan:
    """The graph's :class:`DensePlan`, built at its first dense delivery
    and kept on the graph.  ``p`` is the leading size of the vertex
    families, so the plan kept on a rank's block view is that block's."""
    plan = graph.__dict__.get("_dense_plan")
    if plan is None:
        p, vp = graph.vertex_gid.shape[0], graph.vp
        bsz = graph.edge_src.shape[0]
        dev = graph.device
        rows = torch.arange(bsz, dtype=torch.int64, device=dev)[:, None]
        epart = graph.edge_part.long() + rows * (p // bsz)
        dst = (epart * vp + graph.edge_dst.long()).reshape(-1)
        grp = (graph.edge_group.long() + rows * graph.gp).reshape(-1)
        plan = DensePlan(
            src=(epart * (vp + graph.hp) + graph.edge_src.long()).reshape(-1),
            dst=dst, dst_plan=segment_plan(dst, p * vp),
            grp_plan=segment_plan(grp, bsz * graph.gp))
        graph.__dict__["_dense_plan"] = plan
    return plan


def _dense_deliver(graph, prog, chs, es, pending, delivered, collect_metrics,
                   edges: str):
    """Dense gather/segment delivery for ``chs`` along ``edges``: every
    edge slot gathers its source's out-state and send flag from the
    concat(out, halo_out) table, the channel's ``emit`` makes the
    messages, and :func:`combine_segments` folds them per destination.
    Counters as the reference's: one network (remote) or local message
    per (source-partition, destination) combine group with a valid edge,
    every valid local edge an in-memory message."""
    p, vp = es.send.shape
    plan = dense_plan(graph)
    eshape = tuple(graph.edge_src.shape)
    cat = lambda a, b: torch.cat([a, b], dim=1)

    def gather(leaf):
        flat = leaf.reshape((-1,) + tuple(leaf.shape[2:]))
        return flat.index_select(0, plan.src).reshape(
            eshape + tuple(leaf.shape[2:]))

    out_src = _map(lambda a, b: gather(cat(a, b)), es.out, es.halo_out)
    send_e = gather(cat(es.send, es.halo_send))
    if edges == "all":
        sel = graph.edge_mask
    elif edges == "local":
        sel = torch.logical_and(graph.edge_mask, graph.edge_local)
    elif edges == "remote":
        sel = torch.logical_and(graph.edge_mask,
                                torch.logical_not(graph.edge_local))
    else:
        raise ValueError(edges)
    base_valid = torch.logical_and(sel, send_e)

    dev = es.send.device
    net = torch.zeros((), dtype=torch.int64, device=dev)
    net_local = torch.zeros((), dtype=torch.int64, device=dev)
    mem = torch.zeros((), dtype=torch.int64, device=dev)
    for ch in chs:
        payloads, valid = prog.emit(ch, out_src, graph.edge_w,
                                    graph.edge_src_gid, graph.edge_dst_gid)
        valid = torch.logical_and(valid, base_valid)
        valid_flat = valid.reshape(-1)
        comb, has = combine_segments(
            ch, tuple(x.reshape((-1,) + tuple(x.shape[2:]))
                      for x in payloads),
            valid_flat, plan.dst, p * vp, plan=plan.dst_plan)
        has = has.reshape(p, vp)
        fresh = (tuple(x.reshape((p, vp) + tuple(x.shape[1:]))
                       for x in comb), has)
        pending[ch.name] = merge_inbox(ch, pending[ch.name], fresh)
        # a destination's partition is its edge's partition
        delivered = torch.logical_or(delivered, torch.any(has, dim=1))
        if not collect_metrics:
            continue
        grp_sent = segment_sum(valid_flat.to(torch.int32), plan.grp_plan) > 0
        grp_sent = torch.logical_and(grp_sent.reshape(graph.group_mask.shape),
                                     graph.group_mask)
        net += torch.logical_and(grp_sent, graph.group_remote).sum()
        net_local += torch.logical_and(
            grp_sent, torch.logical_not(graph.group_remote)).sum()
        mem += torch.logical_and(valid, graph.edge_local).sum()
    return pending, delivered, net, net_local, mem


def deliver(
    graph: PartitionedGraph,
    prog: VertexProgram,
    es: EngineState,
    edges: str,                  # 'all' | 'local' | 'remote'
    use_ell: bool = True,
    collect_metrics: bool = True,
) -> tuple[EngineState, torch.Tensor]:
    """Messages from the last apply travel along ``edges`` into pending.

    Returns (state', delivered_any (P,) bool) and updates the message
    counters: remote deliveries count as combined network messages (one
    per (source-partition, destination-vertex) group), local ones as
    in-memory messages.  ``collect_metrics=False`` skips the accounting.

    ``use_ell`` sends the channels of a 'local' or 'remote' delivery that
    can ride the ELL layouts (:func:`ell_channels`) through the kernels;
    the other channels — and every channel of an 'all' delivery — take
    the dense gather/segment path, in the same call.
    """
    kernel_chs = ell_channels(graph, prog, es.out, es.send, edges) \
        if use_ell and edges in ("local", "remote") else []
    dense_chs = [ch for ch in prog.channels if ch not in kernel_chs]

    dev = es.send.device
    pending = dict(es.pending)
    delivered = torch.zeros((es.send.shape[0],), dtype=torch.bool, device=dev)
    net = torch.zeros((), dtype=torch.int64, device=dev)
    net_local = torch.zeros((), dtype=torch.int64, device=dev)
    mem = torch.zeros((), dtype=torch.int64, device=dev)
    for path, chs in ((_ell_deliver, kernel_chs),
                      (_dense_deliver, dense_chs)):
        if chs:
            pending, delivered, nt, nl, mm = path(
                graph, prog, chs, es, pending, delivered, collect_metrics,
                edges)
            net, net_local, mem = net + nt, net_local + nl, mem + mm

    c = es.counters
    counters = dataclasses.replace(
        c, net_messages=c.net_messages + net,
        net_local_messages=c.net_local_messages + net_local,
        mem_messages=c.mem_messages + mem)
    return dataclasses.replace(es, pending=pending, counters=counters), \
        delivered


# ---------------------------------------------------------------------------
# apply: run Compute() on a masked vertex set, consuming pending inboxes.
# ---------------------------------------------------------------------------

def _has_any_pending(prog: VertexProgram, pending) -> torch.Tensor:
    flags = [pending[ch.name][1] for ch in prog.channels]
    out = flags[0]
    for f in flags[1:]:
        out = torch.logical_or(out, f)
    return out


def apply_phase(
    graph: PartitionedGraph,
    prog: VertexProgram,
    es: EngineState,
    phase_mask: torch.Tensor,    # (P, Vp) bool — vertices allowed in this phase
    info: StepInfo,
    vdata: Any,
) -> EngineState:
    """Compute() on ``phase_mask ∧ (active ∨ has-message)`` vertices."""
    has_msg = _has_any_pending(prog, es.pending)
    compute = torch.logical_and(graph.vertex_mask, phase_mask)
    compute = torch.logical_and(compute, torch.logical_or(es.active, has_msg))

    new_state, new_out, new_send, new_active = prog.apply(
        es.state, es.pending, graph.vertex_gid, graph.vertex_mask, vdata, info)

    def sel(new, old):
        m = compute.reshape(compute.shape + (1,) * (new.dim() - compute.dim()))
        return torch.where(m, new, old)

    state = _map(sel, new_state, es.state)
    out = _map(sel, new_out, es.out)
    send = torch.logical_and(torch.logical_and(new_send, compute),
                             graph.vertex_mask)
    active = torch.where(compute,
                         torch.logical_and(new_active, graph.vertex_mask),
                         es.active)

    # consumed inboxes reset to the channel identity
    keep = torch.logical_not(compute)
    pending = {}
    for ch in prog.channels:
        payloads, has = es.pending[ch.name]
        ident = ch.identity_like(tuple(has.shape), has.device)
        payloads = tuple(
            torch.where(keep.reshape(keep.shape + (1,) * (pl.dim() - keep.dim())),
                        pl, i)
            for pl, i in zip(payloads, ident))
        pending[ch.name] = (payloads, torch.logical_and(has, keep))

    # export accumulation (SourceCombine) — only freshly computed sends count
    export_out, export_send = prog.accumulate_export(
        es.export_out, es.export_send, out, send)

    return dataclasses.replace(
        es, state=state, out=out, send=send, active=active, pending=pending,
        export_out=export_out, export_send=export_send)


def quiescent(prog: VertexProgram, es: EngineState) -> torch.Tensor:
    """Termination: no active vertex, nothing pending, nothing left to
    export.  A () bool tensor on the device; reading it is a host sync."""
    return torch.logical_not(
        torch.any(es.active)
        | torch.any(_has_any_pending(prog, es.pending))
        | torch.any(es.export_send))
