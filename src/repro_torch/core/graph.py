"""Partitioned graph representation for the GraphHP hybrid execution model.

The paper's runtime keeps, per worker, adjacency lists plus per-vertex message
queues and distinguishes *local* vertices (all in-edges originate in the same
partition) from *boundary* vertices (at least one remote in-edge).  The TPU
realization keeps the same logical structure as padded, partition-major dense
arrays so that one `shard_map` device owns one block of partitions:

  * vertices   -> slots [0, Vp) per partition (padded, masked),
  * in-edges   -> flat per-partition edge arrays sorted by destination slot,
  * the cut    -> a static halo-exchange plan: each partition exports the
                  out-state of its "exporter" vertices (vertices with at least
                  one out-edge crossing the cut); remote in-edges reference
                  gathered halo slots instead of local slots.

Everything is computed once on the host in numpy (the helpers below are
copies of ``repro.core.graph``'s); only the last step differs from the
reference: the finished arrays move to the target device with
``torch.from_numpy(...).to(device)``, every leaf keeping its dtype (int32
ids, float32 values, bool masks).  The result is a frozen dataclass of
tensors that the hybrid engine iterates on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.common import ell_bin_widths, sliced_ell_pack_numpy
from repro_torch.partition import (bfs_partition, hash_partition,
                                   make_partition)

__all__ = [
    "EllSlice",
    "PartitionedGraph",
    "build_partitioned_graph",
    "hash_partition",
    "bfs_partition",
    "unpack_vertex",
]


def unpack_vertex(graph: "PartitionedGraph", values) -> np.ndarray:
    """Scatter a per-slot (P, Vp, ...) array back to global vertex-id order —
    the inverse of the builder's slot assignment (padding slots dropped).
    Trailing axes (e.g. the K-lane axis of a multi-query run) are kept, so a
    (P, Vp, L) lane state unpacks to (V, L)."""
    gid = graph.vertex_gid.cpu().numpy().ravel()
    val = values.cpu().numpy() if isinstance(values, torch.Tensor) \
        else np.asarray(values)
    val = val.reshape((-1,) + val.shape[2:])
    out = np.zeros((graph.n_vertices,) + val.shape[1:], dtype=val.dtype)
    out[gid[gid >= 0]] = val[gid >= 0]
    return out


def _pad_to(x: np.ndarray, n: int, fill) -> np.ndarray:
    out = np.full((n,) + x.shape[1:], fill, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m if n > 0 else m


def _block_layout(widths_by_p, n_blocks: int):
    """Column offsets + shared block width for a per-partition-ragged
    family packed into ``(n_blocks, W)`` rows: partition ``p`` occupies
    columns ``[offs[p], offs[p] + widths_by_p[p])`` of block row
    ``p // ppb``; ``W`` is the widest block's span sum, so storage scales
    with ``max_b sum_{p in b}`` widths instead of ``P * max_p``."""
    P = len(widths_by_p)
    ppb = P // n_blocks
    offs = np.zeros(P, dtype=np.int64)
    W = 0
    for b in range(n_blocks):
        acc = 0
        for p in range(b * ppb, (b + 1) * ppb):
            offs[p] = acc
            acc += int(widths_by_p[p])
        W = max(W, acc)
    return offs, int(W)


@dataclasses.dataclass(frozen=True)
class _EdgeLayout:
    """Host-side placement of the block-ragged edge/group families: B
    blocks of ``ppb = P // B`` consecutive partitions, each partition a
    private column span inside its block row (see ``PartitionedGraph``)."""

    n_blocks: int
    ppb: int
    ep_by_p: tuple
    gp_by_p: tuple
    eoff: np.ndarray     # (P,) edge column offset of p within its block
    goff: np.ndarray     # (P,) group column offset of p within its block
    eb: int              # shared edge block width (max per-block span sum)
    gb: int              # shared group block width

    @staticmethod
    def create(P: int, n_blocks: int, ep_by_p, gp_by_p) -> "_EdgeLayout":
        if n_blocks < 1 or P % n_blocks:
            raise ValueError(
                f"edge_blocks={n_blocks} must divide n_partitions={P}")
        eoff, eb = _block_layout(ep_by_p, n_blocks)
        goff, gb = _block_layout(gp_by_p, n_blocks)
        return _EdgeLayout(int(n_blocks), P // n_blocks, tuple(ep_by_p),
                           tuple(gp_by_p), eoff, goff, eb, gb)

    def p_rel(self, p: int) -> int:
        return p % self.ppb


class _SpanView:
    """Partition-local window into a block-ragged ``(B, W, ...)`` array:
    key ``[p, sl]`` resolves to block row ``p // ppb`` at the partition's
    column span.  Keeps the shared per-partition fill helpers addressing
    partitions uniformly whatever the block count (``B == P`` reproduces
    the former fully-padded layout, ``B == 1`` is fully ragged)."""

    def __init__(self, arr, ppb: int, offs, widths):
        self._a, self._ppb = arr, ppb
        self._offs, self._widths = offs, widths

    def _map(self, key):
        p, sl = key if isinstance(key, tuple) else (key, slice(None))
        o = int(self._offs[p])
        if isinstance(sl, slice):
            start = o + (sl.start or 0)
            stop = o + (int(self._widths[p]) if sl.stop is None else sl.stop)
            return p // self._ppb, slice(start, stop)
        return p // self._ppb, o + sl

    def __getitem__(self, key):
        return self._a[self._map(key)]

    def __setitem__(self, key, val):
        self._a[self._map(key)] = val


@dataclasses.dataclass(frozen=True)
class EllSlice:
    """One degree bin of a sliced-ELL edge layout (partition-major).

    Row binning keeps power-law graphs on the kernel fast path: bin 0 holds
    slots [0, K0) of every row (dense — row r is destination slot r), spill
    bins hold the overflow slots of high-degree rows only, indirected
    through ``rows``.  A delivery is the ⊕-combination of one `ell_spmv`
    call per bin.

    Like the dense edge family, the tiles are block-ragged: ``B`` block
    rows (``B = graph.n_blocks``) each packing ``ppb = P // B``
    consecutive partitions side by side, so the row axis scales with the
    widest block's span *sum* instead of ``P * max_p``.  ``rows`` are
    block-relative (``p_rel * Vp + slot``, sentinel ``ppb * Vp``) and
    ``grp`` ids are block-relative flat (partition group-span offset baked
    in), as in the reference.

    The ``flat_*`` views are the single-device path, precomputed at build
    time: absolute row ids ``p*Vp + slot`` (sentinel P*Vp on padding,
    dropped by the spill scatters) and source ids offset by p*stride so one
    kernel call covers every partition.  Fields marked ``static`` are plain
    Python values, the rest tensors.
    """

    rows: torch.Tensor       # (B, Nb) int32 — p_rel*Vp + slot, ppb*Vp sentinel
    idx: torch.Tensor        # (B, Nb, Kb) int32 — source slot, or Vp + halo slot
    val: torch.Tensor        # (B, Nb, Kb) float32 — edge weight
    msk: torch.Tensor        # (B, Nb, Kb) bool — slot occupancy
    # per-slot message-accounting group id (the (destination, source
    # partition) Combine() granularity of `PartitionedGraph.edge_group`,
    # block-relative flat like it), 0 on padding — lets
    # `collect_metrics=True` counters ride the tiles instead of
    # re-reducing the dense edge arrays
    grp: torch.Tensor        # (B, Nb, Kb) int32
    flat_rows: torch.Tensor  # (B*Nb,) int32 — p*Vp + slot, P*Vp sentinel
    flat_idx: torch.Tensor   # (B*Nb, Kb) int32 — idx + p*stride
    nb: int = dataclasses.field(metadata=dict(static=True))
    kb: int = dataclasses.field(metadata=dict(static=True))
    lo: int = dataclasses.field(metadata=dict(static=True))   # first edge slot
    dense: bool = dataclasses.field(metadata=dict(static=True))
    stride: int = dataclasses.field(metadata=dict(static=True))  # frontier row pitch
    # max source *global id* feeding this slice — the per-bin bound deciding
    # whether integer payloads survive the kernel's float32 carriage exactly
    payload_bound: int = dataclasses.field(metadata=dict(static=True))


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Static, partition-major graph structure (a dataclass of tensors).

    Vertex-scale families are padded per partition: P = #partitions,
    Vp = max vertices/partition, X = max exports/partition, H = max halo
    entries.

    Edge-scale families are **block-ragged** to keep memory scaling with
    ``sum_p Ep_p`` instead of ``P * max_p Ep_p`` under skewed labelings
    (fennel/multilevel cluster hubs, so per-partition in-edge counts vary
    wildly): the ``B = n_blocks`` block rows each pack ``ppb = P // B``
    consecutive partitions side by side, partition ``p`` owning the
    column span ``[eoff_p, eoff_p + ep_by_p[p])`` of block ``p // ppb``
    (``edge_span``/``group_span`` recover the spans).  ``Ep`` below is the
    shared block width (the widest block's span sum) and ``Gp`` its group
    analogue.  ``edge_part`` holds each slot's block-relative partition
    index and ``edge_group`` block-relative flat group ids, so runtime
    code never needs the per-partition offsets.  ``B == 1`` (the build
    default) is fully ragged; ``B == P`` reproduces the former shared-Ep
    padded layout; the distributed step shards block rows on dim 0 like
    every other family (``B`` a multiple of the device count).
    """

    # ---- vertices -------------------------------------------------------
    vertex_gid: torch.Tensor       # (P, Vp) int32, -1 on padding
    vertex_mask: torch.Tensor      # (P, Vp) bool
    is_boundary: torch.Tensor      # (P, Vp) bool — has a remote in-edge
    out_degree: torch.Tensor       # (P, Vp) int32 — global out-degree
    # ---- in-edges, block-ragged, sorted by destination slot per span ----
    edge_src: torch.Tensor         # (B, Ep) int32 — local slot, or Vp + halo slot
    edge_dst: torch.Tensor         # (B, Ep) int32 — destination local slot
    edge_w: torch.Tensor           # (B, Ep) float32
    edge_mask: torch.Tensor        # (B, Ep) bool
    edge_local: torch.Tensor       # (B, Ep) bool — source in same partition
    edge_src_gid: torch.Tensor     # (B, Ep) int32 — global id of source
    edge_dst_gid: torch.Tensor     # (B, Ep) int32 — global id of destination
    # block-relative partition index (p % ppb) of each slot's owning
    # partition — the runtime's key back from a block column to a
    # partition (absolute: edge_part + block_row * ppb)
    edge_part: torch.Tensor        # (B, Ep) int32
    # message-accounting groups: one group per (destination vertex, source
    # partition) pair — the granularity at which Pregel's Combine() merges
    # traffic.  Ids are block-relative flat: partition p's dense local ids
    # offset by its group-span start, so they index (B, Gp) directly.
    edge_group: torch.Tensor       # (B, Ep) int32
    group_remote: torch.Tensor     # (B, Gp) bool — group's source partition != p
    group_mask: torch.Tensor       # (B, Gp) bool
    # ---- halo-exchange plan ---------------------------------------------
    export_slot: torch.Tensor      # (P, X) int32 — local slots exported
    export_mask: torch.Tensor      # (P, X) bool
    export_fanout: torch.Tensor    # (P, X) int32 — #remote partitions consuming
    halo_ptr: torch.Tensor         # (P, H) int32 — flat index q*X + x into exports
    halo_mask: torch.Tensor        # (P, H) bool
    # ---- sliced-ELL edge layouts (destination-major degree bins) --------
    # The kernel fast paths: ``local_ell`` packs each partition's
    # same-partition in-edges (sources are local slots, frontier stride Vp),
    # ``remote_ell`` packs its remote in-edges (sources are Vp + halo slot,
    # frontier stride Vp + H — the concat(out, halo_out) table).  Empty
    # tuples when the layout was not built.
    local_ell: tuple[EllSlice, ...]
    remote_ell: tuple[EllSlice, ...]
    # ---- static metadata (not traced) -----------------------------------
    n_partitions: int = dataclasses.field(metadata=dict(static=True))
    n_vertices: int = dataclasses.field(metadata=dict(static=True))
    n_edges: int = dataclasses.field(metadata=dict(static=True))
    vp: int = dataclasses.field(metadata=dict(static=True))
    ep: int = dataclasses.field(metadata=dict(static=True))
    xp: int = dataclasses.field(metadata=dict(static=True))
    hp: int = dataclasses.field(metadata=dict(static=True))
    gp: int = dataclasses.field(metadata=dict(static=True))
    # block-ragged edge layout: block count + per-partition padded span
    # widths (tuples of ints — hashable static pytree metadata)
    n_blocks: int = dataclasses.field(metadata=dict(static=True))
    ep_by_p: tuple = dataclasses.field(metadata=dict(static=True))
    gp_by_p: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def device(self) -> torch.device:
        """The device every tensor of the graph lives on."""
        return self.vertex_gid.device

    def edge_span(self, p: int) -> tuple[int, slice]:
        """(block row, column slice) of partition ``p``'s in-edge span."""
        ppb = self.n_partitions // self.n_blocks
        off = sum(self.ep_by_p[(p // ppb) * ppb:p])
        return p // ppb, slice(off, off + self.ep_by_p[p])

    def group_span(self, p: int) -> tuple[int, slice]:
        """(block row, column slice) of partition ``p``'s group span."""
        ppb = self.n_partitions // self.n_blocks
        off = sum(self.gp_by_p[(p // ppb) * ppb:p])
        return p // ppb, slice(off, off + self.gp_by_p[p])

    @property
    def pad_waste(self) -> float:
        """What the former shared-Ep layout would have paid: the ratio of
        ``P * max_p Ep_p`` to ``sum_p Ep_p`` over the padded spans."""
        total = sum(self.ep_by_p)
        return (self.n_partitions * max(self.ep_by_p) / total
                if total else 1.0)

    @property
    def has_ell(self) -> bool:
        """Whether the local-edge ELL layout is available for kernel-backed
        delivery."""
        return len(self.local_ell) > 0

    @property
    def has_remote_ell(self) -> bool:
        return len(self.remote_ell) > 0

    @property
    def kl(self) -> int:
        """Base-bin slice width of the local layout (0 when not built)."""
        return self.local_ell[0].kb if self.local_ell else 0

    # ------------------------------------------------------------------
    @property
    def shape_summary(self) -> str:
        return (
            f"P={self.n_partitions} V={self.n_vertices} E={self.n_edges} "
            f"Vp={self.vp} B={self.n_blocks} Ep={self.ep} X={self.xp} "
            f"H={self.hp}"
        )


def build_partitioned_graph(
    edges: np.ndarray,
    n_vertices: int,
    part: np.ndarray | str,
    weights: np.ndarray | None = None,
    pad_multiple: int = 8,
    build_ell: bool = True,
    ell_pad_slices: int = 8,
    ell_base_slices: int = 128,
    n_partitions: int | None = None,
    partition_seed: int = 0,
    edge_blocks: int = 1,
    device: str | torch.device | None = None,
) -> PartitionedGraph:
    """Construct the partition-major structure from a global edge list.

    ``edges`` is (E, 2) int [src, dst]; ``part`` maps vertex -> partition id
    — either a precomputed (V,) labeling, or a partitioner name from
    ``repro_torch.partition.PARTITIONERS`` ('hash' | 'bfs' | 'fennel' |
    'multilevel'), in which case ``n_partitions`` (and optionally
    ``partition_seed``) choose how the labeling is computed.

    ``pad_multiple`` rounds every per-partition extent (vertex, edge,
    export, halo and group spans) up to a multiple, trading a bounded
    sliver of padding for aligned array extents; the structure's *values*
    are identical across choices (only masked padding moves), which the
    builder parity sweep pins.

    ``edge_blocks`` sets the block count B of the ragged edge layout:
    per-partition edge spans are packed into B block rows of P // B
    consecutive partitions each, so edge memory scales with the widest
    block's span *sum* (B=1, the default: exactly ``sum_p Ep_p``) instead
    of ``P * max_p Ep_p`` (B=P: the former shared-width padded layout).
    The distributed step shards block rows over devices, so pass a
    multiple of the device count there.

    ``device`` is where the finished tensors go: ``cuda`` unless the caller
    passes ``"cpu"``; raises when CUDA is asked for and absent.

    ``build_ell`` additionally packs each partition's local *and* remote
    in-edges into destination-major sliced-ELL layouts (the kernel fast
    paths for both delivery phases).  ``ell_pad_slices`` pads the slice axis
    (use 128 when targeting TPU lanes; 8 keeps CPU/interpret memory small).
    ``ell_base_slices`` bounds the dense base bin: rows whose in-degree
    exceeds it spill into up to two extra degree bins (see
    ``kernels.common.ell_bin_widths``), so power-law skew widens only the
    tiny spill bins instead of padding every row to the hub degree.


    Args:
        edges: (E, 2) int array of [src, dst] vertex ids in [0, V).
        n_vertices: V, the global vertex count.
        part: (V,) labeling, or a partitioner name (see above).
        weights: optional (E,) float32 edge values; defaults to ones.
        pad_multiple / build_ell / ell_pad_slices / ell_base_slices /
            edge_blocks: layout knobs, see above.
        n_partitions, partition_seed: used only when ``part`` is a name.
        device: target device, see above.

    Returns:
        A ``PartitionedGraph``: partition-major vertex tables,
        block-ragged edge spans, export/halo routing for the exchange,
        and (when ``build_ell``) local + halo-encoded remote sliced-ELL
        tiles.

    Raises:
        ValueError: ``part`` is a partitioner name but ``n_partitions``
            was not given; an unknown partitioner name; or ``edge_blocks``
            does not divide into the partition count.
        RuntimeError: ``device`` is CUDA (the default) and no GPU exists.
    """
    device = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64)
    if isinstance(part, str):
        if n_partitions is None:
            raise ValueError("partitioner-by-name needs n_partitions")
        part = make_partition(part, edges, n_vertices, n_partitions,
                              seed=partition_seed)
    part = np.asarray(part, dtype=np.int32)
    n_edges = edges.shape[0]
    if weights is None:
        weights = np.ones(n_edges, dtype=np.float32)
    weights = np.asarray(weights, dtype=np.float32)

    src, dst = edges[:, 0], edges[:, 1]
    psrc, pdst = part[src], part[dst]

    out_degree = np.bincount(src, minlength=n_vertices).astype(np.int32)

    P, verts_by_p, slot_of, Vp = _vertex_slots(part, n_vertices, pad_multiple)

    # --- boundary classification -----------------------------------------
    is_boundary_g = np.zeros(n_vertices, dtype=bool)
    cross = psrc != pdst
    is_boundary_g[dst[cross]] = True

    # --- halo: remote sources needed per partition (sorted unique) --------
    halo_by_p = [np.unique(src[cross & (pdst == p)]) for p in range(P)]

    # --- exporters: vertices with >= 1 crossing out-edge ------------------
    exp_pairs = np.unique(
        np.stack([src[cross], pdst[cross].astype(np.int64)], axis=1), axis=0
    )
    exporters_by_p, fanout_by_p, export_idx_of = _export_tables(
        exp_pairs[:, 0], part, n_vertices, P)
    X = _round_up(max((len(v) for v in exporters_by_p), default=1), pad_multiple)
    H = _round_up(max((len(h) for h in halo_by_p), default=1), pad_multiple)

    # --- per-partition in-edge arrays sorted by destination slot ----------
    per_p: list[dict[str, np.ndarray]] = []
    for p in range(P):
        sel = pdst == p
        per_p.append(_partition_edges(src[sel], dst[sel], weights[sel],
                                      psrc[sel], p, slot_of, halo_by_p[p],
                                      Vp, P))
    layout = _EdgeLayout.create(
        P, edge_blocks,
        tuple(_round_up(len(d["w"]), pad_multiple) for d in per_p),
        tuple(_round_up(len(d["group_remote"]), pad_multiple)
              for d in per_p))

    # --- assemble block-ragged + padded arrays ----------------------------
    arrs = _alloc_core(P, Vp, X, H, layout)
    staged = _core_views(arrs, layout)
    for p in range(P):
        _fill_core_partition(
            staged, p, per_p[p], verts_by_p[p], is_boundary_g, out_degree,
            slot_of, exporters_by_p[p], fanout_by_p[p],
            _halo_ptrs(halo_by_p[p], part, export_idx_of, X), layout)

    # --- sliced-ELL in-edge layouts (destination-major fast paths) --------
    local_ell: tuple[EllSlice, ...] = ()
    remote_ell: tuple[EllSlice, ...] = ()
    if build_ell:
        picks_l = [_ell_pick(d, negate=False) for d in per_p]
        picks_r = [_ell_pick(d, negate=True) for d in per_p]
        local_ell = _build_ell_slices(
            picks_l.__getitem__, P=P, Vp=Vp, stride=Vp,
            pad=pad_multiple, slice_pad=ell_pad_slices,
            base_slices=ell_base_slices, layout=layout, device=device)
        remote_ell = _build_ell_slices(
            picks_r.__getitem__, P=P, Vp=Vp, stride=Vp + H,
            pad=pad_multiple, slice_pad=ell_pad_slices,
            base_slices=ell_base_slices, layout=layout, device=device)

    return _finalize_graph(arrs, local_ell, remote_ell, n_partitions=P,
                           n_vertices=int(n_vertices), n_edges=int(n_edges),
                           vp=int(Vp), ep=int(layout.eb), xp=int(X),
                           hp=int(H), gp=int(layout.gb), layout=layout,
                           device=device)


# ---------------------------------------------------------------------------
# build helpers — copies of the reference's, so the two builders agree
# leaf by leaf
# ---------------------------------------------------------------------------

def _vertex_slots(part: np.ndarray, n_vertices: int, pad_multiple: int):
    """Partition-major vertex slot assignment: vertices of partition p in
    ascending global-id order.  Returns (P, verts_by_p, slot_of, Vp)."""
    P = int(part.max()) + 1 if part.size else 1
    order_v = np.argsort(part, kind="stable")
    verts_by_p: list[np.ndarray] = []
    slot_of = np.zeros(n_vertices, dtype=np.int64)
    counts = np.bincount(part, minlength=P)
    off = 0
    for p in range(P):
        vs = order_v[off:off + counts[p]]
        off += counts[p]
        verts_by_p.append(vs)
        slot_of[vs] = np.arange(len(vs))
    Vp = _round_up(int(counts.max()) if counts.size else 1, pad_multiple)
    return P, verts_by_p, slot_of, Vp


def _export_tables(pair_src: np.ndarray, part: np.ndarray, n_vertices: int,
                   P: int):
    """Exporter tables from the *unique* (source vertex, destination
    partition) cross pairs — ``pair_src`` is the source column; fanout is
    the number of distinct remote partitions consuming each export."""
    pair_src = np.asarray(pair_src)        # int32 or int64, preserved
    exporters_by_p: list[np.ndarray] = []
    fanout_by_p: list[np.ndarray] = []
    export_idx_of = np.full(n_vertices, -1, dtype=np.int64)
    psrc_pair = part[pair_src] if pair_src.size else pair_src
    for p in range(P):
        rows = pair_src[psrc_pair == p]
        vs, fan = (np.unique(rows, return_counts=True)
                   if rows.size else (np.zeros(0, np.int64),
                                      np.zeros(0, np.int64)))
        exporters_by_p.append(vs)
        fanout_by_p.append(fan)
        export_idx_of[vs] = np.arange(len(vs))
    return exporters_by_p, fanout_by_p, export_idx_of


def _halo_ptrs(halo_need: np.ndarray, part: np.ndarray,
               export_idx_of: np.ndarray, X: int) -> np.ndarray:
    """Flat q*X + x pointers into the exporters' buffers for one
    partition's halo table."""
    qs = part[halo_need].astype(np.int64)
    xs = export_idx_of[halo_need]
    assert (xs >= 0).all(), "halo source must be an exporter"
    return (qs * X + xs).astype(np.int32)


def _partition_edges(es: np.ndarray, ed: np.ndarray, ew: np.ndarray,
                     eps: np.ndarray, p: int, slot_of: np.ndarray,
                     halo_need: np.ndarray, Vp: int, P: int
                     ) -> dict[str, np.ndarray]:
    """One partition's in-edge arrays, sorted by destination slot.

    ``es``/``ed``/``ew``/``eps`` are the src/dst/weight/src-partition of
    every edge whose destination lives in partition ``p``, in original
    edge-list order; ``halo_need`` is the partition's sorted unique remote
    source list (the halo slot of a remote source is its position there).
    """
    d_slot = slot_of[ed]
    # encode source: local slot, or Vp + halo slot (searchsorted over the
    # sorted unique halo list; the local branch's lookup value is unused)
    s_enc = np.where(eps == p, slot_of[es],
                     Vp + np.searchsorted(halo_need, es))
    order_e = np.argsort(d_slot, kind="stable")
    es, ed, ew, eps = es[order_e], ed[order_e], ew[order_e], eps[order_e]
    d_slot, s_enc = d_slot[order_e], s_enc[order_e]
    # (dst vertex, src partition) combine groups, dense ids
    gkey = d_slot * P + eps
    _, ginv = np.unique(gkey, return_inverse=True)
    gremote = np.zeros(int(ginv.max()) + 1 if ginv.size else 1, dtype=bool)
    np.maximum.at(gremote, ginv, eps != p)
    return dict(src_enc=s_enc, dst_slot=d_slot, w=ew, local=(eps == p),
                src_gid=es, dst_gid=ed, group=ginv, group_remote=gremote)


_CORE_SPEC = {
    # name -> (per-partition shape axis, dtype, fill)
    "vertex_gid": ("Vp", np.int32, -1),
    "is_boundary": ("Vp", bool, False),
    "out_degree": ("Vp", np.int32, 0),
    "edge_src": ("Ep", np.int32, 0),
    "edge_dst": ("Ep", np.int32, 0),
    "edge_w": ("Ep", np.float32, 0.0),
    "edge_mask": ("Ep", bool, False),
    "edge_local": ("Ep", bool, False),
    "edge_src_gid": ("Ep", np.int32, -1),
    "edge_dst_gid": ("Ep", np.int32, -1),
    "edge_part": ("Ep", np.int32, 0),
    "edge_group": ("Ep", np.int32, 0),
    "group_remote": ("Gp", bool, False),
    "group_mask": ("Gp", bool, False),
    "export_slot": ("X", np.int32, 0),
    "export_mask": ("X", bool, False),
    "export_fanout": ("X", np.int32, 0),
    "halo_ptr": ("H", np.int32, 0),
    "halo_mask": ("H", bool, False),
}


def _alloc_core(P: int, Vp: int, X: int, H: int, layout: _EdgeLayout
                ) -> dict[str, np.ndarray]:
    """The core arrays: vertex-scale families padded ``(P, axis)``,
    edge/group families block-ragged ``(B, width)`` per ``layout``."""
    dims = {"Vp": (P, Vp), "X": (P, X), "H": (P, H),
            "Ep": (layout.n_blocks, layout.eb),
            "Gp": (layout.n_blocks, layout.gb)}
    return {name: np.full(dims[axis], fill, dtype=dtype)
            for name, (axis, dtype, fill) in _CORE_SPEC.items()}


def _core_views(arrs, layout: _EdgeLayout) -> dict[str, Any]:
    """Per-partition span views over the block-ragged families (vertex-
    scale arrays pass through) — what the fill helpers write into."""
    ew = np.asarray(layout.ep_by_p)
    gw = np.asarray(layout.gp_by_p)
    out: dict[str, Any] = {}
    for name, (axis, _, _) in _CORE_SPEC.items():
        if axis == "Ep":
            out[name] = _SpanView(arrs[name], layout.ppb, layout.eoff, ew)
        elif axis == "Gp":
            out[name] = _SpanView(arrs[name], layout.ppb, layout.goff, gw)
        else:
            out[name] = arrs[name]
    return out


def _fill_core_partition(arrs: dict[str, Any], p: int,
                         e: dict[str, np.ndarray], verts: np.ndarray,
                         is_boundary_g: np.ndarray, out_degree: np.ndarray,
                         slot_of: np.ndarray, exporters: np.ndarray,
                         fanout: np.ndarray, halo_ptrs: np.ndarray,
                         layout: _EdgeLayout) -> None:
    """Write one partition's span of every core array (``arrs`` carries
    span views over the block-ragged families, see ``_core_views``)."""
    nv = len(verts)
    arrs["vertex_gid"][p, :nv] = verts.astype(np.int32)
    arrs["is_boundary"][p, :nv] = is_boundary_g[verts]
    arrs["out_degree"][p, :nv] = out_degree[verts]
    ne = len(e["w"])
    arrs["edge_src"][p, :ne] = e["src_enc"].astype(np.int32)
    arrs["edge_dst"][p, :ne] = e["dst_slot"].astype(np.int32)
    arrs["edge_w"][p, :ne] = e["w"]
    arrs["edge_mask"][p, :ne] = True
    arrs["edge_local"][p, :ne] = e["local"]
    arrs["edge_src_gid"][p, :ne] = e["src_gid"].astype(np.int32)
    arrs["edge_dst_gid"][p, :ne] = e["dst_gid"].astype(np.int32)
    arrs["edge_part"][p, :] = np.int32(layout.p_rel(p))
    arrs["edge_group"][p, :ne] = (e["group"]
                                  + int(layout.goff[p])).astype(np.int32)
    ng = len(e["group_remote"])
    arrs["group_remote"][p, :ng] = e["group_remote"]
    arrs["group_mask"][p, :ng] = True
    nx = len(exporters)
    arrs["export_slot"][p, :nx] = slot_of[exporters].astype(np.int32)
    arrs["export_mask"][p, :nx] = True
    arrs["export_fanout"][p, :nx] = fanout.astype(np.int32)
    nh = len(halo_ptrs)
    arrs["halo_ptr"][p, :nh] = halo_ptrs
    arrs["halo_mask"][p, :nh] = True


def _finalize_graph(arrs: dict[str, np.ndarray],
                    local_ell: tuple[EllSlice, ...],
                    remote_ell: tuple[EllSlice, ...], *, n_partitions: int,
                    n_vertices: int, n_edges: int, vp: int, ep: int, xp: int,
                    hp: int, gp: int, layout: _EdgeLayout,
                    device: torch.device) -> PartitionedGraph:
    """Move the filled numpy arrays to ``device``, dropping each host copy
    as soon as it is converted."""
    vertex_mask = arrs["vertex_gid"] >= 0

    def take(name: str):
        return _to_device(arrs.pop(name), device)

    return PartitionedGraph(
        vertex_gid=take("vertex_gid"),
        vertex_mask=_to_device(vertex_mask, device),
        is_boundary=take("is_boundary"), out_degree=take("out_degree"),
        edge_src=take("edge_src"), edge_dst=take("edge_dst"),
        edge_w=take("edge_w"), edge_mask=take("edge_mask"),
        edge_local=take("edge_local"),
        edge_src_gid=take("edge_src_gid"), edge_dst_gid=take("edge_dst_gid"),
        edge_part=take("edge_part"),
        edge_group=take("edge_group"), group_remote=take("group_remote"),
        group_mask=take("group_mask"),
        export_slot=take("export_slot"), export_mask=take("export_mask"),
        export_fanout=take("export_fanout"),
        halo_ptr=take("halo_ptr"), halo_mask=take("halo_mask"),
        local_ell=local_ell, remote_ell=remote_ell,
        n_partitions=n_partitions, n_vertices=n_vertices, n_edges=n_edges,
        vp=vp, ep=ep, xp=xp, hp=hp, gp=gp,
        n_blocks=layout.n_blocks, ep_by_p=layout.ep_by_p,
        gp_by_p=layout.gp_by_p,
    )


#: Bytes of a read-only (memory-mapped) array copied to the device at a
#: time: the out-of-core builder's finished arrays stay on disk and only
#: this much of one is resident on the host while it moves.
_COPY_BLOCK_BYTES = 64 << 20


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    if a.flags.writeable:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    # a read-only map of a spilled file (the out-of-core builder): a fresh
    # tensor filled one block at a time, never aliasing the file
    dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
    out = torch.empty(a.shape, dtype=dtype, device=device)
    src, dst = np.ascontiguousarray(a).reshape(-1), out.view(-1)
    step = max(1, _COPY_BLOCK_BYTES // a.itemsize)
    for i in range(0, src.size, step):
        dst[i:i + step].copy_(torch.from_numpy(np.array(src[i:i + step])))
    return out


def _ell_pick(e: dict[str, np.ndarray], negate: bool) -> dict[str, np.ndarray]:
    """Select one side (local or remote) of a partition's in-edges and
    precompute the stable dst argsort + per-edge rank within its
    destination run, shared by the packer and the per-bin source-gid
    bound."""
    sel = e["local"]
    if negate:
        sel = np.logical_not(sel)
    pick = dict(src=e["src_enc"][sel], dst=e["dst_slot"][sel],
                w=e["w"][sel], gid=e["src_gid"][sel], grp=e["group"][sel])
    order = np.argsort(pick["dst"], kind="stable")
    dst_s = pick["dst"][order]
    pick["order"] = order
    pick["gid_ranked"] = pick["gid"][order]
    pick["rank"] = (np.arange(len(dst_s))
                    - np.searchsorted(dst_s, dst_s, side="left"))
    return pick


def _ell_plan(slot_degrees: list[np.ndarray], Vp: int, pad: int,
              slice_pad: int, base_slices: int):
    """Bin widths + per-bin *per-partition* row counts from the
    per-partition destination-slot in-degree histograms.  Returns
    ``(widths, nb_by_p)`` with one row-count list per bin (the dense base
    bin is Vp rows per partition, spill bins the padded count of rows
    exceeding the bin's lo); ``([], [])`` when the edge side is empty."""
    kmax = max((int(d.max()) for d in slot_degrees if len(d)), default=0)
    widths = ell_bin_widths(kmax, base_slices, slice_pad)
    nb_by_p = [[Vp] * len(slot_degrees) if lo == 0 else
               [_round_up(int((d > lo).sum()), pad) for d in slot_degrees]
               for lo, kb in widths]
    return widths, nb_by_p


def _ell_alloc(widths, bin_layouts, layout: _EdgeLayout, Vp: int
               ) -> list[dict[str, np.ndarray]]:
    B, ppb = layout.n_blocks, layout.ppb
    P = B * ppb
    arrs = []
    for (lo, kb), (_, Nb) in zip(widths, bin_layouts):
        arrs.append(dict(
            rows=np.full((B, Nb), ppb * Vp, dtype=np.int32),
            idx=np.zeros((B, Nb, kb), dtype=np.int32),
            val=np.zeros((B, Nb, kb), dtype=np.float32),
            msk=np.zeros((B, Nb, kb), dtype=bool),
            grp=np.zeros((B, Nb, kb), dtype=np.int32),
            flat_rows=np.full((B, Nb), P * Vp, dtype=np.int32),
            flat_idx=np.zeros((B, Nb, kb), dtype=np.int32)))
    return arrs


def _ell_fill_partition(arrs: list[dict[str, Any]], widths, p: int,
                        pick: dict[str, np.ndarray], P: int, Vp: int,
                        layout: _EdgeLayout, stride: int) -> list[int]:
    """Pack one partition's picked edge side and write its row span into
    every bin (``arrs`` carries per-partition span views, see
    ``_build_ell_slices``): block-relative rows (``p_rel*Vp + slot``,
    sentinel ``ppb*Vp``), block-relative flat ``grp`` ids, and the
    absolute ``flat_*`` host views.  Returns the per-bin max-source-gid
    contributions."""
    packs = sliced_ell_pack_numpy(pick["src"], pick["dst"], pick["w"], Vp,
                                  widths,
                                  order_rank=(pick["order"], pick["rank"]),
                                  extras=(pick["grp"],))
    prel = layout.p_rel(p)
    goff = int(layout.goff[p])
    bounds = []
    for b, (lo, kb) in enumerate(widths):
        rows_b, idx_b, val_b, msk_b, grp_b = packs[b]
        a = arrs[b]
        if rows_b is None:                      # dense base bin
            a["rows"][p] = np.arange(Vp, dtype=np.int32) + np.int32(prel * Vp)
        else:
            a["rows"][p, : len(rows_b)] = (rows_b.astype(np.int32)
                                           + np.int32(prel * Vp))
        n = idx_b.shape[0]
        a["idx"][p, :n], a["val"][p, :n], a["msk"][p, :n] = idx_b, val_b, msk_b
        a["grp"][p, :n] = np.where(msk_b, grp_b.astype(np.int32)
                                   + np.int32(goff), np.int32(0))
        rloc = a["rows"][p].astype(np.int64) - prel * Vp
        a["flat_rows"][p] = np.where(rloc < Vp, p * Vp + rloc,
                                     P * Vp).astype(np.int32)
        a["flat_idx"][p, :] = a["idx"][p] + np.int32(p * stride)
        bounds.append(_bin_src_bound(pick, lo, kb))
    return bounds


def _ell_finalize(arrs: list[dict[str, np.ndarray]], widths,
                  bounds: list[int], stride: int,
                  device: torch.device) -> tuple[EllSlice, ...]:
    slices = []
    for (lo, kb), a, bound in zip(widths, arrs, bounds):
        B, Nb = a["rows"].shape
        flat_idx = a.pop("flat_idx")
        take = lambda name: _to_device(a.pop(name), device)
        slices.append(EllSlice(
            rows=take("rows"), idx=take("idx"), val=take("val"),
            msk=take("msk"), grp=take("grp"),
            flat_rows=_to_device(a.pop("flat_rows").reshape(-1), device),
            flat_idx=_to_device(flat_idx.reshape(B * Nb, kb), device),
            nb=int(Nb), kb=int(kb), lo=int(lo), dense=bool(lo == 0),
            stride=int(stride), payload_bound=int(bound)))
    return tuple(slices)


def _build_ell_slices(make_pick, P: int, Vp: int, stride: int, pad: int,
                      slice_pad: int, base_slices: int, layout: _EdgeLayout,
                      device: torch.device) -> tuple[EllSlice, ...]:
    """Pack one side (local or remote) of every partition's in-edges into
    block-ragged sliced-ELL degree bins, flat views precomputed.

    ``make_pick(p)`` returns partition p's pick dict (see ``_ell_pick``);
    it is called twice per partition — once for the degree histograms that
    fix the bin widths, once for the fill.
    """
    degs = []
    for p in range(P):
        e = make_pick(p)
        degs.append(np.bincount(e["dst"], minlength=Vp))
    widths, nb_by_p = _ell_plan(degs, Vp, pad, slice_pad, base_slices)
    if not widths:
        return ()
    bin_layouts = [_block_layout(tuple(nbp), layout.n_blocks)
                   for nbp in nb_by_p]
    arrs = _ell_alloc(widths, bin_layouts, layout, Vp)
    staged = [
        {name: _SpanView(a[name], layout.ppb, offs, np.asarray(nbp))
         for name in a}
        for a, (offs, _), nbp in zip(arrs, bin_layouts, nb_by_p)]
    bounds = [-1] * len(widths)
    for p in range(P):
        contrib = _ell_fill_partition(staged, widths, p, make_pick(p), P,
                                      Vp, layout, stride)
        bounds = [max(b, c) for b, c in zip(bounds, contrib)]
    return _ell_finalize(arrs, widths, bounds, stride, device)


def _bin_src_bound(e: dict, lo: int, kb: int) -> int:
    """Max source gid among the edges landing in bin [lo, lo+kb), via the
    precomputed dst-ranking (mirrors ``sliced_ell_pack_numpy``)."""
    rank = e["rank"]
    if not len(rank):
        return -1
    sel = (rank >= lo) & (rank < lo + kb)
    return int(e["gid_ranked"][sel].max()) if sel.any() else -1
