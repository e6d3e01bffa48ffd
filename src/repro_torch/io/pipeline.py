"""The out-of-core build pipeline: edge stream -> ``PartitionedGraph``.

Four bounded-memory stages, each a pass over the chunk stream or the
shards — never over a full in-memory edge array:

  1. **degree pass** — out/in-degree histograms (vertex-scale memory),
     vertex-count inference for headerless text;
  2. **labeling** — ``hash`` needs nothing, ``fennel`` runs its scoring
     core over an *external* undirected CSR scatter-built on disk and
     mmap'd back (identical labels to the in-memory path — affinity is a
     neighbour count, so CSR neighbour order is irrelevant); ``bfs`` /
     ``multilevel`` are inherently in-memory algorithms and transparently
     fall back to loading the edges once for the labeling step only;
  3. **spill** — one pass bucketing edges by destination partition into a
     ``.ghp`` shard directory (pre-headered ``.npy`` shards appended
     through buffered handles; original relative order preserved within
     each shard);
  4. **per-partition build** — two passes over the shards (a dimension
     prescan, then the fill) driving the *same* per-partition helpers
     ``core.graph`` uses; each filled partition row streams to scratch
     ``.npy`` files, and each finished array is copied from its read-only
     mmap to the target device one array (and, within it, one bounded
     block of rows) at a time, so the padded product is never resident
     on the host twice.

Peak memory is O(chunk + vertex-scale tables + largest partition shard +
the finished graph) — the O(E) edge array, its per-partition copies, the
sort scratch *and the numpy copy of the product* that bound the in-memory
builder never materialize together.  The result is bit-identical to
``build_partitioned_graph`` for any labeling and any chunk size (pinned
by ``tests/test_io.py``).

A port of ``repro.io.pipeline``: the host stages are the reference's
(numpy), the per-partition helpers are the port's copies in
``repro_torch.core.graph``, and the product lands on ``device`` (``cuda``
unless the caller passes ``"cpu"``).  Same arrays out as the reference,
bit for bit, as tensors.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from repro_torch.core.graph import (_CORE_SPEC, PartitionedGraph, _EdgeLayout,
                              _block_layout, _ell_fill_partition,
                              _ell_finalize, _ell_pick, _ell_plan,
                              _export_tables, _fill_core_partition,
                              _finalize_graph, _halo_ptrs, _partition_edges,
                              _round_up, _vertex_slots)
from repro_torch.device import resolve_device
from repro_torch.io.format import (GraphFormatError, ShardedGraph, ShardWriter,
                             load_graph)
from repro_torch.io.readers import (DEFAULT_CHUNK_EDGES, EdgeSource,
                              TextEdgeSource, open_edge_source)

__all__ = ["degree_pass", "external_undirected_csr", "partition_source",
           "spill_to_ghp", "ingest_to_ghp", "build_from_sharded",
           "build_partitioned_graph_from_path"]


def _accum_bincount(acc: np.ndarray, ids: np.ndarray, width: int
                    ) -> np.ndarray:
    out = np.bincount(ids, minlength=max(len(acc), width))
    out[: len(acc)] += acc
    return out


def degree_pass(source: EdgeSource):
    """One pass: ``(n_vertices, n_edges, out_degree, in_degree)``.
    Vertex count is taken from the source's metadata when it has any,
    else inferred as max id + 1."""
    out_deg = np.zeros(0, dtype=np.int64)
    in_deg = np.zeros(0, dtype=np.int64)
    n_edges = 0
    for edges, _ in source.chunks():
        if len(edges):
            width = int(edges.max()) + 1
            out_deg = _accum_bincount(out_deg, edges[:, 0], width)
            in_deg = _accum_bincount(in_deg, edges[:, 1], width)
        n_edges += len(edges)
    n_vertices = (source.n_vertices if source.n_vertices is not None
                  else len(out_deg))
    if len(out_deg) > n_vertices:
        raise GraphFormatError(
            f"edge endpoint {len(out_deg) - 1} out of range for "
            f"n_vertices={n_vertices}")
    pad = n_vertices - len(out_deg)
    out_deg = np.pad(out_deg, (0, pad))
    in_deg = np.pad(in_deg, (0, pad))
    return n_vertices, n_edges, out_deg, in_deg


def external_undirected_csr(source: EdgeSource, n_vertices: int,
                            und_degree: np.ndarray, workdir: str):
    """Scatter-build the symmetrized CSR adjacency on disk and hand back
    ``(starts, adj)`` with ``adj`` an ``.npy`` memmap — the structure
    fennel's scoring core random-accesses without ever holding 2E
    neighbour entries in memory.  ``und_degree`` is out+in degree (the
    degree pass already paid for it), fixing every row's extent up
    front so one pass suffices."""
    from numpy.lib.format import open_memmap

    und_degree = np.asarray(und_degree)
    if und_degree.shape != (n_vertices,):
        raise ValueError(f"und_degree shape {und_degree.shape} != "
                         f"({n_vertices},)")
    starts = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(und_degree, out=starts[1:])
    total = int(starts[-1])
    dtype = (np.int32 if n_vertices <= np.iinfo(np.int32).max + 1
             else np.int64)
    adj_path = os.path.join(workdir, "adj.npy")
    adj = open_memmap(adj_path, mode="w+", dtype=dtype, shape=(total,))
    cursor = np.zeros(n_vertices, dtype=np.int64)
    for edges, _ in source.chunks():
        if not len(edges):
            continue
        ends = np.concatenate([edges[:, 0], edges[:, 1]])
        vals = np.concatenate([edges[:, 1], edges[:, 0]])
        order = np.argsort(ends, kind="stable")
        ends_s, vals_s = ends[order], vals[order]
        run0 = np.searchsorted(ends_s, ends_s, side="left")
        slot = cursor[ends_s] + (np.arange(len(ends_s)) - run0)
        adj[starts[ends_s] + slot] = vals_s.astype(dtype)
        cursor += np.bincount(ends_s, minlength=n_vertices)
    if not np.array_equal(cursor, und_degree):
        raise GraphFormatError("edge stream changed between the degree "
                               "pass and the CSR pass")
    adj.flush()
    return starts, np.load(adj_path, mmap_mode="r")


def partition_source(source: EdgeSource, part, n_vertices: int,
                     n_partitions: int | None, seed: int, workdir: str,
                     n_edges: int, und_degree: np.ndarray) -> np.ndarray:
    """Resolve ``part`` (a labeling array or a partitioner name) against a
    chunk stream.  'hash' touches no edges; 'fennel' streams through the
    external CSR; every other registered partitioner is an in-memory
    algorithm and falls back to loading the edge list once, for the
    labeling step only (the build itself stays out-of-core)."""
    if not isinstance(part, str):
        part = np.asarray(part, dtype=np.int32)
        if part.shape != (n_vertices,):
            raise ValueError(f"labeling shape {part.shape} != "
                             f"({n_vertices},)")
        if part.size and int(part.min()) < 0:
            raise ValueError(
                f"labeling contains negative partition id "
                f"{int(part.min())} (every vertex must be assigned)")
        return part
    if n_partitions is None:
        raise ValueError("partitioner-by-name needs n_partitions")
    if part == "hash":
        from repro_torch.partition import hash_partition
        return hash_partition(n_vertices, n_partitions, seed=seed)
    if part == "fennel":
        from repro_torch.partition import fennel_partition_csr
        starts, adj = external_undirected_csr(source, n_vertices,
                                              und_degree, workdir)
        return fennel_partition_csr(starts, adj, n_vertices, n_partitions,
                                    n_edges=n_edges, seed=seed)
    from repro_torch.partition import make_partition
    edges = np.concatenate([e for e, _ in source.chunks()], axis=0) \
        if n_edges else np.zeros((0, 2), np.int64)
    return make_partition(part, edges, n_vertices, n_partitions, seed=seed)


class _RowShim:
    """Index adapter handing the shared fill helpers a single-partition
    staging row: ``arr[p, ...]`` resolves to row 0 whatever ``p`` is, so
    ``_fill_core_partition``/``_ell_fill_partition`` run unchanged while
    only one partition's row of the padded product exists in memory."""

    def __init__(self, arr: np.ndarray):
        self._a = arr

    @staticmethod
    def _map(key):
        return (0,) + key[1:] if isinstance(key, tuple) else 0

    def __getitem__(self, key):
        return self._a[self._map(key)]

    def __setitem__(self, key, val):
        self._a[self._map(key)] = val


class _RowSpill:
    """One family of arrays streamed to scratch ``.npy`` files one
    partition at a time (fill order is partition-major, so writes append
    sequentially), then copied to the device straight off the mmap — the
    full numpy product never becomes resident alongside the tensors.

    ``spec`` maps array name -> (staging tail shape, dtype, fill value,
    file shape).  The staging row's leading tail axis is the *widest*
    per-partition span; ``commit_row(spans)`` writes only the first
    ``spans[name]`` entries of that axis (a C-contiguous prefix) and
    ``pad(n, names)`` appends ``n`` fill entries — together they stream
    block-ragged ``(B, W, ...)`` files whose rows are per-partition spans
    laid end to end, as well as plain padded ``(P, ...)`` families (where
    every committed span is the full width)."""

    def __init__(self, workdir: str, tag: str, spec: dict):
        from repro_torch.io.format import _create_npy
        self._paths = {}
        self._files = {}
        self._rows = {}
        self._fills = {}
        self._written = {}
        self._expected = {}
        for name, (tail, dtype, fill, file_shape) in spec.items():
            path = os.path.join(workdir, f"{tag}.{name}.npy")
            self._paths[name] = path
            self._files[name] = _create_npy(path, dtype, file_shape)
            self._rows[name] = np.full((1,) + tail, fill, dtype=dtype)
            self._fills[name] = fill
            self._written[name] = 0
            self._expected[name] = int(file_shape[0]) * int(file_shape[1])

    def staging(self) -> dict:
        return {name: _RowShim(a) for name, a in self._rows.items()}

    def row(self, name: str) -> np.ndarray:
        return self._rows[name][0]

    def commit_row(self, spans: dict | int | None = None) -> None:
        """Append each staging row's first-``n`` entries (``n`` from
        ``spans`` — a per-name dict, one int for every name, or None for
        the full staging width) and reset the staging to fill."""
        for name, f in self._files.items():
            if spans is None:
                n = self._rows[name].shape[1]
            elif isinstance(spans, dict):
                n = spans.get(name, self._rows[name].shape[1])
            else:
                n = spans
            f.write(self._rows[name][0][:n].tobytes())
            self._written[name] += int(n)
            self._rows[name][...] = self._fills[name]

    def pad(self, n: int, names=None) -> None:
        """Append ``n`` fill entries (a block tail) to each named file."""
        if not n:
            return
        for name in (self._rows if names is None else names):
            a = np.full((n,) + self._rows[name].shape[2:],
                        self._fills[name], dtype=self._rows[name].dtype)
            self._files[name].write(a.tobytes())
            self._written[name] += int(n)

    def close(self) -> None:
        for name, f in self._files.items():
            f.close()
            if self._written[name] != self._expected[name]:
                raise AssertionError(
                    f"{name}: spilled {self._written[name]} entries, file "
                    f"header says {self._expected[name]}")
        self._files = {}
        self._rows = {}

    def load(self, name: str) -> np.ndarray:
        """The finished (P, ...) array as a read-only mmap — the shared
        finalizers copy it to the device block by block, pages only
        transiently resident."""
        return np.load(self._paths[name], mmap_mode="r")


def spill_to_ghp(source: EdgeSource, part: np.ndarray, n_vertices: int,
                 in_degree: np.ndarray, out_path: str, dtype=np.int64,
                 positions: bool = False, partitioner: str = "explicit",
                 partition_seed=None) -> ShardedGraph:
    """External bucket sort: one pass over the chunks, each edge appended
    to its destination partition's shard."""
    part = np.asarray(part, dtype=np.int32)
    P = int(part.max()) + 1 if part.size else 1
    sizes = np.zeros(P, dtype=np.int64)
    np.add.at(sizes, part, in_degree)
    weighted = source.weighted
    if weighted is None:        # unsniffed text: peek at the first chunk
        first = next(iter(source.chunks()), (None, None))
        weighted = first[1] is not None
    wr = ShardWriter(out_path, n_vertices, part, sizes, dtype=dtype,
                     weighted=bool(weighted), positions=positions,
                     partitioner=partitioner, partition_seed=partition_seed)
    for edges, w in source.chunks():
        wr.append(np.asarray(edges, dtype=np.int64), w, part)
    return wr.close()


def build_from_sharded(sg: ShardedGraph, pad_multiple: int = 8,
                       build_ell: bool = True, ell_pad_slices: int = 8,
                       ell_base_slices: int = 128,
                       edge_blocks: int = 1,
                       workdir: str | None = None,
                       device: str | torch.device | None = None
                       ) -> PartitionedGraph:
    """Out-of-core ``build_partitioned_graph``: two passes over the
    shards (dimension prescan, then fill), one partition resident at a
    time, through the same per-partition helpers as the in-memory builder.
    Filled partition spans stream to scratch ``.npy`` files (``workdir``,
    default a TemporaryDirectory) and are copied to ``device`` (``cuda``
    unless ``"cpu"`` is passed; raises without a GPU) straight off the
    mmap, so the block-ragged product is never resident twice.
    ``edge_blocks`` selects the edge layout exactly
    as on the in-memory builder (1 = fully ragged, ``P`` = the legacy
    shared-width padding).  Same arrays out as
    ``build_partitioned_graph``, bit for bit; peak memory O(largest shard
    + vertex tables + the result)."""
    device = resolve_device(device)
    part = sg.part
    n = sg.n_vertices
    P, verts_by_p, slot_of, Vp = _vertex_slots(part, n, pad_multiple)
    if P != sg.n_partitions:
        raise GraphFormatError(
            f"{sg.path}: labels span {P} partitions, meta says "
            f"{sg.n_partitions}")

    # --- prescan: global dims + vertex-scale tables ----------------------
    out_degree = np.zeros(n, dtype=np.int64)
    is_boundary_g = np.zeros(n, dtype=bool)
    halo_by_p: list[np.ndarray] = []
    deg_local: list[np.ndarray] = []
    deg_remote: list[np.ndarray] = []
    ne_by_p: list[int] = []
    ng_by_p: list[int] = []
    for p in range(P):
        e, _, _ = sg.shard(p, mmap=False, weights=False, positions=False)
        es = np.ascontiguousarray(e[:, 0], dtype=np.int64)
        ed = np.ascontiguousarray(e[:, 1], dtype=np.int64)
        del e
        out_degree += np.bincount(es, minlength=n)
        psrc = part[es]
        local = psrc == p
        # int32 halo lists: vertex-scale but one entry per (partition,
        # remote source) pair — on a hash cut that is most of V per
        # partition, so the width matters
        halo_by_p.append(np.unique(es[~local]).astype(np.int32))
        is_boundary_g[ed[~local]] = True
        d_slot = slot_of[ed]
        if build_ell:
            deg_local.append(np.bincount(d_slot[local], minlength=Vp))
            deg_remote.append(np.bincount(d_slot[~local], minlength=Vp))
        gkey = d_slot * P + psrc
        # group count min 1: _partition_edges gives an edgeless partition
        # a single (masked-off) group row
        ng_by_p.append(len(np.unique(gkey)) if len(gkey) else 1)
        ne_by_p.append(len(es))
    layout = _EdgeLayout.create(
        P, edge_blocks,
        tuple(_round_up(ne, pad_multiple) for ne in ne_by_p),
        tuple(_round_up(ng, pad_multiple) for ng in ng_by_p))
    out_degree = out_degree.astype(np.int32)

    exporters_by_p, fanout_by_p, export_idx_of = _export_tables(
        np.concatenate(halo_by_p) if P else np.zeros(0, np.int64),
        part, n, P)
    X = _round_up(max((len(v) for v in exporters_by_p), default=1),
                  pad_multiple)
    H = _round_up(max((len(h) for h in halo_by_p), default=1), pad_multiple)

    # staging rows are one partition's widest possible span; files carry
    # the block-ragged (B, Eb/Gb) product
    stage = {"Vp": Vp, "X": X, "H": H,
             "Ep": max(layout.ep_by_p), "Gp": max(layout.gp_by_p)}
    shape = {"Vp": (P, Vp), "X": (P, X), "H": (P, H),
             "Ep": (layout.n_blocks, layout.eb),
             "Gp": (layout.n_blocks, layout.gb)}
    e_names = [nm for nm, (ax, _, _) in _CORE_SPEC.items() if ax == "Ep"]
    g_names = [nm for nm, (ax, _, _) in _CORE_SPEC.items() if ax == "Gp"]
    with tempfile.TemporaryDirectory(dir=workdir) as scratch:
        core = _RowSpill(scratch, "core",
                         {name: ((stage[axis],), dtype, fill, shape[axis])
                          for name, (axis, dtype, fill)
                          in _CORE_SPEC.items()})
        core_arrs = core.staging()
        widths_l = widths_r = ()
        if build_ell:
            widths_l, nbp_l = _ell_plan(deg_local, Vp, pad_multiple,
                                        ell_pad_slices, ell_base_slices)
            widths_r, nbp_r = _ell_plan(deg_remote, Vp, pad_multiple,
                                        ell_pad_slices, ell_base_slices)
            blay_l = [_block_layout(tuple(nbp), layout.n_blocks)
                      for nbp in nbp_l]
            blay_r = [_block_layout(tuple(nbp), layout.n_blocks)
                      for nbp in nbp_r]
            spills_l = _ell_row_spills(scratch, "lell", P, Vp, widths_l,
                                       nbp_l, blay_l, layout)
            spills_r = _ell_row_spills(scratch, "rell", P, Vp, widths_r,
                                       nbp_r, blay_r, layout)
            arrs_l = [sp.staging() for sp in spills_l]
            arrs_r = [sp.staging() for sp in spills_r]
            bounds_l = [-1] * len(widths_l)
            bounds_r = [-1] * len(widths_r)
        del deg_local, deg_remote

        # --- fill: one shard resident at a time, spans spilled as written
        for p in range(P):
            e, w, _ = sg.shard(p, mmap=False, positions=False)
            es = np.ascontiguousarray(e[:, 0], dtype=np.int64)
            ed = np.ascontiguousarray(e[:, 1], dtype=np.int64)
            del e
            ew = (np.ones(len(es), dtype=np.float32) if w is None
                  else np.asarray(w, dtype=np.float32))
            d = _partition_edges(es, ed, ew, part[es], p, slot_of,
                                 halo_by_p[p], Vp, P)
            _fill_core_partition(core_arrs, p, d, verts_by_p[p],
                                 is_boundary_g, out_degree, slot_of,
                                 exporters_by_p[p], fanout_by_p[p],
                                 _halo_ptrs(halo_by_p[p], part,
                                            export_idx_of, X), layout)
            core.commit_row(
                {**{nm: layout.ep_by_p[p] for nm in e_names},
                 **{nm: layout.gp_by_p[p] for nm in g_names}})
            if p % layout.ppb == layout.ppb - 1:     # close out the block
                used_e = int(layout.eoff[p]) + layout.ep_by_p[p]
                used_g = int(layout.goff[p]) + layout.gp_by_p[p]
                core.pad(layout.eb - used_e, e_names)
                core.pad(layout.gb - used_g, g_names)
            if widths_l:
                contrib = _ell_fill_partition(arrs_l, widths_l, p,
                                              _ell_pick(d, negate=False),
                                              P, Vp, layout, Vp)
                bounds_l = [max(b, c) for b, c in zip(bounds_l, contrib)]
                _commit_ell_rows(spills_l, blay_l, nbp_l, layout, p)
            if widths_r:
                contrib = _ell_fill_partition(arrs_r, widths_r, p,
                                              _ell_pick(d, negate=True),
                                              P, Vp, layout, Vp + H)
                bounds_r = [max(b, c) for b, c in zip(bounds_r, contrib)]
                _commit_ell_rows(spills_r, blay_r, nbp_r, layout, p)
            del d

        # vertex-scale tables are done; free them before the product is
        # copied out
        del (halo_by_p, exporters_by_p, fanout_by_p, export_idx_of,
             slot_of, verts_by_p, is_boundary_g, out_degree)
        local_ell = (_ell_take(spills_l, widths_l, bounds_l, Vp, device)
                     if widths_l else ())
        remote_ell = (_ell_take(spills_r, widths_r, bounds_r, Vp + H,
                                device) if widths_r else ())
        return _take_graph(core, local_ell, remote_ell, n_partitions=P,
                           n_vertices=int(n), n_edges=int(sg.n_edges),
                           vp=int(Vp), ep=int(layout.eb), xp=int(X),
                           hp=int(H), gp=int(layout.gb), layout=layout,
                           device=device)


def _ell_row_spills(scratch: str, tag: str, P: int, Vp: int, widths,
                    nb_by_p, bin_layouts, layout) -> list[_RowSpill]:
    """Row spills for one ELL side: the seven arrays
    ``_ell_fill_partition`` writes (``flat_idx`` included — the fill
    derives it in staging, the commit keeps only the span).  Staging
    width is the bin's widest per-partition row count; files carry the
    bin's block-ragged ``(B, Nb)`` product."""
    B, ppb = layout.n_blocks, layout.ppb
    spills = []
    for b, ((lo, kb), nbp, (_, Nb)) in enumerate(
            zip(widths, nb_by_p, bin_layouts)):
        W = max(nbp)
        spills.append(_RowSpill(scratch, f"{tag}{b}", {
            "rows": ((W,), np.int32, ppb * Vp, (B, Nb)),
            "idx": ((W, kb), np.int32, 0, (B, Nb, kb)),
            "val": ((W, kb), np.float32, 0.0, (B, Nb, kb)),
            "msk": ((W, kb), bool, False, (B, Nb, kb)),
            "grp": ((W, kb), np.int32, 0, (B, Nb, kb)),
            "flat_rows": ((W,), np.int32, P * Vp, (B, Nb)),
            "flat_idx": ((W, kb), np.int32, 0, (B, Nb, kb)),
        }))
    return spills


def _commit_ell_rows(spills: list[_RowSpill], bin_layouts, nb_by_p,
                     layout, p: int) -> None:
    for sp, (offs, Nb), nbp in zip(spills, bin_layouts, nb_by_p):
        span = int(nbp[p])
        sp.commit_row(span)
        if p % layout.ppb == layout.ppb - 1:         # close out the block
            sp.pad(Nb - (int(offs[p]) + span))


def _ell_take(spills: list[_RowSpill], widths, bounds: list[int],
              stride: int, device: torch.device) -> tuple[EllSlice, ...]:
    """The shared ``_ell_finalize`` over lazily mmap'd spill files — each
    array's pages only transiently resident while it is copied to the
    device (the precomputed ``flat_idx`` rides along so the full offset
    array is never materialized in RAM)."""
    for sp in spills:
        sp.close()
    arrs = [{name: sp.load(name)
             for name in ("rows", "idx", "val", "msk", "grp", "flat_rows",
                          "flat_idx")}
            for sp in spills]
    return _ell_finalize(arrs, widths, bounds, stride, device)


def _take_graph(core: _RowSpill, local_ell, remote_ell, *,
                n_partitions: int, n_vertices: int, n_edges: int, vp: int,
                ep: int, xp: int, hp: int, gp: int, layout,
                device: torch.device) -> PartitionedGraph:
    """The shared ``_finalize_graph`` over the lazily mmap'd spilled core
    arrays: one field list to maintain, same transient-residency
    property (``take`` pops each mmap as it converts)."""
    core.close()
    arrs = {name: core.load(name) for name in _CORE_SPEC}
    return _finalize_graph(arrs, local_ell, remote_ell,
                           n_partitions=n_partitions, n_vertices=n_vertices,
                           n_edges=n_edges, vp=vp, ep=ep, xp=xp, hp=hp,
                           gp=gp, layout=layout, device=device)


def ingest_to_ghp(path: str, part, n_partitions: int | None,
                  out_path: str, wd: str, *, n_vertices: int | None = None,
                  chunk_edges: int = DEFAULT_CHUNK_EDGES,
                  positions: bool = False, partition_seed: int = 0,
                  dtype=np.int64) -> ShardedGraph:
    """The shared ingest prefix: open/stage the edge source, degree pass,
    resolve the labeling, spill to ``out_path`` — one implementation for
    ``build_partitioned_graph_from_path`` and the convert CLI.  ``wd``
    hosts staging temporaries (the caller owns its lifetime);
    ``n_vertices`` overrides/extends the inferred or stored vertex count
    (isolated tail vertices), and raises if edges exceed it."""
    source = open_edge_source(path, chunk_edges)
    if isinstance(source, TextEdgeSource):
        from repro_torch.io.stage import stage_edges
        source = stage_edges(source, os.path.join(wd, "staged"),
                             n_vertices=n_vertices, dtype=dtype)
        source.chunk_edges = chunk_edges
    nv, ne, out_deg, in_deg = degree_pass(source)
    if n_vertices is not None:
        if nv > n_vertices:
            raise GraphFormatError(
                f"{path}: edge endpoint out of range for "
                f"n_vertices={n_vertices}")
        pad = n_vertices - nv
        out_deg, in_deg = np.pad(out_deg, (0, pad)), np.pad(in_deg,
                                                            (0, pad))
        nv = n_vertices
    labels = partition_source(source, part, nv, n_partitions,
                              partition_seed, wd, ne, out_deg + in_deg)
    return spill_to_ghp(source, labels, nv, in_deg, out_path, dtype=dtype,
                        positions=positions,
                        partitioner=(part if isinstance(part, str)
                                     else "explicit"),
                        partition_seed=partition_seed)


def build_partitioned_graph_from_path(
    path: str,
    part: str | np.ndarray | None = None,
    n_partitions: int | None = None,
    *,
    n_vertices: int | None = None,
    chunk_edges: int = DEFAULT_CHUNK_EDGES,
    workdir: str | None = None,
    ghp_out: str | None = None,
    positions: bool = False,
    partition_seed: int = 0,
    pad_multiple: int = 8,
    build_ell: bool = True,
    ell_pad_slices: int = 8,
    ell_base_slices: int = 128,
    edge_blocks: int = 1,
    dtype=np.int64,
    device: str | torch.device | None = None,
) -> PartitionedGraph:
    """Build a ``PartitionedGraph`` from a graph on disk, out-of-core.

    ``path`` is a ``.ghp`` shard directory (already partitioned — ``part``
    must be left None), a staged-edge directory, or a text edge list
    (``.gz``-aware; staged to binary once so later passes parse nothing).
    For edge inputs ``part`` is a partitioner name (default ``'fennel'``)
    or a precomputed labeling; weights come from the file (third column /
    ``weights.bin``).  ``workdir`` hosts the temporaries (default: a
    ``TemporaryDirectory``); ``ghp_out`` additionally keeps the sharded
    graph at that path (``positions=True`` to make it round-trippable).

    ``pad_multiple`` and ``edge_blocks`` mean exactly what they mean on
    ``build_partitioned_graph``: each partition's edge/group span is
    rounded up to ``pad_multiple`` entries, and the spans are packed into
    ``edge_blocks`` block rows (1 = fully ragged, ``n_partitions`` = the
    legacy shared-width layout; a ``D``-device mesh needs a multiple of
    ``D``).

    The result is bit-identical to
    ``build_partitioned_graph(edges, n, part, weights)`` on the same edge
    list, labeling, ``pad_multiple`` and ``edge_blocks``, for every chunk
    size.  ``device`` is where the graph lands: ``cuda`` unless the caller
    passes ``"cpu"``; raises without a GPU, before any file is read.
    """
    device = resolve_device(device)
    if os.path.isdir(path) and os.path.exists(os.path.join(path,
                                                           "meta.json")):
        if part is not None or n_partitions is not None:
            raise ValueError(
                f"{path} is already partitioned (.ghp) — its labeling is "
                f"fixed at convert time; to relabel, run "
                f"repro_torch.io.convert on the original edge list (or a "
                f"staged copy) with the new partitioner")
        return build_from_sharded(load_graph(path),
                                  pad_multiple=pad_multiple,
                                  build_ell=build_ell,
                                  ell_pad_slices=ell_pad_slices,
                                  ell_base_slices=ell_base_slices,
                                  edge_blocks=edge_blocks,
                                  workdir=workdir, device=device)

    if part is None:
        part = "fennel"
    with tempfile.TemporaryDirectory(dir=workdir) as wd:
        sg = ingest_to_ghp(path, part, n_partitions,
                           ghp_out or os.path.join(wd, "graph.ghp"), wd,
                           n_vertices=n_vertices, chunk_edges=chunk_edges,
                           positions=positions,
                           partition_seed=partition_seed, dtype=dtype)
        return build_from_sharded(sg, pad_multiple=pad_multiple,
                                  build_ell=build_ell,
                                  ell_pad_slices=ell_pad_slices,
                                  ell_base_slices=ell_base_slices,
                                  edge_blocks=edge_blocks,
                                  workdir=wd, device=device)
