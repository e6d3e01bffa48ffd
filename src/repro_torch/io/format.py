"""The ``.ghp`` sharded on-disk graph format.

A ``.ghp`` directory is a partitioned graph at rest: edges already bucketed
by *destination* partition (the axis the builder consumes), with the
labeling that produced the buckets.  Layout::

    graph.ghp/
      meta.json                  format tag, version, counts, dtype,
                                 partition provenance, per-shard ranges
      part.npy                   (V,) int32    vertex -> partition labels
      shards/part00000.edges.npy (E_p, 2) dt   in-edges of partition p,
                                               original edge-list order
      shards/part00000.w.npy     (E_p,) f32    [weighted graphs only]
      shards/part00000.pos.npy   (E_p,) int64  [optional] original edge
                                               index of each shard row

Everything is a plain ``.npy`` — ``np.load(..., mmap_mode='r')`` works on
any shard, so a build touches one partition's pages at a time.  Because a
shard keeps its edges in original edge-list order, feeding shard ``p`` to
the builder's per-partition helpers reproduces the in-memory
``build_partitioned_graph`` bit-for-bit; ``pos`` (when saved) additionally
makes the *edge list itself* reconstructible, which is what the save/load
round-trip test pins.

``meta.json`` is the integrity anchor: :func:`load_graph` validates format
tag, version, shard presence and shapes against it and raises
:class:`GraphFormatError` on any mismatch (truncated JSON, missing shard,
wrong length) rather than letting a corrupt directory produce a wrong
graph.

A copy of ``repro.io.format`` (numpy only), byte for byte the same format:
a ``.ghp`` directory written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

__all__ = ["GraphFormatError", "ShardedGraph", "save_graph", "load_graph",
           "read_meta", "write_meta", "shard_prefix", "check_id_range",
           "GHP_VERSION"]

# version 2: shards build into the block-ragged edge layout (per-partition
# Ep_p spans) — shard bytes are unchanged, but graphs built from v1-era
# directories would not be bit-comparable to freshly converted ones, so
# loads refuse the old tag instead of failing deep in the builder
GHP_VERSION = 2


class GraphFormatError(Exception):
    """A .ghp / staged-edge directory failed validation."""


def check_id_range(ids: np.ndarray, dtype: np.dtype, where: str) -> None:
    """Refuse to narrow vertex ids that the target dtype cannot hold —
    a wrapped id is either an opaque bincount crash three stages later or,
    worse, a silently wrong graph."""
    if not len(ids):
        return
    lo, hi = int(ids.min()), int(ids.max())
    if lo < 0:
        # a negative id "fits" any signed dtype but wraps every part[]/
        # slot_of[] lookup downstream into a structurally-valid wrong graph
        raise GraphFormatError(f"{where}: negative vertex id {lo}")
    if hi > np.iinfo(dtype).max:
        raise GraphFormatError(
            f"{where}: vertex id range [{lo}, {hi}] does not fit "
            f"{np.dtype(dtype).name}")


def shard_prefix(p: int) -> str:
    return os.path.join("shards", f"part{p:05d}")


def write_meta(path: str, meta: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, path)


def read_meta(path: str, expect: str) -> dict:
    """Load + validate a meta json (``expect`` is the format tag:
    'ghp' or 'edges')."""
    if not os.path.exists(path):
        raise GraphFormatError(f"{path}: missing")
    try:
        with open(path) as f:
            meta = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise GraphFormatError(f"{path}: corrupt or truncated json "
                               f"({e})") from None
    if not isinstance(meta, dict) or meta.get("format") != expect:
        raise GraphFormatError(
            f"{path}: format tag {meta.get('format') if isinstance(meta, dict) else meta!r} "
            f"!= {expect!r}")
    version = meta.get("version")
    if version != GHP_VERSION:
        raise GraphFormatError(f"{path}: unsupported version {version!r} "
                               f"(have {GHP_VERSION})")
    required = {"ghp": ("n_vertices", "n_edges", "dtype", "weighted",
                        "n_partitions", "shards"),
                "edges": ("n_vertices", "n_edges", "dtype", "weighted")}
    missing = [k for k in required[expect] if k not in meta]
    if missing:
        raise GraphFormatError(f"{path}: missing keys {missing}")
    return meta


@dataclasses.dataclass
class ShardedGraph:
    """Handle over a validated ``.ghp`` directory: metadata + the labeling
    in memory, per-partition edge shards loaded (mmap'd) on demand."""

    path: str
    meta: dict
    part: np.ndarray                  # (V,) int32

    @property
    def n_vertices(self) -> int:
        return int(self.meta["n_vertices"])

    @property
    def n_edges(self) -> int:
        return int(self.meta["n_edges"])

    @property
    def n_partitions(self) -> int:
        return int(self.meta["n_partitions"])

    @property
    def weighted(self) -> bool:
        return bool(self.meta["weighted"])

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(self.meta["dtype"])

    def _load(self, rel: str, shape: tuple, dtype, mmap: bool):
        full = os.path.join(self.path, rel)
        if not os.path.exists(full):
            raise GraphFormatError(f"{full}: shard file missing")
        arr = np.load(full, mmap_mode="r" if mmap else None)
        if arr.shape != shape or arr.dtype != np.dtype(dtype):
            raise GraphFormatError(
                f"{full}: have {arr.dtype}{arr.shape}, meta says "
                f"{np.dtype(dtype)}{shape}")
        return arr

    def shard(self, p: int, mmap: bool = True, weights: bool = True,
              positions: bool = True):
        """Partition p's in-edges as ``(edges (E_p, 2), weights | None,
        positions | None)``, in original edge-list order.  ``weights`` /
        ``positions`` skip those columns entirely (None) — callers that
        only need edges shouldn't page in the rest."""
        rec = self.meta["shards"][p]
        ne = int(rec["n_edges"])
        prefix = rec["prefix"]
        edges = self._load(prefix + ".edges.npy", (ne, 2), self.dtype, mmap)
        w = (self._load(prefix + ".w.npy", (ne,), np.float32, mmap)
             if self.weighted and weights else None)
        pos = (self._load(prefix + ".pos.npy", (ne,), np.int64, mmap)
               if self.meta.get("has_positions") and positions else None)
        return edges, w, pos

    def edges(self):
        """Reassemble the full edge list (and weights): in original order
        when positions were saved, else shard-major.  O(E) memory — a
        convenience for tests and small graphs, not the build path."""
        out = np.empty((self.n_edges, 2), dtype=self.dtype)
        w_out = (np.empty(self.n_edges, dtype=np.float32)
                 if self.weighted else None)
        cur = 0
        for p in range(self.n_partitions):
            e, w, pos = self.shard(p)
            if pos is not None:
                out[pos] = e
                if w_out is not None:
                    w_out[pos] = w
            else:
                out[cur:cur + len(e)] = e
                if w_out is not None:
                    w_out[cur:cur + len(e)] = w
            cur += len(e)
        return out, w_out


def load_graph(path: str) -> ShardedGraph:
    """Open + validate a ``.ghp`` directory.

    Validation is structural and cheap — shard payloads are *not* read:
    ``meta.json`` must parse with the expected magic/version, ``part.npy``
    must be an int32 labeling of exactly ``n_vertices`` entries, the shard
    records must match ``n_partitions``, and the per-shard edge counts
    must sum to ``n_edges``.

    Args:
        path: the ``.ghp`` directory (as written by ``ShardWriter`` /
            ``repro_torch.io.convert``).

    Returns:
        A ``ShardedGraph`` handle: parsed ``meta``, the in-memory
        partition labeling, and the path — shard arrays are loaded lazily
        by consumers (mmap-friendly ``.npy``).

    Raises:
        GraphFormatError: missing or malformed ``meta.json`` /
            ``part.npy``, or shard records inconsistent with the metadata.
    """
    meta = read_meta(os.path.join(path, "meta.json"), expect="ghp")
    n = int(meta["n_vertices"])
    part_path = os.path.join(path, "part.npy")
    if not os.path.exists(part_path):
        raise GraphFormatError(f"{part_path}: missing")
    part = np.load(part_path)
    if part.shape != (n,) or part.dtype != np.int32:
        raise GraphFormatError(f"{part_path}: have {part.dtype}{part.shape},"
                               f" meta says int32({n},)")
    shards = meta["shards"]
    if len(shards) != int(meta["n_partitions"]):
        raise GraphFormatError(
            f"{path}: {len(shards)} shard records for "
            f"{meta['n_partitions']} partitions")
    total = sum(int(s["n_edges"]) for s in shards)
    if total != int(meta["n_edges"]):
        raise GraphFormatError(f"{path}: shard ranges sum to {total}, meta "
                               f"says n_edges={meta['n_edges']}")
    return ShardedGraph(path=path, meta=meta, part=np.asarray(part))


def _create_npy(path: str, dtype, shape: tuple):
    """Open a ``.npy`` for sequential append: header written up front (the
    shard sizes are known from the degree pass), raw data streamed after.
    Buffered file writes instead of ``open_memmap`` keep the spilled bytes
    out of the writer's resident set — dirty mapped pages of every shard
    would otherwise pile onto peak RSS, which is the resource this whole
    pipeline exists to bound."""
    from numpy.lib import format as npy_format
    f = open(path, "wb")
    npy_format.write_array_header_1_0(
        f, {"descr": npy_format.dtype_to_descr(np.dtype(dtype)),
            "fortran_order": False, "shape": tuple(shape)})
    return f


class ShardWriter:
    """Incremental ``.ghp`` writer: shard sizes are known up front (the
    degree pass supplies them), so every shard is a pre-headered ``.npy``
    appended through buffered file handles — bounded memory however large
    the graph.  Handles are opened per append, not held: 3 files per
    shard times a large ``--n-partitions`` would otherwise blow the
    file-descriptor limit."""

    def __init__(self, path: str, n_vertices: int, part: np.ndarray,
                 shard_sizes: np.ndarray, dtype=np.int64,
                 weighted: bool = False, positions: bool = True,
                 partitioner: str = "explicit", partition_seed=None):
        self.path = path
        self.P = len(shard_sizes)
        self.dtype = np.dtype(dtype)
        self.weighted = weighted
        self.positions = positions
        self.sizes = np.asarray(shard_sizes, dtype=np.int64)
        os.makedirs(os.path.join(path, "shards"), exist_ok=True)
        np.save(os.path.join(path, "part.npy"),
                np.asarray(part, dtype=np.int32))
        self._cur = np.zeros(self.P, dtype=np.int64)
        self._gpos = 0
        for p in range(self.P):
            prefix = os.path.join(path, shard_prefix(p))
            ne = int(self.sizes[p])
            _create_npy(prefix + ".edges.npy", self.dtype, (ne, 2)).close()
            if weighted:
                _create_npy(prefix + ".w.npy", np.float32, (ne,)).close()
            if positions:
                _create_npy(prefix + ".pos.npy", np.int64, (ne,)).close()
        self.meta = {
            "format": "ghp", "version": GHP_VERSION,
            "n_vertices": int(n_vertices), "n_edges": int(self.sizes.sum()),
            "dtype": self.dtype.name, "weighted": bool(weighted),
            "has_positions": bool(positions),
            "n_partitions": self.P,
            "partitioner": partitioner,
            "partition_seed": partition_seed,
            "shards": [{"partition": p, "n_edges": int(self.sizes[p]),
                        "prefix": shard_prefix(p).replace(os.sep, "/")}
                       for p in range(self.P)],
        }

    def _append_to(self, p: int, suffix: str, data: bytes) -> None:
        with open(os.path.join(self.path, shard_prefix(p)) + suffix,
                  "ab") as f:
            f.write(data)

    def append(self, edges: np.ndarray, weights: np.ndarray | None,
               part: np.ndarray,
               positions: np.ndarray | None = None) -> None:
        """Spill one chunk: bucket rows by destination partition, keeping
        original relative order (stable sort by bucket).  ``positions``
        overrides the derived original-edge-index column — for writers
        (like ``repro_torch.io.resize``) whose stream is *not* the original
        edge list order but who know each row's original index."""
        pd = part[edges[:, 1]]
        order = np.argsort(pd, kind="stable")
        pd_s = pd[order]
        e_s = edges[order]
        w_s = None if weights is None else weights[order]
        if positions is not None:
            if not self.positions:
                raise GraphFormatError(
                    f"{self.path}: explicit positions passed to a writer "
                    f"created with positions=False")
            pos_s = np.asarray(positions, dtype=np.int64)[order]
        else:
            pos_s = (np.arange(self._gpos, self._gpos + len(edges),
                               dtype=np.int64)[order]
                     if self.positions else None)
        check_id_range(e_s, self.dtype, self.path)
        bounds = np.searchsorted(pd_s, np.arange(self.P + 1))
        for p in np.unique(pd_s):
            a, b = bounds[p], bounds[p + 1]
            self._append_to(p, ".edges.npy", np.ascontiguousarray(
                e_s[a:b], dtype=self.dtype).tobytes())
            if w_s is not None:
                self._append_to(p, ".w.npy", np.ascontiguousarray(
                    w_s[a:b], np.float32).tobytes())
            if pos_s is not None:
                self._append_to(p, ".pos.npy", pos_s[a:b].tobytes())
            self._cur[p] += b - a
        self._gpos += len(edges)

    def close(self) -> ShardedGraph:
        if not np.array_equal(self._cur, self.sizes):
            raise GraphFormatError(
                f"{self.path}: spill wrote {self._cur.tolist()} edges per "
                f"shard, expected {self.sizes.tolist()} — degree pass and "
                f"edge stream disagree")
        write_meta(os.path.join(self.path, "meta.json"), self.meta)
        return load_graph(self.path)


def save_graph(path: str, edges: np.ndarray, n_vertices: int,
               part: np.ndarray, weights: np.ndarray | None = None,
               dtype=None, positions: bool = True,
               partitioner: str = "explicit",
               partition_seed=None) -> ShardedGraph:
    """Shard an in-memory edge list to a ``.ghp`` directory (the one-shot
    counterpart of the streaming spill; same bytes on disk)."""
    edges = np.asarray(edges)
    if dtype is None:
        dtype = edges.dtype if edges.dtype in (np.int32, np.int64) \
            else np.int64
    part = np.asarray(part, dtype=np.int32)
    P = int(part.max()) + 1 if part.size else 1
    sizes = np.bincount(part[edges[:, 1]], minlength=P) if len(edges) \
        else np.zeros(P, dtype=np.int64)
    wr = ShardWriter(path, n_vertices, part, sizes, dtype=dtype,
                     weighted=weights is not None, positions=positions,
                     partitioner=partitioner, partition_seed=partition_seed)
    wr.append(np.asarray(edges, dtype=np.int64).reshape(-1, 2),
              None if weights is None else np.asarray(weights, np.float32),
              part)
    return wr.close()
