"""Chunked edge-list sources: bounded-memory iteration over graphs on disk.

Every reader yields ``(edges (c, 2) int64, weights (c,) float32 | None)``
blocks of at most ``chunk_edges`` edges, in file order — the unit the whole
out-of-core pipeline (degree pass, external CSR, partition spill) is built
from.  Three concrete sources share the small :class:`EdgeSource` surface:

  * :class:`TextEdgeSource`   — SNAP-style whitespace-separated edge lists
                                (``src dst`` or ``src dst weight`` per line,
                                ``#`` comments), transparently gzip-aware;
  * :class:`StagedEdgeSource` — the binary staged-edge directory written by
                                :func:`repro_torch.io.stage.stage_edges` /
                                ``repro_torch.data.graphs.materialize``
                                (mmap'd, re-iterable for free);
  * :class:`ArrayEdgeSource`  — in-memory arrays chunked for tests and for
                                funnelling the in-memory API through the
                                identical code path.

Sources are re-iterable: ``chunks()`` starts a fresh pass each call (the
pipeline takes several passes — degrees, CSR fill, spill).

A copy of ``repro.io.readers`` (numpy only): both packages read the same
files into the same chunks.
"""

from __future__ import annotations

import gzip
import io
import itertools
import os

import numpy as np

__all__ = ["EdgeSource", "ArrayEdgeSource", "TextEdgeSource",
           "StagedEdgeSource", "open_edge_source", "DEFAULT_CHUNK_EDGES"]

DEFAULT_CHUNK_EDGES = 1 << 20


class EdgeSource:
    """Re-iterable chunk stream over an edge list.

    ``n_vertices`` / ``n_edges`` / ``weighted`` are None when the source
    cannot know them without a full pass (text files); the pipeline's
    degree pass fills the gaps.
    """

    n_vertices: int | None = None
    n_edges: int | None = None
    weighted: bool | None = None
    chunk_edges: int = DEFAULT_CHUNK_EDGES

    def chunks(self):
        raise NotImplementedError


class ArrayEdgeSource(EdgeSource):
    """Chunk an in-memory edge array (tests; in-memory save_graph)."""

    def __init__(self, edges: np.ndarray, weights: np.ndarray | None = None,
                 n_vertices: int | None = None,
                 chunk_edges: int = DEFAULT_CHUNK_EDGES):
        self.edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        self.weights = (None if weights is None
                        else np.asarray(weights, dtype=np.float32))
        self.n_vertices = n_vertices
        self.n_edges = len(self.edges)
        self.weighted = self.weights is not None
        self.chunk_edges = int(chunk_edges)

    def chunks(self):
        for a in range(0, len(self.edges), self.chunk_edges):
            b = min(a + self.chunk_edges, len(self.edges))
            w = None if self.weights is None else self.weights[a:b]
            yield self.edges[a:b], w


class TextEdgeSource(EdgeSource):
    """SNAP-style text edge list, gzip-aware, parsed in bounded blocks.

    Lines are ``src dst`` or ``src dst weight`` (whitespace-separated);
    ``#``-prefixed lines and blank lines are skipped.  The column count is
    sniffed from the first data line and then required of every block
    (np.loadtxt's C tokenizer does the parsing, so a pass is cheap enough
    to repeat — though the pipeline stages text to binary once instead).
    """

    def __init__(self, path: str, chunk_edges: int = DEFAULT_CHUNK_EDGES):
        self.path = path
        self.chunk_edges = int(chunk_edges)
        self.weighted = None          # sniffed on first pass

    def _open(self) -> io.TextIOBase:
        if self.path.endswith(".gz"):
            return io.TextIOWrapper(gzip.open(self.path, "rb"))
        return open(self.path, "rt")

    def chunks(self):
        with self._open() as f:
            data = (ln for ln in f
                    if ln.strip() and not ln.lstrip().startswith("#"))
            while True:
                block = list(itertools.islice(data, self.chunk_edges))
                if not block:
                    break
                ncol = len(block[0].split())
                if ncol == 2:
                    arr = np.loadtxt(block, dtype=np.int64, ndmin=2)
                    if self.weighted:
                        raise ValueError(
                            f"{self.path}: weight column disappeared "
                            f"mid-file")
                    self.weighted = False
                    yield arr, None
                elif ncol == 3:
                    arr = np.loadtxt(block, dtype=np.float64, ndmin=2)
                    if self.weighted is False:
                        raise ValueError(
                            f"{self.path}: weight column appeared mid-file")
                    self.weighted = True
                    yield (arr[:, :2].astype(np.int64),
                           arr[:, 2].astype(np.float32))
                else:
                    raise ValueError(
                        f"{self.path}: expected 2 or 3 columns, got {ncol}")


class StagedEdgeSource(EdgeSource):
    """Binary staged-edge directory (``edges.json`` + ``edges.bin`` [+
    ``weights.bin``]), written by :func:`repro_torch.io.stage.stage_edges`.

    Chunks come through buffered sequential reads, not a persistent mmap:
    file-backed pages a pass touches through a mapping stay on the
    process's peak RSS, and bounding peak RSS is this subsystem's whole
    job.  Each file existence/size is validated against the json up
    front."""

    def __init__(self, path: str, chunk_edges: int = DEFAULT_CHUNK_EDGES):
        from repro_torch.io.format import GraphFormatError, read_meta
        self.path = path
        meta = read_meta(os.path.join(path, "edges.json"), expect="edges")
        self.meta = meta
        self.n_vertices = int(meta["n_vertices"])
        self.n_edges = int(meta["n_edges"])
        self.weighted = bool(meta["weighted"])
        self.dtype = np.dtype(meta["dtype"])
        self.chunk_edges = int(chunk_edges)
        self._epath = os.path.join(path, "edges.bin")
        self._wpath = os.path.join(path, "weights.bin")
        want = self.n_edges * 2 * self.dtype.itemsize
        if not os.path.exists(self._epath):
            raise GraphFormatError(f"{self._epath}: missing")
        have = os.path.getsize(self._epath)
        if have != want:
            raise GraphFormatError(f"{self._epath}: {have} bytes, json "
                                   f"says {want}")
        if self.weighted and not os.path.exists(self._wpath):
            raise GraphFormatError(f"{self._wpath}: missing")

    def chunks(self):
        with open(self._epath, "rb") as fe:
            fw = open(self._wpath, "rb") if self.weighted else None
            try:
                for a in range(0, self.n_edges, self.chunk_edges):
                    c = min(self.chunk_edges, self.n_edges - a)
                    e = np.fromfile(fe, dtype=self.dtype,
                                    count=2 * c).reshape(c, 2)
                    yield (np.asarray(e, dtype=np.int64),
                           np.fromfile(fw, dtype=np.float32, count=c)
                           if fw is not None else None)
            finally:
                if fw is not None:
                    fw.close()

    def load_arrays(self):
        """The whole edge list in memory — the *in-memory* builder's entry
        point (and the A/B benchmark's baseline), not the pipeline's."""
        with open(self._epath, "rb") as f:
            edges = np.fromfile(f, dtype=self.dtype).reshape(-1, 2)
        edges = np.asarray(edges, dtype=np.int64)
        w = None
        if self.weighted:
            with open(self._wpath, "rb") as f:
                w = np.fromfile(f, dtype=np.float32)
        return edges, w


def open_edge_source(path: str,
                     chunk_edges: int = DEFAULT_CHUNK_EDGES) -> EdgeSource:
    """Resolve a path to the right chunked source: a staged-edge directory
    (``edges.json`` inside) or a text edge list (optionally ``.gz``).
    ``.ghp`` graph directories are *not* edge sources — load those with
    :func:`repro_torch.io.load_graph`."""
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "edges.json")):
            return StagedEdgeSource(path, chunk_edges)
        if os.path.exists(os.path.join(path, "meta.json")):
            raise ValueError(
                f"{path} looks like a sharded .ghp graph directory; use "
                f"repro_torch.io.load_graph / "
                f"build_partitioned_graph_from_path")
        raise FileNotFoundError(f"{path}: no edges.json in directory")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return TextEdgeSource(path, chunk_edges)
