"""Staging: edge lists as flat binary, ready for repeated cheap passes.

A staged-edge directory is the pre-partition counterpart of ``.ghp``::

    staged/
      edges.json    {"format": "edges", "version": 1, n_vertices, n_edges,
                     dtype, weighted}
      edges.bin     (E, 2) row-major, dtype from the json
      weights.bin   (E,) float32            [weighted only]

Raw ``.bin`` (not ``.npy``) because the writer appends chunks without
knowing the final count up front — text sources reveal their length only
as they are parsed; shape lives in ``edges.json`` and readers
``np.memmap`` against it.

:func:`stage_edges` converts any
:class:`~repro_torch.io.readers.EdgeSource` (one parse of a text file, at
most chunk-sized memory); :func:`materialize` generates one of
``repro_torch.data.graphs``'s synthetic families straight into a staged
directory, which is how benchmarks put a 10^7-edge R-MAT on disk without
every consumer re-synthesizing it.

A copy of ``repro.io.stage`` (numpy only).
"""

from __future__ import annotations

import os

import numpy as np

from repro_torch.io.format import (GHP_VERSION, GraphFormatError,
                             check_id_range, write_meta)
from repro_torch.io.readers import EdgeSource, StagedEdgeSource

__all__ = ["stage_edges", "stage_arrays", "materialize"]


def stage_arrays(path: str, edges: np.ndarray,
                 weights: np.ndarray | None = None,
                 n_vertices: int | None = None,
                 dtype=None) -> StagedEdgeSource:
    """Write in-memory arrays as a staged-edge directory."""
    edges = np.asarray(edges)
    if dtype is None:
        dtype = edges.dtype if edges.dtype in (np.int32, np.int64) \
            else np.int64
    dtype = np.dtype(dtype)
    if n_vertices is None:
        n_vertices = int(edges.max()) + 1 if len(edges) else 0
    check_id_range(edges, dtype, path)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "edges.bin"), "wb") as f:
        f.write(np.ascontiguousarray(edges, dtype=dtype).tobytes())
    if weights is not None:
        with open(os.path.join(path, "weights.bin"), "wb") as f:
            f.write(np.ascontiguousarray(weights, np.float32).tobytes())
    write_meta(os.path.join(path, "edges.json"), {
        "format": "edges", "version": GHP_VERSION,
        "n_vertices": int(n_vertices), "n_edges": int(len(edges)),
        "dtype": dtype.name, "weighted": weights is not None,
    })
    return StagedEdgeSource(path)


def stage_edges(source: EdgeSource, path: str,
                n_vertices: int | None = None,
                dtype=np.int64) -> StagedEdgeSource:
    """Stream any edge source into a staged-edge directory (one pass,
    chunk-bounded memory)."""
    dtype = np.dtype(dtype)
    os.makedirs(path, exist_ok=True)
    n_edges = 0
    max_id = -1
    weighted = None
    with open(os.path.join(path, "edges.bin"), "wb") as fe:
        fw = None
        try:
            for edges, w in source.chunks():
                if weighted is None:
                    weighted = w is not None
                    if weighted:
                        fw = open(os.path.join(path, "weights.bin"), "wb")
                elif weighted != (w is not None):
                    raise GraphFormatError(
                        f"{path}: weight column changed mid-stream")
                check_id_range(edges, dtype, path)
                fe.write(np.ascontiguousarray(edges, dtype=dtype).tobytes())
                if weighted:
                    fw.write(np.ascontiguousarray(w, np.float32).tobytes())
                n_edges += len(edges)
                if len(edges):
                    max_id = max(max_id, int(edges.max()))
        finally:
            if fw is not None:
                fw.close()
    if n_vertices is None:
        n_vertices = (source.n_vertices if source.n_vertices is not None
                      else max_id + 1)
    write_meta(os.path.join(path, "edges.json"), {
        "format": "edges", "version": GHP_VERSION,
        "n_vertices": int(n_vertices), "n_edges": int(n_edges),
        "dtype": dtype.name, "weighted": bool(weighted),
    })
    return StagedEdgeSource(path)


def materialize(path: str, kind: str, **params) -> StagedEdgeSource:
    """Generate a synthetic graph family on disk.

    ``kind`` picks the ``repro_torch.data.graphs`` generator ('rmat' | 'grid' |
    'geometric' | 'bipartite' | 'path' | 'cycle'); ``params`` pass through
    (plus ``symmetrize=True`` to mirror the edge set).  The generator
    itself runs in memory — it is the *consumers* that stay out-of-core —
    so staging is exactly one array write.
    """
    from repro_torch.data import graphs as G

    sym = params.pop("symmetrize", False)
    weights = None
    if kind == "rmat":
        edges, n = G.rmat_graph(**params)
    elif kind == "grid":
        edges, weights, n = G.grid_graph(**params)
    elif kind == "geometric":
        edges, n = G.geometric_graph(**params)
    elif kind == "bipartite":
        edges, _, n = G.bipartite_graph(**params)
    elif kind == "path":
        edges, n = G.path_graph(**params)
    elif kind == "cycle":
        edges, n = G.cycle_graph(**params)
    else:
        raise ValueError(f"unknown graph kind {kind!r}")
    if sym:
        if weights is not None:
            raise ValueError("symmetrize=True only applies to unweighted "
                             "kinds")
        edges = G.symmetrize(edges)
    return stage_arrays(path, edges, weights=weights, n_vertices=n)
