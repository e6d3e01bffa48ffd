"""Synthetic graph generators standing in for the paper's datasets (Table 1).

  * ``grid_graph``       — lattice road network: high diameter, like
                           USA-Road-NE/Full (the SSSP datasets),
  * ``rmat_graph``       — power-law/heavy-tail web graph, like Web-Google
                           and uk-2002 (the PageRank datasets),
  * ``bipartite_graph``  — random bipartite, like cit-patents in the BM role,
  * ``geometric_graph``  — random points connected by proximity, the
                           delaunay_n24 stand-in (planar-ish, BM/partitioning),
  * ``path_graph`` / ``cycle_graph`` — exactness fixtures.

All return ``(edges (E,2) int64, n_vertices)`` (+ weights where meaningful).
Deterministic under ``seed``.  A copy of ``repro.data.graphs`` (numpy
only).
"""

from __future__ import annotations

import numpy as np

__all__ = ["grid_graph", "rmat_graph", "bipartite_graph", "geometric_graph",
           "path_graph", "cycle_graph", "symmetrize", "ensure_no_dangling",
           "materialize"]


def materialize(path: str, kind: str, **params):
    """Stage a synthetic graph on disk as a binary edge directory that the
    ``repro_torch.io`` out-of-core pipeline (and ``python -m
    repro_torch.io.convert``) consumes — how benchmarks put a 10^7-edge
    R-MAT on disk once instead of re-synthesizing it per consumer.
    ``kind`` is one of 'rmat' | 'grid' | 'geometric' | 'bipartite' |
    'path' | 'cycle'; ``params`` pass through to the generator (plus
    ``symmetrize=True``).  Returns the opened
    :class:`repro_torch.io.StagedEdgeSource`."""
    from repro_torch.io.stage import materialize as _materialize
    return _materialize(path, kind, **params)


def symmetrize(edges: np.ndarray) -> np.ndarray:
    """Both directions, deduplicated."""
    both = np.concatenate([edges, edges[:, ::-1]], axis=0)
    return np.unique(both, axis=0)


def ensure_no_dangling(edges: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    """Give every vertex out-degree >= 1 (Algorithm 5 does not redistribute
    dangling mass; the oracle matches this dynamics either way, but dangling-
    free graphs also let networkx.pagerank serve as a second oracle)."""
    rng = np.random.RandomState(seed)
    deg = np.bincount(edges[:, 0], minlength=n)
    dangling = np.nonzero(deg == 0)[0]
    if len(dangling) == 0:
        return edges
    tgt = rng.randint(0, n, size=len(dangling))
    tgt = np.where(tgt == dangling, (tgt + 1) % n, tgt)
    extra = np.stack([dangling, tgt], axis=1)
    return np.concatenate([edges, extra], axis=0)


def grid_graph(rows: int, cols: int, seed: int = 0,
               weighted: bool = True) -> tuple[np.ndarray, np.ndarray, int]:
    """4-neighbour lattice with bidirectional weighted edges (road network)."""
    rng = np.random.RandomState(seed)
    n = rows * cols
    vid = np.arange(n).reshape(rows, cols)
    e = []
    e.append(np.stack([vid[:, :-1].ravel(), vid[:, 1:].ravel()], axis=1))
    e.append(np.stack([vid[:-1, :].ravel(), vid[1:, :].ravel()], axis=1))
    edges = np.concatenate(e, axis=0)
    edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    w = (rng.uniform(1.0, 10.0, size=len(edges) // 2) if weighted
         else np.ones(len(edges) // 2))
    w = np.concatenate([w, w]).astype(np.float32)   # symmetric weights
    return edges.astype(np.int64), w, n


def rmat_graph(n: int, avg_degree: int = 8, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19
               ) -> tuple[np.ndarray, int]:
    """R-MAT power-law digraph (Web-Google / uk-2002 stand-in)."""
    rng = np.random.RandomState(seed)
    scale = int(np.ceil(np.log2(max(n, 2))))
    m = n * avg_degree
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for _ in range(scale):
        r = rng.uniform(size=m)
        src = src * 2 + (r >= a + b).astype(np.int64)
        dst = dst * 2 + (((r >= a) & (r < a + b)) |
                         (r >= a + b + c)).astype(np.int64)
    keep = (src < n) & (dst < n) & (src != dst)
    edges = np.unique(np.stack([src[keep], dst[keep]], axis=1), axis=0)
    return edges, n


def bipartite_graph(n_left: int, n_right: int, avg_degree: int = 4,
                    seed: int = 0) -> tuple[np.ndarray, int, int]:
    """Random bipartite graph; lefts are ids [0, n_left), rights follow.
    Edges are returned in BOTH directions (the matching handshake needs
    right->left channels)."""
    rng = np.random.RandomState(seed)
    m = n_left * avg_degree
    l = rng.randint(0, n_left, size=m)
    r = rng.randint(0, n_right, size=m) + n_left
    edges = np.unique(np.stack([l, r], axis=1), axis=0)
    edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    return edges.astype(np.int64), n_left, n_left + n_right


def geometric_graph(n: int, radius: float | None = None, seed: int = 0
                    ) -> tuple[np.ndarray, int]:
    """Random geometric graph in the unit square (delaunay_n24 stand-in):
    planar-ish locality, low max degree — the structure partitioners love.

    Grid-bucketed neighbour search in O(n + E) *array* work: candidate
    pairs are materialized per cell-pair offset with run-expansion
    (``np.repeat`` over bucket counts), so there is no per-vertex Python
    loop and ~10⁶-vertex instances build in seconds."""
    rng = np.random.RandomState(seed)
    if radius is None:
        radius = np.sqrt(6.0 / (np.pi * n))   # ~6 expected neighbours
    pts = rng.uniform(size=(n, 2))
    nb = max(1, int(1.0 / radius))
    cell = np.minimum((pts / (1.0 / nb)).astype(np.int64), nb - 1)
    key = cell[:, 0] * nb + cell[:, 1]
    order = np.argsort(key, kind="stable")
    starts = np.searchsorted(key[order], np.arange(nb * nb + 1))
    ids = np.arange(n, dtype=np.int64)
    r2 = radius * radius
    out = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            nc0 = cell[:, 0] + dx
            nc1 = cell[:, 1] + dy
            ok = (nc0 >= 0) & (nc0 < nb) & (nc1 >= 0) & (nc1 < nb)
            src0 = ids[ok]
            nk = nc0[ok] * nb + nc1[ok]
            cnt = starts[nk + 1] - starts[nk]
            nonempty = cnt > 0
            src0, nk, cnt = src0[nonempty], nk[nonempty], cnt[nonempty]
            if not len(src0):
                continue
            # expand each source against its neighbour bucket's run
            src = np.repeat(src0, cnt)
            within = np.arange(len(src)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
            cand = order[np.repeat(starts[nk], cnt) + within]
            d2 = ((pts[cand] - pts[src]) ** 2).sum(axis=1)
            hit = (d2 < r2) & (cand != src)
            if hit.any():
                out.append(np.stack([src[hit], cand[hit]], axis=1))
    if not out:
        return np.zeros((0, 2), np.int64), n
    edges = np.unique(np.concatenate(out, axis=0), axis=0)
    return edges.astype(np.int64), n


def path_graph(n: int) -> tuple[np.ndarray, int]:
    e = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    return e.astype(np.int64), n


def cycle_graph(n: int) -> tuple[np.ndarray, int]:
    e = np.stack([np.arange(n), (np.arange(n) + 1) % n], axis=1)
    return e.astype(np.int64), n
