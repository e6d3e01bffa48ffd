"""Multilevel partitioner: the Metis recipe on numpy arrays.

Three phases, all vectorized except the (small) move loops:

  1. **Coarsen** — repeated mutual heavy-edge matching: every vertex
     proposes its heaviest incident edge (ties broken by a seeded jitter);
     mutual proposals merge.  Each level roughly halves the graph while
     preserving the cut structure, because a heavy edge inside a coarse
     vertex can never be cut.
  2. **Partition the coarse graph** — ``bfs_partition`` (the repo's seed
     grower) on the coarsest graph, where its O(n) Python loop is cheap.
  3. **Uncoarsen + refine** — project labels back level by level; at each
     level a few greedy boundary-refinement passes apply single-vertex
     moves that strictly reduce the (weighted) cut subject to a balance
     cap.  Gains are kept exact by locking the moved vertex's neighbourhood
     for the rest of the pass (a moved neighbour would invalidate the
     precomputed connectivity row); overweight partitions may additionally
     shed vertices on negative gain until they fit the cap.

The finest level carries unit vertex weights, so the closing rebalance can
always restore ``balance ≤ balance_slack`` exactly.
"""

from __future__ import annotations

import numpy as np

from repro_torch.partition.seed import bfs_partition

__all__ = ["multilevel_partition"]


def _undirected_weighted(edges: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unique undirected (u < v) pairs with multiplicity as edge weight."""
    und = np.sort(np.asarray(edges, dtype=np.int64), axis=1)
    und = und[und[:, 0] != und[:, 1]]
    if not len(und):
        return np.zeros((0, 2), np.int64), np.zeros(0, np.float64)
    uv, w = np.unique(und, axis=0, return_counts=True)
    return uv, w.astype(np.float64)


def _heavy_edge_matching(uv: np.ndarray, w: np.ndarray, n: int,
                         rng: np.random.RandomState) -> np.ndarray:
    """Coarse-vertex map (n,) from one round of mutual heaviest-edge
    proposals; unmatched vertices map to themselves."""
    ids = np.arange(n, dtype=np.int64)
    if not len(uv):
        return ids
    jitter = 1.0 + 1e-6 * rng.uniform(size=len(w))
    s = np.concatenate([uv[:, 0], uv[:, 1]])
    t = np.concatenate([uv[:, 1], uv[:, 0]])
    ww = np.concatenate([w * jitter, w * jitter])
    order = np.lexsort((-ww, s))
    s, t = s[order], t[order]
    first = np.unique(s, return_index=True)[1]
    cand = np.full(n, -1, dtype=np.int64)
    cand[s[first]] = t[first]
    ok = cand >= 0
    mutual = ok & (cand[np.where(ok, cand, 0)] == ids)
    rep = np.where(mutual & (ids > cand), cand, ids)
    return rep


def _coarsen(uv, w, vweight, rng):
    """One matching level -> (coarse uv, w, vweight, fine->coarse map)."""
    n = len(vweight)
    rep = _heavy_edge_matching(uv, w, n, rng)
    roots, cmap = np.unique(rep, return_inverse=True)
    nc = len(roots)
    cvw = np.bincount(cmap, weights=vweight, minlength=nc)
    cu, cv = cmap[uv[:, 0]], cmap[uv[:, 1]]
    keep = cu != cv
    cuv = np.sort(np.stack([cu[keep], cv[keep]], axis=1), axis=1)
    if len(cuv):
        cuv, inv = np.unique(cuv, axis=0, return_inverse=True)
        cw = np.bincount(inv, weights=w[keep], minlength=len(cuv))
    else:
        cuv, cw = np.zeros((0, 2), np.int64), np.zeros(0, np.float64)
    return cuv, cw, cvw, cmap.astype(np.int64)


def _refine(uv: np.ndarray, w: np.ndarray, vweight: np.ndarray,
            part: np.ndarray, k: int, cap: float, passes: int) -> np.ndarray:
    """Greedy boundary refinement: exact-gain single-vertex moves that
    reduce the weighted cut (or shed weight from over-cap partitions),
    neighbourhoods locked per pass so applied gains stay exact."""
    n = len(vweight)
    if not len(uv) or k <= 1:
        return part
    s = np.concatenate([uv[:, 0], uv[:, 1]])
    t = np.concatenate([uv[:, 1], uv[:, 0]])
    ww = np.concatenate([w, w])
    order = np.argsort(s, kind="stable")
    s_s, t_s, w_s = s[order], t[order], ww[order]
    starts = np.searchsorted(s_s, np.arange(n + 1))

    sizes = np.bincount(part, weights=vweight, minlength=k).astype(np.float64)
    ids = np.arange(n)
    for _ in range(passes):
        conn = np.zeros((n, k), dtype=np.float64)
        np.add.at(conn, (s, part[t]), ww)
        cur = conn[ids, part]
        conn[ids, part] = -np.inf
        best = conn.argmax(axis=1).astype(np.int32)
        gain = conn[ids, best] - cur
        over = sizes[part] > cap
        cand = np.nonzero((gain > 0) | over)[0]
        if not cand.size:
            break
        cand = cand[np.argsort(-gain[cand], kind="stable")]
        locked = np.zeros(n, dtype=bool)
        moved = 0
        for vtx in cand:
            if locked[vtx]:
                continue
            p0, p1 = int(part[vtx]), int(best[vtx])
            if p1 == p0:
                continue
            wv = float(vweight[vtx])
            fits = sizes[p1] + wv <= cap
            sheds = sizes[p0] > cap and sizes[p1] + wv < sizes[p0]
            if not (fits or sheds):
                continue
            if gain[vtx] <= 0 and sizes[p0] <= cap:
                continue
            part[vtx] = p1
            sizes[p0] -= wv
            sizes[p1] += wv
            moved += 1
            locked[vtx] = True
            locked[t_s[starts[vtx]:starts[vtx + 1]]] = True
        if not moved:
            break
    return part


def _rebalance(uv, w, part, k, cap):
    """Hard cap enforcement at the finest (unit-weight) level: move the
    cheapest-to-move vertices out of over-cap partitions into the least
    loaded ones until every partition fits."""
    n = len(part)
    sizes = np.bincount(part, minlength=k).astype(np.float64)
    if sizes.max() <= cap:
        return part
    conn = np.zeros((n, k), dtype=np.float64)
    if len(uv):
        s = np.concatenate([uv[:, 0], uv[:, 1]])
        t = np.concatenate([uv[:, 1], uv[:, 0]])
        ww = np.concatenate([w, w])
        np.add.at(conn, (s, part[t]), ww)
    others = np.arange(k)
    for p in range(k):
        while sizes[p] > cap:
            movers = np.nonzero(part == p)[0]
            # cheapest first: least attached to home
            vtx = int(movers[np.argmin(conn[movers, p])])
            # target: most attached among partitions with room, else smallest
            roomy = (sizes + 1 <= cap) & (others != p)
            if roomy.any():
                p1 = int(np.argmax(np.where(roomy, conn[vtx], -np.inf)))
            else:
                p1 = int(np.argmin(np.where(others != p, sizes, np.inf)))
            part[vtx] = p1
            sizes[p] -= 1
            sizes[p1] += 1
    return part


def multilevel_partition(edges: np.ndarray, n_vertices: int,
                         n_partitions: int, seed: int = 0,
                         coarsen_to: int | None = None,
                         max_levels: int = 24,
                         balance_slack: float = 1.1,
                         refine_passes: int = 4) -> np.ndarray:
    """Heavy-edge coarsening -> ``bfs_partition`` coarse seed -> greedy
    boundary refinement per uncoarsening level.  See module docstring."""
    k = int(n_partitions)
    if k <= 1 or n_vertices == 0:
        return np.zeros(n_vertices, dtype=np.int32)
    rng = np.random.RandomState(seed)
    uv, w = _undirected_weighted(edges)
    vweight = np.ones(n_vertices, dtype=np.float64)
    if coarsen_to is None:
        coarsen_to = max(32 * k, 128)

    levels: list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []
    for _ in range(max_levels):
        if len(vweight) <= coarsen_to or not len(uv):
            break
        cuv, cw, cvw, cmap = _coarsen(uv, w, vweight, rng)
        if len(cvw) > 0.95 * len(vweight):     # matching stalled
            break
        levels.append((uv, w, vweight, cmap))
        uv, w, vweight = cuv, cw, cvw

    total = float(vweight.sum())
    cap = max(balance_slack * total / k, float(vweight.max()))
    part = bfs_partition(uv, len(vweight), k, seed=seed).astype(np.int32)
    part = _refine(uv, w, vweight, part, k, cap, refine_passes)

    for fuv, fw, fvw, cmap in reversed(levels):
        part = part[cmap]
        cap = max(balance_slack * float(fvw.sum()) / k, float(fvw.max()))
        part = _refine(fuv, fw, fvw, part, k, cap, refine_passes)

    cap = max(balance_slack * n_vertices / k, float(-(-n_vertices // k)))
    fuv, fw = (levels[0][0], levels[0][1]) if levels else (uv, w)
    part = _rebalance(fuv, fw, part, k, cap)
    return part.astype(np.int32)
