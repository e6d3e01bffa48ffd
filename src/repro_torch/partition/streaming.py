"""Fennel-style streaming partitioner (Tsourakakis et al., WSDM'14).

One pass over the vertices in random order; each vertex lands in the
partition maximizing

    |N(v) ∩ P_p|  −  α·γ·|P_p|^(γ−1)

i.e. greedy neighbour affinity minus a superlinear balance term whose
weight ``α = m·k^(γ−1)/n^γ`` scales with the average degree (dense graphs
pay a larger penalty per occupied slot, which is what keeps hubs from
dragging everything into one part — the degree-penalized interpolation
between pure greedy and pure balance).  A hard capacity ``ν·n/k`` caps the
slack regardless of scores, so the output always satisfies
``balance ≤ balance_slack`` (up to the ceil needed for feasibility).

Streaming means O(E) total work and one vertex-at-a-time decisions — the
regime where the partitioner itself must not cost more than the first few
supersteps it saves.  The scoring loop is blocked: neighbour-affinity
counts against already-assigned vertices are batched per block of the
visit permutation (one vectorized scatter-add over the block's
concatenated adjacency), the balance penalty is cached and updated one
entry per assignment, and only the rare within-block neighbours are
corrected per vertex — the per-vertex Python work no longer touches the
full adjacency row.  The assignment sequence (and therefore the labeling)
is identical to the naive sequential scan for a given seed.

``fennel_partition`` consumes an in-memory edge list; ``fennel_partition_csr``
runs the same core over any CSR adjacency — including the mmap-backed
external CSR that ``repro.io`` builds chunk-by-chunk for graphs that never
fit in memory.
"""

from __future__ import annotations

import numpy as np

from repro_torch.partition.seed import undirected_csr

__all__ = ["fennel_partition", "fennel_partition_csr"]


def fennel_partition(edges: np.ndarray, n_vertices: int, n_partitions: int,
                     seed: int = 0, gamma: float = 1.5,
                     balance_slack: float = 1.1) -> np.ndarray:
    """Stream vertices once, greedily assigning by the Fennel objective."""
    edges = np.asarray(edges, dtype=np.int64)
    if n_partitions <= 1 or n_vertices == 0:
        return np.zeros(n_vertices, dtype=np.int32)
    starts, adj_val = undirected_csr(edges, n_vertices)
    return fennel_partition_csr(starts, adj_val, n_vertices, n_partitions,
                                n_edges=len(edges), seed=seed, gamma=gamma,
                                balance_slack=balance_slack)


def fennel_partition_csr(starts: np.ndarray, adj_val: np.ndarray,
                         n_vertices: int, n_partitions: int, *,
                         n_edges: int, seed: int = 0, gamma: float = 1.5,
                         balance_slack: float = 1.1,
                         block: int = 4096) -> np.ndarray:
    """Fennel over a symmetrized CSR adjacency (``starts`` (V+1,),
    ``adj_val`` (2E,) — plain arrays or ``np.memmap``).  Neighbour *order*
    is irrelevant (affinity is a count), so any CSR with the right
    per-vertex neighbour multiset — in-memory or externally built — yields
    the same labeling."""
    n, k = int(n_vertices), int(n_partitions)
    if k <= 1 or n == 0:
        return np.zeros(n, dtype=np.int32)
    starts = np.asarray(starts, dtype=np.int64)

    m = max(int(n_edges), 1)
    alpha = m * (k ** (gamma - 1.0)) / float(max(n, 1) ** gamma)
    cap = max(balance_slack * n / k,
              float(-(-n // k)))              # feasibility: >= ceil(n/k)

    part = np.full(n, -1, dtype=np.int32)
    sizes = np.zeros(k, dtype=np.float64)
    # effective penalty: the balance term, +inf once a partition hits the
    # hard cap (finite_count − inf == −inf, exactly the masked score the
    # per-vertex formulation computes), updated one entry per assignment
    eff = alpha * gamma * np.power(sizes, gamma - 1.0)
    eff[sizes + 1.0 > cap] = np.inf
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    rank = np.empty(n, dtype=np.int64)
    rank[perm] = np.arange(n)

    for b0 in range(0, n, block):
        vs = perm[b0:b0 + block]
        deg = starts[vs + 1] - starts[vs]
        total = int(deg.sum())
        off = np.zeros(len(vs) + 1, dtype=np.int64)
        np.cumsum(deg, out=off[1:])
        # gather the block's concatenated adjacency in one fancy index
        gidx = (np.repeat(starts[vs], deg)
                + np.arange(total) - np.repeat(off[:-1], deg))
        nbrs = np.asarray(adj_val[gidx], dtype=np.int64)
        owner = np.repeat(np.arange(len(vs)), deg)
        # affinity against everything assigned before this block, batched
        # (flat bincount: same integer counts as a scatter-add, ~10-30x
        # the throughput of ufunc.at's per-element dispatch)
        npart = part[nbrs]
        assigned = npart >= 0
        base = np.bincount(owner[assigned] * k + npart[assigned],
                           minlength=len(vs) * k
                           ).reshape(len(vs), k).astype(np.float64)
        # neighbours that will be assigned *within* this block need the
        # per-vertex correction below (a vanishing fraction: block/n)
        inblk = (rank[nbrs] >= b0) & (rank[nbrs] < b0 + len(vs))
        inb_cnt = np.bincount(owner[inblk], minlength=len(vs))
        for i in range(len(vs)):
            if inb_cnt[i]:
                # counts are exact in float64, so summing them before the
                # penalty subtraction keeps the score bit-identical to the
                # naive one-vertex-at-a-time evaluation
                score = base[i].copy()
                ib = nbrs[off[i]:off[i + 1]][inblk[off[i]:off[i + 1]]]
                pp = part[ib]
                pp = pp[pp >= 0]
                if len(pp):
                    score += np.bincount(pp, minlength=k)
                score -= eff
            else:
                score = base[i] - eff
            p = int(np.argmax(score))
            part[vs[i]] = p
            sizes[p] += 1.0
            eff[p] = (np.inf if sizes[p] + 1.0 > cap
                      else alpha * gamma * np.power(sizes[p], gamma - 1.0))
    return part
