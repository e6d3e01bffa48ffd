"""Seed partitioners: the hash cut and the multi-source BFS grower.

These are the two partitioners the repo shipped inside ``core/graph.py``
since the seed: ``hash_partition`` is Hama's default placement (the paper's
baseline, a random cut), ``bfs_partition`` a cheap locality-preserving
stand-in for (Par)Metis.  They live here now as the bottom rungs of the
partitioner ladder — ``bfs_partition`` doubles as the coarse-level seed of
:func:`repro.partition.multilevel.multilevel_partition`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["hash_partition", "bfs_partition", "undirected_csr"]


def hash_partition(n_vertices: int, n_partitions: int, seed: int = 0) -> np.ndarray:
    """Hama's default placement: hash(id) mod k (random cut, many crossings)."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n_vertices).astype(np.int64)
    return (perm % n_partitions).astype(np.int32)


def undirected_csr(edges: np.ndarray, n_vertices: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(starts, neighbours) CSR view of the symmetrized edge list."""
    adj_idx = np.concatenate([edges[:, 0], edges[:, 1]])
    adj_val = np.concatenate([edges[:, 1], edges[:, 0]])
    order = np.argsort(adj_idx, kind="stable")
    adj_idx, adj_val = adj_idx[order], adj_val[order]
    starts = np.searchsorted(adj_idx, np.arange(n_vertices + 1))
    return starts, adj_val


def bfs_partition(edges: np.ndarray, n_vertices: int, n_partitions: int,
                  seed: int = 0) -> np.ndarray:
    """Locality-preserving partitioner standing in for (Par)Metis.

    Multi-source BFS growth: seeds spread round-robin; each round grows the
    *smallest* partitions first (partitions are processed in ascending size
    order, so frontier claims genuinely favour the partition most behind —
    the Metis-ish balance objective the docstring always promised).  When a
    partition's budget runs out mid-frontier the unexpanded frontier tail
    is kept, not dropped, so growth resumes exactly where it stopped
    instead of re-seeding across a hole.
    """
    rng = np.random.RandomState(seed)
    starts, adj_val = undirected_csr(edges, n_vertices)

    part = np.full(n_vertices, -1, dtype=np.int32)
    sizes = np.zeros(n_partitions, dtype=np.int64)
    target = (n_vertices + n_partitions - 1) // n_partitions
    frontiers: list[list[int]] = [[] for _ in range(n_partitions)]
    unvisited = rng.permutation(n_vertices).tolist()
    uptr = 0

    def next_seed() -> int | None:
        nonlocal uptr
        while uptr < len(unvisited):
            v = unvisited[uptr]
            uptr += 1
            if part[v] < 0:
                return v
        return None

    for p in range(n_partitions):
        s = next_seed()
        if s is None:
            break
        part[s] = p
        sizes[p] += 1
        frontiers[p].append(s)

    active = True
    while active:
        active = False
        for p in sorted(range(n_partitions), key=lambda q: (sizes[q], q)):
            if sizes[p] >= target:
                continue
            budget = target - sizes[p]
            frontier = frontiers[p]
            new_frontier: list[int] = []
            consumed = 0
            for v in frontier:
                if budget <= 0:
                    break
                for u in adj_val[starts[v]:starts[v + 1]]:
                    if part[u] < 0 and budget > 0:
                        part[u] = p
                        sizes[p] += 1
                        budget -= 1
                        new_frontier.append(int(u))
                # v counts as consumed only if the budget survived its whole
                # neighbour scan — a mid-scan cutoff keeps v in the tail so
                # growth resumes there (its already-claimed neighbours are
                # skipped by the part[u] < 0 test on the rescan)
                if budget > 0:
                    consumed += 1
            new_frontier.extend(frontier[consumed:])
            if not new_frontier and sizes[p] < target:
                s = next_seed()
                if s is not None:
                    part[s] = p
                    sizes[p] += 1
                    new_frontier.append(s)
            frontiers[p] = new_frontier
            active = active or bool(new_frontier)

    # sweep leftovers (isolated vertices) to the smallest partitions
    for v in range(n_vertices):
        if part[v] < 0:
            p = int(np.argmin(sizes))
            part[v] = p
            sizes[p] += 1
    return part
