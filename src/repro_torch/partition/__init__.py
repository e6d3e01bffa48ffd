"""Partitioners, copied from ``repro.partition`` (numpy only):

  * ``hash``        — Hama's default placement (random cut, the baseline),
  * ``bfs``         — multi-source BFS growth,
  * ``fennel``      — Fennel-style streaming,
  * ``multilevel``  — heavy-edge coarsening -> bfs seed -> refinement.

All share one signature through :func:`make_partition`:
``(edges (E,2), n_vertices, n_partitions, seed) -> (V,) int32 labels``, and
give the reference's labels for the same arguments.  The partition-quality
report waits for a later slice of the port.
"""

from __future__ import annotations

import numpy as np

from repro_torch.partition.seed import bfs_partition, hash_partition
from repro_torch.partition.streaming import (fennel_partition,
                                             fennel_partition_csr)
from repro_torch.partition.multilevel import multilevel_partition

__all__ = [
    "hash_partition", "bfs_partition", "fennel_partition",
    "fennel_partition_csr", "multilevel_partition", "PARTITIONERS",
    "make_partition",
]

# uniform signature: (edges, n_vertices, n_partitions, seed, **kw) -> labels
PARTITIONERS = {
    "hash": lambda edges, n, k, seed=0, **kw: hash_partition(n, k, seed=seed),
    "bfs": lambda edges, n, k, seed=0, **kw: bfs_partition(
        edges, n, k, seed=seed),
    "fennel": fennel_partition,
    "multilevel": multilevel_partition,
}


def make_partition(name: str, edges: np.ndarray, n_vertices: int,
                   n_partitions: int, seed: int = 0, **kw) -> np.ndarray:
    """Resolve a partitioner by name and run it."""
    try:
        fn = PARTITIONERS[name]
    except KeyError:
        raise ValueError(f"unknown partitioner {name!r}; "
                         f"have {sorted(PARTITIONERS)}") from None
    return np.asarray(fn(edges, n_vertices, n_partitions, seed=seed, **kw),
                      dtype=np.int32)
