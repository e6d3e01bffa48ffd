"""Partition-quality report: the numbers that predict GraphHP traffic.

GraphHP's advantage scales with how many in-edges a partition keeps
internal, so every quantity here is a direct proxy for a paper metric:

  * ``edge_cut_frac``   — crossing edges / E: the raw message surface,
  * ``boundary_frac``   — vertices with a remote in-edge / V: the global-
                          phase workload (only boundary vertices compute
                          once per global iteration),
  * ``replication``     — H/V, halo entries per vertex: each halo entry is
                          one exported value per exchange (Pregel-speak:
                          the vertex replication factor of the cut),
  * ``balance``         — max partition size / (V/k): straggler exposure,
  * ``exchange_bytes``  — estimated bytes per exchange: one value per halo
                          entry, i.e. ``sum(export_fanout)`` of the built
                          :class:`~repro_torch.core.graph.PartitionedGraph`
                          (computable from the raw labeling without
                          building — both routes agree, tested),
  * ``pad_waste``       — ``k * max_p |edges(p)| / sum_p |edges(p)|``: the
                          memory and work multiplier a shared-width padded
                          edge layout (``edge_blocks=P``) pays over the
                          ragged one (``edge_blocks=1``) for this
                          labeling's in-edge skew; 1.0 means perfectly
                          even, hub-clustering labelings run much higher.

``partition_report`` works from the raw ``(edges, part)`` labeling; pass
``graph=`` (the port's, on any device) to read the halo size off a built
``PartitionedGraph``'s
``export_fanout`` plan instead (they are equal by construction: fanout
counts distinct consuming partitions per exporter, halo counts distinct
needed sources per consumer).

A copy of ``repro.partition.quality`` (numpy only).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = ["PartitionReport", "partition_report"]


@dataclasses.dataclass(frozen=True)
class PartitionReport:
    n_vertices: int
    n_edges: int
    n_partitions: int
    edge_cut: int           # crossing edges
    edge_cut_frac: float
    boundary_vertices: int  # vertices with >= 1 remote in-edge
    boundary_frac: float
    halo_entries: int       # unique (consumer partition, remote source) pairs
    replication: float      # halo_entries / n_vertices (H/V)
    balance: float          # max partition size / (n/k)
    exchange_bytes: int     # halo_entries * bytes_per_value per exchange
    pad_waste: float        # k * max_p in-edges / sum_p in-edges

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        return (f"cut {100 * self.edge_cut_frac:.1f}% "
                f"boundary {100 * self.boundary_frac:.1f}% "
                f"H/V {self.replication:.2f} "
                f"balance {self.balance:.2f} "
                f"pad-waste {self.pad_waste:.2f}x "
                f"exchange {self.exchange_bytes / 1024:.1f} KiB")


def partition_report(edges: np.ndarray, n_vertices: int, part: np.ndarray,
                     bytes_per_value: int = 4,
                     graph: Any = None,
                     n_partitions: int | None = None) -> PartitionReport:
    """Quality metrics of a vertex->partition labeling (see module doc).

    Pass ``n_partitions`` when the labeling was *requested* at a given k:
    a partitioner that leaves trailing partitions empty would otherwise
    have its balance measured against the smaller occupied count."""
    edges = np.asarray(edges, dtype=np.int64)
    part = np.asarray(part)
    occupied = int(part.max()) + 1 if part.size else 1
    k = occupied if n_partitions is None else max(int(n_partitions), occupied)
    src, dst = edges[:, 0], edges[:, 1]
    cross = part[src] != part[dst]
    cut = int(cross.sum())

    boundary = np.zeros(n_vertices, dtype=bool)
    boundary[dst[cross]] = True
    n_boundary = int(boundary.sum())

    if graph is not None:
        # tensors on any device, or numpy arrays
        halo = int(graph.export_fanout[graph.export_mask].sum())
    else:
        pairs = np.unique(
            np.stack([part[dst[cross]].astype(np.int64), src[cross]], axis=1),
            axis=0)
        halo = len(pairs)

    sizes = np.bincount(part, minlength=k)
    balance = float(sizes.max() / (n_vertices / k)) if n_vertices else 1.0

    in_edges = np.bincount(part[dst], minlength=k) if len(edges) else \
        np.zeros(k, dtype=np.int64)
    pad_waste = (float(k * in_edges.max() / in_edges.sum())
                 if in_edges.sum() else 1.0)

    return PartitionReport(
        n_vertices=int(n_vertices), n_edges=len(edges), n_partitions=k,
        edge_cut=cut,
        edge_cut_frac=cut / max(len(edges), 1),
        boundary_vertices=n_boundary,
        boundary_frac=n_boundary / max(n_vertices, 1),
        halo_entries=halo,
        replication=halo / max(n_vertices, 1),
        balance=balance,
        exchange_bytes=halo * bytes_per_value,
        pad_waste=pad_waste,
    )
