"""Elastic scaling: replan partition/shard ownership when the worker count
changes between restarts (grow or shrink), and re-shard checkpointed vertex
state when the *partition* count itself changes
(``repro_torch.io.resize``).  A copy of ``repro.ft.elastic`` (numpy; the
slot rule is the port's copy of the builder's)."""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ElasticPlan", "replan_partitions", "resize_labels",
           "reshard_vertex_tree"]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    n_partitions: int
    old_workers: int
    new_workers: int
    owner: np.ndarray          # (n_partitions,) new owner per partition
    moved: int                 # partitions that changed owner


def partition_owners(n_partitions: int, n_workers: int) -> np.ndarray:
    """Contiguous-block ownership: partition i -> worker i*W//P."""
    return (np.arange(n_partitions) * n_workers
            // n_partitions).astype(np.int32)


def replan_partitions(n_partitions: int, old_workers: int,
                      new_workers: int) -> ElasticPlan:
    """Contiguous-block ownership before and after; only the boundary blocks
    move.  The same plan reshards training state: leaves saved per shard
    group are re-gathered by `checkpoint.load_checkpoint(shardings=new)`."""
    old_owner = partition_owners(n_partitions, old_workers)
    new_owner = partition_owners(n_partitions, new_workers)
    moved = int(np.sum(new_owner != old_owner))
    return ElasticPlan(n_partitions, old_workers, new_workers,
                       new_owner, moved=moved)


def resize_labels(part: np.ndarray, new_partitions: int) -> np.ndarray:
    """Re-label a vertex->partition assignment from k to k' partitions.

    Shrink merges contiguous old partitions (``p -> p*k'//k`` — the same
    contiguous-block arithmetic as :func:`replan_partitions`, so only
    boundary blocks change meaning).  Grow splits each old partition among
    its contiguous children ``[p*k'//k, (p+1)*k'//k)``, dividing the
    partition's vertices (ascending global id, the builder's slot order)
    into equal contiguous runs.  Deterministic, vertex-level, and needs no
    edge data — which is what lets ``repro_torch.io.resize`` re-spill a
    ``.ghp`` without a rebuild from edge lists."""
    part = np.asarray(part)
    k = int(part.max()) + 1 if part.size else 1
    kp = int(new_partitions)
    if kp < 1:
        raise ValueError(f"new_partitions must be >= 1, got {kp}")
    if kp == k:
        return part.astype(np.int32)
    if kp < k:                       # pure merge, vertex-count free
        merge = partition_owners(k, kp)
        return merge[part].astype(np.int32)
    # grow: split each old partition's vertex run among its children
    new_part = np.zeros(part.shape, dtype=np.int32)
    children_lo = np.arange(k) * kp // k
    children_hi = (np.arange(k) + 1) * kp // k
    for p in range(k):
        vs = np.flatnonzero(part == p)       # ascending gid == slot order
        m = int(children_hi[p] - children_lo[p])
        if len(vs):
            new_part[vs] = (children_lo[p]
                            + (np.arange(len(vs)) * m) // len(vs))
    return new_part


def reshard_vertex_tree(leaves: dict[str, np.ndarray],
                        old_part: np.ndarray, new_part: np.ndarray,
                        pad_multiple: int = 8) -> dict[str, np.ndarray]:
    """Re-shard vertex-keyed ``(P, Vp, ...)`` checkpoint leaves from one
    partitioning to another.

    Both layouts follow the builder's slot rule (partition-major, ascending
    global id within a partition — :func:`core.graph._vertex_slots`), so
    the map is gather-by-vertex then scatter-by-new-slot.  Slots past a new
    partition's population keep the array's fill (zeros), which every
    engine path masks off via ``vertex_mask``.  Leaves whose leading dims
    are not the old ``(P, Vp)`` are returned untouched."""
    from repro_torch.core.graph import _vertex_slots

    old_part = np.asarray(old_part)
    new_part = np.asarray(new_part)
    if old_part.shape != new_part.shape:
        raise ValueError(f"labelings disagree on vertex count: "
                         f"{old_part.shape} vs {new_part.shape}")
    n = len(old_part)
    P_o, _, slot_o, Vp_o = _vertex_slots(old_part, n, pad_multiple)
    P_n, _, slot_n, Vp_n = _vertex_slots(new_part, n, pad_multiple)
    src = old_part.astype(np.int64) * Vp_o + slot_o     # (n,) old flat slot
    dst = new_part.astype(np.int64) * Vp_n + slot_n     # (n,) new flat slot
    out = {}
    for name, arr in leaves.items():
        arr = np.asarray(arr)
        if arr.ndim >= 2 and arr.shape[:2] == (P_o, Vp_o):
            flat = arr.reshape((P_o * Vp_o,) + arr.shape[2:])
            res = np.zeros((P_n * Vp_n,) + arr.shape[2:], dtype=arr.dtype)
            res[dst] = flat[src]
            out[name] = res.reshape((P_n, Vp_n) + arr.shape[2:])
        else:
            out[name] = arr
    return out
