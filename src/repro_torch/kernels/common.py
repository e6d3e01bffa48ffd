"""Shared kernel plumbing: the semiring table as torch ops, the slot-fold
block width every kernel and plain version shares, the launch counters, and
the host-side (numpy) sliced-ELL packers copied from
``repro.kernels.common``.

The reference's Pallas kernels tile the slot axis in blocks of
``bk = min(128, K)``: each block folds its slots sequentially from slot 0,
and the block partials fold left to right into the output.  The CUDA
kernels and their plain versions follow exactly that order (never a tree
or ``torch.sum``), which is what makes them bit-identical to the reference
and to each other for every semiring, ``add_mul`` included.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["minimum", "maximum", "SEMIRINGS", "SEMIRING_IDS", "MONOTONE_SEMIRINGS", "FOLD_SLICES",
           "semiring_improves", "fold_block", "slot_fold", "f32", "LAUNCHES",
           "LANE_LAUNCHES", "BIN_LAUNCHES", "reset_launches", "TripCount",
           "defer_launches", "unsettled", "settle_launches",
           "check_ell_operands",
           "check_rows", "require_cuda_contiguous", "ell_pack_numpy",
           "ell_bin_widths", "sliced_ell_pack_numpy"]


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum`` bit for bit (IEEE 754-2019 minimum): NaN propagates
    and -0.0 orders below +0.0.  ``torch.minimum`` leaves the signed-zero
    tie open, and on the CPU its answer depends on the tensor's length
    (vectorized or scalar loop)."""
    take_a = torch.logical_or(
        torch.logical_or(a < b, torch.isnan(a)),
        torch.logical_and(a == b, torch.signbit(a)))
    return torch.where(take_a, a, b)


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum`` bit for bit: NaN propagates, +0.0 above -0.0."""
    take_a = torch.logical_or(
        torch.logical_or(a > b, torch.isnan(a)),
        torch.logical_and(a == b, torch.logical_not(torch.signbit(a))))
    return torch.where(take_a, a, b)


#: ``name -> (⊕ combine, ⊗ times, ⊕-identity)``, the reference's table:
#: add_mul (+, ×, 0), min_add (min, +, +inf), max_add (max, +, -inf),
#: min_mul (min, ×, +inf), max_min (max, min, -inf).
SEMIRINGS = {
    "add_mul": (torch.add, torch.mul, 0.0),
    "min_add": (minimum, torch.add, float("inf")),
    "max_add": (maximum, torch.add, float("-inf")),
    "min_mul": (minimum, torch.mul, float("inf")),
    "max_min": (maximum, minimum, float("-inf")),
}

#: The integer each CUDA launcher takes for a semiring (``csrc/semiring.cuh``).
SEMIRING_IDS = {"add_mul": 0, "min_add": 1, "max_add": 2, "min_mul": 3,
                "max_min": 4}

# ⊕ is a selection (min/max): state evolves monotonically under it, the
# contract of the fused `min_step` pseudo-superstep
MONOTONE_SEMIRINGS = frozenset({"min_add", "min_mul", "max_add", "max_min"})

#: Slot-block width of the reference's fold order (``block_slices``).
FOLD_SLICES = 128

#: Kernel launches per wrapper; each wrapper adds one where it launches its
#: CUDA kernel and nowhere else (the plain versions do not count).  Inside a
#: captured loop a wrapper's Python body runs once, at capture, while its
#: kernel runs once a trip: such launches are counted by :class:`TripCount`
#: and land here at the next host read (:func:`settle_launches`).
#: ``graph_loop`` counts the loop's set-condition kernel.
LAUNCHES = {"ell_spmv": 0, "min_step": 0, "pr_step": 0, "graph_loop": 0}
# the launches of LAUNCHES that took an (N, L) frontier with L > 1 (the
# K-lane programs' queries), counted at the same place; ell_spmv's also by
# bin, under "ell_spmv <rows>x<K>" (a key appears at its first launch)
LANE_LAUNCHES = {"ell_spmv": 0, "min_step": 0, "pr_step": 0}
# ell_spmv's other launches (an (N,) frontier) by bin, "ell_spmv <rows>x<K>",
# counted at the same place (a key appears at its first launch)
BIN_LAUNCHES: dict[str, int] = {}


class TripCount:
    """The launches one trip of a captured loop body makes (``per_trip``,
    ``lane_per_trip``, ``bin_per_trip``, known at capture) and a device
    counter of the trips run (``trips``, () int64, advanced by the body
    itself)."""

    def __init__(self, device):
        self.trips = torch.zeros((), dtype=torch.int64, device=device)
        self.per_trip: dict[str, int] = {}
        self.lane_per_trip: dict[str, int] = {}
        self.bin_per_trip: dict[str, int] = {}
        self.seen = 0          # trips already folded into LAUNCHES


# launched loops whose trips LAUNCHES does not hold yet, by id; each entry
# also keeps its loop (the owner of the graphs) alive until the device has
# passed it, which the next host read guarantees
_UNSETTLED: dict[int, tuple[TripCount, object]] = {}


def defer_launches(count: TripCount, owner: object) -> None:
    """Count ``count``'s trips at the next host read."""
    _UNSETTLED[id(count)] = (count, owner)


def unsettled(device) -> list[TripCount]:
    """The trip counters on ``device`` whose launches are not counted yet."""
    return [c for c, _ in _UNSETTLED.values() if c.trips.device == device]


def settle_launches(counts: list[TripCount], trips: list[int]) -> None:
    """Fold ``counts`` into LAUNCHES, given their device counters' values
    (read by the caller, in one transfer with whatever it reads)."""
    for c, n in zip(counts, trips):
        new, c.seen = n - c.seen, n
        for k, m in c.per_trip.items():
            LAUNCHES[k] += new * m
        for k, m in c.lane_per_trip.items():
            LANE_LAUNCHES[k] = LANE_LAUNCHES.get(k, 0) + new * m
        for k, m in c.bin_per_trip.items():
            BIN_LAUNCHES[k] = BIN_LAUNCHES.get(k, 0) + new * m
        _UNSETTLED.pop(id(c), None)


def reset_launches() -> None:
    """Zero the counts, once the trips still unsettled are read."""
    counts = [c for c, _ in _UNSETTLED.values()]
    if counts:
        settle_launches(counts, [int(c.trips) for c in counts])
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in LANE_LAUNCHES:
        LANE_LAUNCHES[k] = 0
    BIN_LAUNCHES.clear()


def semiring_improves(semiring: str):
    """Strict-improvement predicate of a monotone semiring (< for the min
    family, > for the max family)."""
    if semiring not in MONOTONE_SEMIRINGS:
        raise ValueError(f"{semiring} has no improvement direction")
    return torch.lt if semiring.startswith("min") else torch.gt


def f32(v: float) -> float:
    """``v`` rounded to float32 — how the reference's weak-typed Python
    scalars (damping, tolerance) enter float32 arithmetic."""
    return float(np.float32(v))


def fold_block(k: int) -> int:
    """Slot-block width ``bk`` of a K-slot tile in the reference fold."""
    return min(FOLD_SLICES, k)


def slot_fold(n_slots: int, slot_values, combine, ident: float):
    """The reference kernels' fold: sequential within each ``bk``-slot
    block (pad slots past ``n_slots`` contribute the identity, as Pallas
    pads a ragged last block with masked slots), block partials folded
    left to right.  ``slot_values(ks)`` gives the (R, m[, L]) operands of
    the slots ``ks``, a strided slice of the slot axis.  Every block folds
    its k-th slot in the same step, so a row of B blocks costs
    ``bk + B - 1`` combines of (R, B[, L]) tiles instead of ``B * bk`` of
    (R[, L]) ones: the same operations in the same order per element."""
    bk = fold_block(n_slots)
    last = n_slots - (-(-n_slots // bk) - 1) * bk   # slots of the last block
    part = None
    for k in range(bk):
        v = slot_values(slice(k, n_slots, bk))
        if k >= last:                       # the last block is past its end
            v = torch.cat([v, torch.full_like(v[:, :1], ident)], dim=1)
        part = v if part is None else combine(part, v)
    acc = part[:, 0]
    for b in range(1, part.shape[1]):
        acc = combine(acc, part[:, b])
    return acc


def check_ell_operands(idx, val, msk, x, name: str):
    """Validate an ELL tile + frontier pair; returns the lane count L (0
    for an (N,) frontier)."""
    if idx.dim() != 2 or idx.dtype != torch.int32:
        raise ValueError(f"{name}: idx must be (R, K) int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if val.shape != idx.shape or val.dtype != torch.float32:
        raise ValueError(f"{name}: val must be {tuple(idx.shape)} float32")
    if msk.shape != idx.shape or msk.dtype != torch.bool:
        raise ValueError(f"{name}: msk must be {tuple(idx.shape)} bool")
    if x.dim() not in (1, 2) or x.dtype != torch.float32:
        raise ValueError(f"{name}: frontier must be (N,) or (N, L) float32")
    for t in (val, msk, x):
        if t.device != idx.device:
            raise ValueError(f"{name}: operands on {idx.device} and "
                             f"{t.device}")
    return x.shape[1] if x.dim() == 2 else 0


def check_rows(name: str, shape, dtype, device, **tensors):
    """Row or frontier operands: each of ``tensors`` must be ``dtype`` of
    ``shape`` on ``device``."""
    for key, t in tensors.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or \
                t.device != device:
            raise ValueError(f"{name}: {key} must be {tuple(shape)} {dtype} on "
                             f"{device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")


def require_cuda_contiguous(name: str, *tensors) -> None:
    """A kernel takes CUDA tensors in row-major contiguous layout only."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: operands must lie on cpu or cuda, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def ell_pack_numpy(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                   n_rows: int, k_slices: int):
    """Vectorized destination-major ELL pack (host-side, numpy): slot k of
    row d holds the k-th edge of destination d in stable dst-sorted input
    order.  Returns (idx (n_rows, k_slices) int32, val float32, msk bool)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    w = np.asarray(w, dtype=np.float32)
    idx = np.zeros((n_rows, k_slices), dtype=np.int32)
    val = np.zeros((n_rows, k_slices), dtype=np.float32)
    msk = np.zeros((n_rows, k_slices), dtype=bool)
    if len(dst) == 0:
        return idx, val, msk
    order = np.argsort(dst, kind="stable")
    src_s, dst_s, w_s = src[order], dst[order], w[order]
    slot = np.arange(len(dst_s)) - np.searchsorted(dst_s, dst_s, side="left")
    idx[dst_s, slot] = src_s
    val[dst_s, slot] = w_s
    msk[dst_s, slot] = True
    return idx, val, msk


def ell_bin_widths(kmax: int, base_slices: int, pad: int,
                   growth: int = 8, max_bins: int = 3) -> list[tuple[int, int]]:
    """Slot ranges ``(lo, kb)`` of the sliced-ELL degree bins for a row set
    whose maximum in-degree is ``kmax``: bin 0 holds slots [0, K0) of every
    row, spill bins the overflow slots of the high-degree rows only, with
    geometrically growing widths and an unbounded last bin."""
    if kmax <= 0:
        return []
    rup = lambda n: ((n + pad - 1) // pad) * pad if n > 0 else pad
    base = rup(base_slices)
    if rup(kmax) <= base:
        return [(0, rup(kmax))]
    bins = [(0, base)]
    lo = base
    while kmax > lo:
        kb = rup(kmax - lo)
        if len(bins) < max_bins - 1:
            kb = min(kb, rup(base * growth ** len(bins)))
        bins.append((lo, kb))
        lo += kb
    return bins


def sliced_ell_pack_numpy(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                          n_rows: int, widths: list[tuple[int, int]],
                          order_rank: tuple[np.ndarray, np.ndarray] | None
                          = None,
                          extras: tuple[np.ndarray, ...] = ()):
    """Pack a destination-major edge set into sliced-ELL degree bins
    (``widths`` from :func:`ell_bin_widths`).  Bin 0 is dense over all
    ``n_rows``; spill bins carry only the rows whose degree exceeds their
    ``lo``.  ``order_rank`` optionally supplies the stable dst argsort and
    per-edge rank within its destination run; ``extras`` are per-edge int
    payloads packed into the same slots (zero on padding).

    Returns ``[(rows (nb,) int32 | None, idx (nb, kb) int32, val f32,
    msk bool, *extras)]`` per bin."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    w = np.asarray(w, dtype=np.float32)
    if order_rank is None:
        order = np.argsort(dst, kind="stable")
        rank = None
    else:
        order, rank = order_rank
    src_s, dst_s, w_s = src[order], dst[order], w[order]
    extras_s = tuple(np.asarray(e, dtype=np.int64)[order] for e in extras)
    if rank is None:
        rank = (np.arange(len(dst_s))
                - np.searchsorted(dst_s, dst_s, side="left"))
    degree = np.zeros(n_rows, dtype=np.int64)
    if len(dst_s):
        np.add.at(degree, dst_s, 1)

    out = []
    for lo, kb in widths:
        sel = (rank >= lo) & (rank < lo + kb)
        if lo == 0:
            rows = None
            nb = n_rows
            r = dst_s[sel]
        else:
            rows = np.nonzero(degree > lo)[0].astype(np.int32)
            row_of = np.zeros(n_rows, dtype=np.int64)
            row_of[rows] = np.arange(len(rows))
            nb = len(rows)
            r = row_of[dst_s[sel]]
        idx = np.zeros((nb, kb), dtype=np.int32)
        val = np.zeros((nb, kb), dtype=np.float32)
        msk = np.zeros((nb, kb), dtype=bool)
        ext = tuple(np.zeros((nb, kb), dtype=np.int32) for _ in extras_s)
        s = rank[sel] - lo
        idx[r, s] = src_s[sel]
        val[r, s] = w_s[sel]
        msk[r, s] = True
        for packed, e in zip(ext, extras_s):
            packed[r, s] = e[sel]
        out.append((rows, idx, val, msk) + ext)
    return out
