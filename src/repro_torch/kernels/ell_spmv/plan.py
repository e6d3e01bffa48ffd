"""The block plan of a wide (K > 128) sliced-ELL tile: the occupied
128-slot fold blocks of each row, so the kernel reads no mask byte of an
all-padding block (``csrc/ell_spmv.cu``, the K > 128 path).

A plan depends on the mask alone, which never changes once a graph is
built, so the engines build one per bin and graph, before any CUDA-graph
capture, and keep it on the graph (``core.runtime.ell_plans``).  Building
one reads its entry count on the host, which a capture cannot do.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.common import FOLD_SLICES

__all__ = ["EllBlockPlan", "ell_block_plan", "stream_capturing"]


@dataclasses.dataclass(frozen=True)
class EllBlockPlan:
    """A CSR over fold blocks: row ``r``'s entries are ``ptr[r] ..
    ptr[r+1]``, each entry one fold block holding an occupied slot, in
    block order within the row (row-major over the tile).  ``row`` gives
    each entry's row to the L = 1 kernel, a warp per entry; ``bits`` its
    block's occupancy, bit i of word q for slot 32q + i of the block."""

    ptr: torch.Tensor        # (R + 1,) int32
    blk: torch.Tensor        # (nnzb,) int32 — the entry's fold block
    row: torch.Tensor        # (nnzb,) int32 — the entry's row
    bits: torch.Tensor       # (nnzb, 4) int32 — the block's occupied slots
    nnzb: int                # entries: the tile's occupied fold blocks
    shape: tuple[int, int]   # (R, K) of the mask it was built from

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.ptr, self.blk, self.row, self.bits))


def stream_capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (never where
    PyTorch has no CUDA)."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def ell_block_plan(msk: torch.Tensor) -> EllBlockPlan:
    """The block plan of an (R, K) bool mask, K > 128, on its device.
    The last fold block of a row is ragged where K % 128 != 0.  Raises
    under a stream capture."""
    if msk.dim() != 2 or msk.dtype != torch.bool:
        raise ValueError(f"ell_block_plan: msk must be (R, K) bool, got "
                         f"{tuple(msk.shape)} {msk.dtype}")
    rows, k = msk.shape
    if k <= FOLD_SLICES:
        raise ValueError(f"ell_block_plan: K = {k}; only K > {FOLD_SLICES} "
                         f"tiles take a plan")
    if stream_capturing():
        raise RuntimeError("ell_block_plan: a plan cannot be built under a "
                           "stream capture (its entry count is read on the "
                           "host); build it before the capture")
    full = k // FOLD_SLICES
    occ = msk[:, :full * FOLD_SLICES].unflatten(1, (full, FOLD_SLICES)) \
        .any(-1)
    if k % FOLD_SLICES:
        occ = torch.cat([occ, msk[:, full * FOLD_SLICES:].any(-1, True)], 1)
    row, blk = occ.nonzero(as_tuple=True)
    ptr = torch.zeros(rows + 1, dtype=torch.int32, device=msk.device)
    ptr[1:] = occ.sum(1).cumsum(0)
    # each entry's 128 mask bytes (False past K), packed 32 to a word
    slot = blk[:, None] * FOLD_SLICES + torch.arange(
        FOLD_SLICES, device=msk.device)
    occupied = msk[row[:, None], slot.clamp(max=k - 1)] & (slot < k)
    words = (occupied.view(-1, 4, 32).to(torch.int64) << torch.arange(
        32, device=msk.device)).sum(-1)
    bits = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return EllBlockPlan(ptr=ptr, blk=blk.to(torch.int32),
                        row=row.to(torch.int32), bits=bits.to(torch.int32),
                        nnzb=len(blk), shape=(rows, k))
