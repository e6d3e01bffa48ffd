"""The bytes of work a kernel call needs, and its share of the HBM roofline.

A copy of ``chip_smoke.py``'s ``_bound_ms`` reckoning, rewritten so that it
reads nothing but the call's operands: the bound does not depend on how the
kernel is built.  Counted once each: a mask byte a slot (for a wide bin,
K > 128, only what the work needs to find its occupied slots: a 4-byte row
pointer a row, and for each 128-slot fold block holding an occupied slot
its 4-byte index and 16 bytes of occupancy bits, plus its 4-byte row at
L = 1), the 4-byte index and value of each occupied slot, ``rows_bytes``
of row operands and outputs a row, and the frontier entries of the
distinct sources of occupied slots: a 4-byte value a lane, or for a fused
step a flag byte a lane and the value only where the flag is set (already
counted a row where the value vector is the row operand).  Against it the
operations, ``ops_per_slot`` a slot and lane, over the float32 rate.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): 3.35 TB/s
of HBM, 67 TFLOP/s float32 outside the tensor cores, at the full 700 W.
"""

from __future__ import annotations

import torch

__all__ = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "FOLD", "work_bytes",
           "bound_ms", "launch_weighted_share"]

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
FOLD = 128          # slots a fold block; bins wider than this are "wide"


def work_bytes(msk: torch.Tensor, idx: torch.Tensor, rows_bytes: int, *,
               flag: torch.Tensor | None = None, x_is_row: bool = False,
               lanes: int = 1) -> int:
    """Bytes one call over an (R, K) bin needs (see the module's text).
    ``flag`` is the fused step's (N,) or (N, L) send flags."""
    rows, k = msk.shape
    nnz = int(msk.sum())
    src = torch.unique(idx[msk]).long()
    if k > FOLD:
        blocks = -(-k // FOLD)
        pad = torch.zeros((rows, blocks * FOLD - k), dtype=torch.bool,
                          device=msk.device)
        nnzb = int(torch.cat([msk, pad], 1).reshape(rows, blocks, FOLD)
                   .any(-1).sum())
        mask_bytes = 4 * (rows + 1) + nnzb * (4 + 16 + (4 if lanes <= 1
                                                         else 0))
    else:
        mask_bytes = rows * k
    nbytes = mask_bytes + 8 * nnz + rows_bytes * rows
    if flag is None:
        nbytes += 4 * lanes * src.numel()
    else:
        nbytes += lanes * src.numel()
        if not x_is_row:
            nbytes += 4 * int(flag.reshape(flag.shape[0], -1)[src].sum())
    return nbytes


def bound_ms(nbytes: int, nnz: int, ops_per_slot: int, lanes: int = 1
             ) -> float:
    """The least ms for ``nbytes`` over the HBM rate and the operations
    over the float32 rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S,
               ops_per_slot * nnz * lanes / F32_OPS_PER_S) * 1e3


def launch_weighted_share(rows) -> float | None:
    """Σ launches x bound / Σ launches x device ms, in %, over rows with
    ``launches``, ``bound_ms`` and ``device_ms``; None where no row was
    launched."""
    den = sum(r["launches"] * r["device_ms"] for r in rows)
    if not den:
        return None
    return 100.0 * sum(r["launches"] * r["bound_ms"] for r in rows) / den
