"""Plain PyTorch version of the sliced-ELL semiring SpMV.

It follows the kernel's fold order (see ``kernels.common.slot_fold``), not
a ``torch.sum``, so it is bit-identical to the CUDA kernel and to the
reference's Pallas kernel for every semiring.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import SEMIRINGS, slot_fold


def ell_spmv_ref(idx, val, msk, x, *, semiring: str = "add_mul", plan=None):
    """y[r] = ⊕_k msk[r,k] ? val[r,k] ⊗ x[idx[r,k]] : ident, (R,) or (R, L).
    ``plan`` (the kernel's block plan) is ignored: every slot folds."""
    combine, times, ident = SEMIRINGS[semiring]
    col = (lambda a: a[..., None]) if x.dim() == 2 else (lambda a: a)
    if idx.shape[1] == 0:
        return torch.full(idx.shape[:1] + x.shape[1:], ident,
                          dtype=torch.float32, device=x.device)

    def slots(ks):
        v = times(col(val[:, ks]), x[idx[:, ks]])
        return torch.where(col(msk[:, ks]), v, ident)

    return slot_fold(idx.shape[1], slots, combine, ident)
