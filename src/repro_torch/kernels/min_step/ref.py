"""Plain PyTorch version of the fused monotone-semiring pseudo-superstep,
in the kernel's fold order (bit-identical to the CUDA kernel and to the
reference's Pallas kernel)."""

from __future__ import annotations

import torch

from repro_torch.kernels.common import (SEMIRINGS, semiring_improves,
                                        slot_fold)


def fused_min_step_ref(idx, val, msk, x, send, xrow, extra, *,
                       semiring: str = "min_add"):
    """-> (x', d_in, send') with
    d_in = (⊕_k msk ∧ send[s] ? x[s] ⊗ val : ident) ⊕ extra,
    x' = xrow ⊕ d_in, send' = improves(d_in, xrow)."""
    combine, times, ident = SEMIRINGS[semiring]
    improves = semiring_improves(semiring)
    col = (lambda a: a[..., None]) if x.dim() == 2 else (lambda a: a)

    def slots(ks):
        s = idx[:, ks]
        cand = times(x[s], col(val[:, ks]))
        return torch.where(torch.logical_and(col(msk[:, ks]), send[s]),
                           cand, ident)

    acc = slot_fold(idx.shape[1], slots, combine, ident) \
        if idx.shape[1] else torch.full(xrow.shape, ident,
                                        dtype=torch.float32, device=x.device)
    d_in = combine(acc, extra)
    return combine(xrow, d_in), d_in, improves(d_in, xrow)
