"""Plain PyTorch version of the fused incremental-PageRank pseudo-superstep,
in the kernel's fold and multiply order (bit-identical to the CUDA kernel
and to the reference's Pallas kernel)."""

from __future__ import annotations

import torch

from repro_torch.kernels.common import f32, slot_fold


def fused_pr_step_ref(idx, val, msk, delta, send, rank, extra, *,
                      damping: float = 0.85, tol: float = 1e-4):
    """-> (rank', d_in, send') with
    d_in = Σ_k msk ? (float32(damping)·val)·(send[s] ? delta[s] : 0) : 0
    (+ extra), rank' = rank + d_in, send' = d_in > float32(tol)."""
    col = (lambda a: a[..., None]) if delta.dim() == 2 else (lambda a: a)
    dval = f32(damping) * val

    def slots(ks):
        s = idx[:, ks]
        contrib = torch.where(send[s], delta[s], 0.0)
        return torch.where(col(msk[:, ks]), col(dval[:, ks]) * contrib, 0.0)

    acc = slot_fold(idx.shape[1], slots, torch.add, 0.0) \
        if idx.shape[1] else torch.zeros(rank.shape, dtype=torch.float32,
                                         device=rank.device)
    d_in = acc + extra
    return rank + d_in, d_in, d_in > f32(tol)
