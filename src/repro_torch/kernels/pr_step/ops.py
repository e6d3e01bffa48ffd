"""Wrapper of the fused incremental-PageRank pseudo-superstep kernel
(``csrc/pr_step.cu``)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import bind
from repro_torch.kernels.common import (LANE_LAUNCHES, LAUNCHES,
                                        check_ell_operands,
                                        check_rows, f32, fold_block,
                                        require_cuda_contiguous)
from repro_torch.kernels.pr_step.ref import fused_pr_step_ref

_ARGS = ([ctypes.c_void_p] * 10
         + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p])


def fused_pr_step(idx, val, msk, delta, send, rank, extra=None, *,
                  damping: float = 0.85, tol: float = 1e-4):
    """Fused PageRank pseudo-superstep -> (rank', d_in, send').

    ``extra`` carries the spill bins' pre-combined per-row contributions
    (zeros when omitted, still added, as the reference does).  With an
    (N, L) frontier ``delta`` every operand and output carries the
    trailing L axis.  ``damping`` and ``tol`` enter as float32, like the
    reference's weak-typed scalars.  CPU tensors go to the plain version;
    CUDA tensors launch the kernel, or raise.
    """
    lanes = check_ell_operands(idx, val, msk, delta, "fused_pr_step")
    rows_shape = idx.shape[:1] + delta.shape[1:]
    if extra is None:
        extra = torch.zeros(rows_shape, dtype=torch.float32,
                            device=delta.device)
    check_rows("fused_pr_step", delta.shape, torch.bool, delta.device,
               send=send)
    check_rows("fused_pr_step", rows_shape, torch.float32, delta.device,
               rank=rank, extra=extra)
    if idx.device.type == "cpu":
        return fused_pr_step_ref(idx, val, msk, delta, send, rank, extra,
                                 damping=damping, tol=tol)
    require_cuda_contiguous("fused_pr_step", idx, val, msk, delta, send,
                            rank, extra)
    rows, k = idx.shape
    rank_out = torch.empty(rows_shape, dtype=torch.float32,
                           device=delta.device)
    d_out = torch.empty_like(rank_out)
    send_out = torch.empty(rows_shape, dtype=torch.bool, device=delta.device)
    if rank_out.numel() == 0:
        return rank_out, d_out, send_out
    with torch.cuda.device(delta.device):
        rc = bind("pr_step", "graphhp_pr_step", _ARGS)(
            idx.data_ptr(), val.data_ptr(), msk.data_ptr(),
            delta.data_ptr(), send.data_ptr(), rank.data_ptr(),
            extra.data_ptr(), rank_out.data_ptr(), d_out.data_ptr(),
            send_out.data_ptr(), rows, delta.shape[0], k, max(lanes, 1),
            fold_block(k),
            f32(damping), f32(tol), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"pr_step launch failed with CUDA error {rc}")
    LAUNCHES["pr_step"] += 1
    if lanes > 1:
        LANE_LAUNCHES["pr_step"] += 1
    return rank_out, d_out, send_out
