"""Wrapper of the fused monotone-semiring pseudo-superstep kernel
(``csrc/min_step.cu``)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import bind
from repro_torch.kernels.common import (LANE_LAUNCHES, LAUNCHES,
                                        MONOTONE_SEMIRINGS,
                                        SEMIRING_IDS, SEMIRINGS,
                                        check_ell_operands, check_rows,
                                        fold_block, require_cuda_contiguous)
from repro_torch.kernels.min_step.ref import fused_min_step_ref

_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 10
         + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p])


def fused_min_step(idx, val, msk, x, send, xrow=None, extra=None, *,
                   semiring: str = "min_add"):
    """Fused monotone pseudo-superstep -> (x', d_in, send').

    ``semiring`` is any ``MONOTONE_SEMIRINGS`` entry; ``xrow`` defaults to
    ``x`` (rows and frontier share the vertex slot space, the engine case);
    ``extra`` (spill-bin partials) defaults to the ⊕ identity, which is
    still combined in, as the reference does.  With an (N, L) frontier
    every operand and output carries the trailing L axis.  CPU tensors go
    to the plain version; CUDA tensors launch the kernel, or raise.
    """
    if semiring not in MONOTONE_SEMIRINGS:
        raise ValueError(f"{semiring!r} is not a monotone semiring")
    lanes = check_ell_operands(idx, val, msk, x, "fused_min_step")
    if xrow is None:
        xrow = x
    rows_shape = idx.shape[:1] + x.shape[1:]
    if extra is None:
        extra = torch.full(rows_shape, SEMIRINGS[semiring][2],
                           dtype=torch.float32, device=x.device)
    check_rows("fused_min_step", x.shape, torch.bool, x.device, send=send)
    check_rows("fused_min_step", rows_shape, torch.float32, x.device,
               xrow=xrow, extra=extra)
    if idx.device.type == "cpu":
        return fused_min_step_ref(idx, val, msk, x, send, xrow, extra,
                                  semiring=semiring)
    require_cuda_contiguous("fused_min_step", idx, val, msk, x, send, xrow,
                            extra)
    rows, k = idx.shape
    x_out = torch.empty(rows_shape, dtype=torch.float32, device=x.device)
    d_out = torch.empty_like(x_out)
    send_out = torch.empty(rows_shape, dtype=torch.bool, device=x.device)
    if x_out.numel() == 0:
        return x_out, d_out, send_out
    with torch.cuda.device(x.device):
        rc = bind("min_step", "graphhp_min_step", _ARGS)(
            SEMIRING_IDS[semiring], idx.data_ptr(), val.data_ptr(),
            msk.data_ptr(), x.data_ptr(), send.data_ptr(), xrow.data_ptr(),
            extra.data_ptr(), x_out.data_ptr(), d_out.data_ptr(),
            send_out.data_ptr(), rows, x.shape[0], k, max(lanes, 1),
            fold_block(k),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"min_step launch failed with CUDA error {rc}")
    LAUNCHES["min_step"] += 1
    if lanes > 1:
        LANE_LAUNCHES["min_step"] += 1
    return x_out, d_out, send_out
