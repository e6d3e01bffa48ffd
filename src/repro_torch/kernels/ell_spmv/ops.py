"""Wrapper of the sliced-ELL semiring SpMV kernel (``csrc/ell_spmv.cu``)
and the host COO -> ELL packer."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.build import bind
from repro_torch.kernels.common import (BIN_LAUNCHES, FOLD_SLICES,
                                        LANE_LAUNCHES, LAUNCHES,
                                        SEMIRING_IDS, SEMIRINGS,
                                        check_ell_operands, ell_pack_numpy,
                                        fold_block, require_cuda_contiguous)
from repro_torch.kernels.ell_spmv.plan import EllBlockPlan, ell_block_plan
from repro_torch.kernels.ell_spmv.ref import ell_spmv_ref

# the C launcher's arguments: the operands, then the block plan's (see
# plan_args)
_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 5
         + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
         + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
         + [ctypes.c_void_p] * 2)


def plan_args(plan: EllBlockPlan | None, part: torch.Tensor | None = None):
    """The launcher's trailing arguments: the plan's ptr, blk, row, nnzb,
    the L = 1 path's partials scratch ``part`` and the plan's bits; null
    pointers without a plan (K <= 128)."""
    if plan is None:
        return (None, None, None, 0, None, None)
    return (plan.ptr.data_ptr(), plan.blk.data_ptr(), plan.row.data_ptr(),
            plan.nnzb, None if part is None else part.data_ptr(),
            plan.bits.data_ptr())


def ell_spmv(idx, val, msk, x, *, semiring: str = "add_mul",
             plan: EllBlockPlan | None = None):
    """Semiring SpMV/SpMM: y[r] = ⊕_k val[r,k] ⊗ x[idx[r,k]] over the
    occupied slots, the ⊕ identity elsewhere.

    ``x`` is an (N,) frontier (returns (R,)) or an (N, L) stacked frontier
    of L lanes (returns (R, L); the edge tiles are shared by the lanes).
    CPU tensors go to the plain version (which ignores ``plan``); CUDA
    tensors launch the kernel on the current stream, or raise.  A tile of
    K > 128 slots reads only the fold blocks its block ``plan`` lists
    (:func:`~repro_torch.kernels.ell_spmv.plan.ell_block_plan` of ``msk``;
    the engines keep one per bin on the graph); without one this call
    builds it, which a stream capture refuses.
    """
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}")
    lanes = check_ell_operands(idx, val, msk, x, "ell_spmv")
    if idx.device.type == "cpu":
        return ell_spmv_ref(idx, val, msk, x, semiring=semiring)
    require_cuda_contiguous("ell_spmv", idx, val, msk, x)
    rows, k = idx.shape
    y = torch.empty(idx.shape[:1] + x.shape[1:], dtype=torch.float32,
                    device=x.device)
    if y.numel() == 0:
        return y
    part = None
    if k > FOLD_SLICES:
        if plan is None:
            plan = ell_block_plan(msk)
        elif plan.shape != (rows, k) or plan.ptr.device != idx.device:
            raise ValueError(f"ell_spmv: a plan of {plan.shape} on "
                             f"{plan.ptr.device} for a ({rows}, {k}) tile "
                             f"on {idx.device}")
        if lanes <= 1:
            part = torch.empty(plan.nnzb, dtype=torch.float32,
                               device=x.device)
    else:
        plan = None
    with torch.cuda.device(x.device):
        rc = bind("ell_spmv", "graphhp_ell_spmv", _ARGS)(
            SEMIRING_IDS[semiring], idx.data_ptr(), val.data_ptr(),
            msk.data_ptr(), x.data_ptr(), y.data_ptr(), rows, x.shape[0],
            k, max(lanes, 1), fold_block(k),
            torch.cuda.current_stream().cuda_stream, *plan_args(plan, part))
    if rc:
        raise RuntimeError(f"ell_spmv launch failed with CUDA error {rc}")
    LAUNCHES["ell_spmv"] += 1
    key = f"ell_spmv {rows}x{k}"
    if lanes > 1:
        LANE_LAUNCHES["ell_spmv"] += 1
        LANE_LAUNCHES[key] = LANE_LAUNCHES.get(key, 0) + 1
    else:
        BIN_LAUNCHES[key] = BIN_LAUNCHES.get(key, 0) + 1
    return y


def to_ell(edges: np.ndarray, n_rows: int,
           weights: np.ndarray | None = None,
           pad_rows: int = 8, pad_slices: int = 128, device=None):
    """Pack a COO edge list (src, dst) into destination-major ELL tensors
    on ``device`` (default ``cuda``; raises without a GPU unless
    ``"cpu"`` is passed).

    Returns (idx (R,K) int32, val (R,K) float32, msk (R,K) bool) with
    R = n_rows rounded up to ``pad_rows`` and K = the largest in-degree
    rounded up to a multiple of ``pad_slices``, at least ``pad_slices``;
    a row's slots hold its in-edges in input order.
    """
    device = resolve_device(device)
    edges = np.asarray(edges)
    if weights is None:
        weights = np.ones(len(edges), dtype=np.float32)
    indeg = np.bincount(edges[:, 1], minlength=n_rows)
    kmax = int(indeg.max()) if len(indeg) else 1
    K = max(pad_slices, ((kmax + pad_slices - 1) // pad_slices) * pad_slices)
    R = ((n_rows + pad_rows - 1) // pad_rows) * pad_rows
    return tuple(torch.from_numpy(a).to(device) for a in
                 ell_pack_numpy(edges[:, 0], edges[:, 1], weights, R, K))
