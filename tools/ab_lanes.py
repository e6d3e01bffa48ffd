#!/usr/bin/env python3
"""A/B of the (N, L) lane paths of ``min_step`` and ``ell_spmv`` on one
NVIDIA GPU.

    python3 tools/ab_lanes.py [--lanes 4 16 64] [--no-rmat]

Builds ``src/repro_torch/csrc/{min_step,ell_spmv}.cu`` three ways into
``build/ab_lanes/``, with the package's nvcc flags:

* ``thread``: ``kLaneChunks`` false, so every (N, L) launch takes the
  thread-per-(row, lane) kernel (the design before the lane-chunk path);
* ``l1``: the lane-chunk path with its row loads from L1
  (``kStageChunksMax`` 0);
* ``staged``: the lane-chunk path staging a warp's rows in shared memory
  wherever it can (``kStageChunksMax`` 32): mask and idx for
  ``min_step``, mask, idx and val in one round for ``ell_spmv``.

and launches each through ctypes with the wrappers' C signatures on the
smoke's operands (``chip_smoke.grid_sssp_graph``: the SSSP grid's local
base bin, 4,194,304 x 8): ``min_step`` (min_add, x = xrow, extra = +inf,
half the send flags set) and ``ell_spmv`` (min_add) at each ``--lanes``;
unless ``--no-rmat``, also ``ell_spmv`` (add_mul) on the R-MAT 2^21
PageRank local base bin (2,307,072 x 16) at L = 16.  Every variant's
outputs must be bit-identical to the plain version's.  Device ms per call
as ``chip_smoke.device_ms`` takes it (a replayed CUDA graph, operands
cold in L2), in the order thread, l1, staged, staged, l1, thread; the
bound as ``chip_smoke._bound_ms`` counts it.  The last line is one JSON
object with every number and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

VARIANTS = {"thread": ("kLaneChunks", "false"),
            "l1": ("kStageChunksMax", "0"),
            "staged": ("kStageChunksMax", "32")}
ORDER = ("thread", "l1", "staged", "staged", "l1", "thread")
SOURCES = ("min_step", "ell_spmv")


def build_variants(out: str) -> dict:
    """{variant: {kernel: CDLL}}; raises with nvcc's output on a failure."""
    from repro_torch.kernels.build import CSRC
    from variant_build import build_variants as build
    return build(out, {(name, src): (str(CSRC), [("ell_row.cuh", const, value)])
                       for name, (const, value) in VARIANTS.items()
                       for src in SOURCES})


def launchers(libs):
    """{variant: (min_step(idx, val, msk, x, send, xrow, extra, sr),
    ell_spmv(idx, val, msk, x, sr))}, each allocating its outputs as the
    wrapper does."""
    import torch
    from repro_torch.kernels.common import SEMIRING_IDS, fold_block
    from repro_torch.kernels.ell_spmv.ops import _ARGS as SPMV_ARGS
    from repro_torch.kernels.ell_spmv.ops import plan_args
    from repro_torch.kernels.min_step.ops import _ARGS as MIN_ARGS

    out = {}
    for name, lib in libs.items():
        fm = lib["min_step"].graphhp_min_step
        fm.argtypes, fm.restype = MIN_ARGS, ctypes.c_int
        fs = lib["ell_spmv"].graphhp_ell_spmv
        fs.argtypes, fs.restype = SPMV_ARGS, ctypes.c_int

        def min_step(idx, val, msk, x, send, xrow, extra, sr, fm=fm):
            rows, k = idx.shape
            x_out = torch.empty(xrow.shape, device=x.device)
            d_out = torch.empty_like(x_out)
            s_out = torch.empty(xrow.shape, dtype=torch.bool, device=x.device)
            rc = fm(SEMIRING_IDS[sr], idx.data_ptr(), val.data_ptr(),
                    msk.data_ptr(), x.data_ptr(), send.data_ptr(),
                    xrow.data_ptr(), extra.data_ptr(), x_out.data_ptr(),
                    d_out.data_ptr(), s_out.data_ptr(), rows, x.shape[0], k,
                    x.shape[1], fold_block(k),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"min_step: CUDA error {rc}")
            return x_out, d_out, s_out

        def ell_spmv(idx, val, msk, x, sr, fs=fs):
            rows, k = idx.shape
            y = torch.empty((rows, x.shape[1]), device=x.device)
            rc = fs(SEMIRING_IDS[sr], idx.data_ptr(), val.data_ptr(),
                    msk.data_ptr(), x.data_ptr(), y.data_ptr(), rows,
                    x.shape[0], k, x.shape[1], fold_block(k),
                    torch.cuda.current_stream().cuda_stream,
                    *plan_args(None))          # K <= 128: no block plan
            if rc:
                raise RuntimeError(f"ell_spmv: CUDA error {rc}")
            return y

        out[name] = (min_step, ell_spmv)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, nargs="+", default=[4, 16, 64])
    ap.add_argument("--no-rmat", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core.runtime import slice_flat
    from repro_torch.kernels.ell_spmv import ell_spmv_ref
    from repro_torch.kernels.min_step import fused_min_step_ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    fns = launchers(build_variants(os.path.join(ROOT, "build", "ab_lanes")))
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows_out = []

    def ab(label, call_of, ops, ref, bound):
        """Every variant bit-identical to ``ref(*ops)``, then timed."""
        want = ref(*ops)
        for name in VARIANTS:
            if not cs._same(call_of(name)(*ops), want):
                raise AssertionError(f"{label}: {name} != plain version")
        del want
        ms = {name: [] for name in VARIANTS}
        for name in ORDER:
            ms[name].append(cs.device_ms(call_of(name), ops, bound[2], 20))
        row = dict(case=label, bound_ms=bound[0], bound_by=bound[1],
                   bytes=bound[2], device_ms=ms)
        print(json.dumps(row), flush=True)
        rows_out.append(row)

    graph, _, _ = cs.grid_sssp_graph()
    s = graph.local_ell[0]
    _, idx, msk = slice_flat(s, graph, graph.n_partitions)
    val = s.val.reshape(-1, s.kb)
    for L in args.lanes:
        x = torch.rand((idx.shape[0], L), generator=gen, device="cuda") * 100
        send = torch.rand(x.shape, generator=gen, device="cuda") < 0.5
        extra = torch.full_like(x, float("inf"))
        shape = f"sssp local base {tuple(idx.shape)}, L={L}"
        ab(f"min_step {shape}",
           lambda n: lambda *a: fns[n][0](*a, "min_add"),
           (idx, val, msk, x, send, x, extra),
           lambda *a: fused_min_step_ref(*a, semiring="min_add"),
           cs._bound_ms(msk, idx, 17 * L, 2, flag=send, x_is_row=True,
                        lanes=L))
        ab(f"ell_spmv min_add {shape}",
           lambda n: lambda *a: fns[n][1](*a, "min_add"),
           (idx, val, msk, x),
           lambda *a: ell_spmv_ref(*a, semiring="min_add"),
           cs._bound_ms(msk, idx, 4 * L, 2, lanes=L))
        del x, send, extra
    del graph, s, idx, msk, val
    torch.cuda.empty_cache()
    if not args.no_rmat:
        from repro_torch import IncrementalPageRank
        graph, _, _, _ = cs.rmat_pagerank_graph()
        prog = IncrementalPageRank(tolerance=cs.PR_TOL)
        s = graph.local_ell[0]
        _, idx, msk = slice_flat(s, graph, graph.n_partitions)
        val = prog.ell_edge_values(prog.channels[0], s.val).reshape(-1, s.kb)
        L = 16
        d = torch.rand((idx.shape[0], L), generator=gen, device="cuda") * 1e-3
        sent = torch.rand(d.shape, generator=gen, device="cuda") < 0.5
        x = torch.where(sent, d, 0.0).contiguous()
        ab(f"ell_spmv add_mul pagerank local base {tuple(idx.shape)}, L={L}",
           lambda n: lambda *a: fns[n][1](*a, "add_mul"),
           (idx, val, msk, x),
           lambda *a: ell_spmv_ref(*a, semiring="add_mul"),
           cs._bound_ms(msk, idx, 4 * L, 2, lanes=L))
    print(smi)
    print(json.dumps(dict(card=smi, order=ORDER, rows=rows_out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
