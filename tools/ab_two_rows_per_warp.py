#!/usr/bin/env python3
"""A/B of ``ell_spmv``'s two-rows-a-warp path on one NVIDIA GPU.

    python3 tools/ab_two_rows_per_warp.py [--rows 115672] [--n 2097152]

Builds ``src/repro_torch/csrc/ell_spmv.cu`` as it stands ("two") and a
copy whose K = 128 path always takes one row a warp ("one") into
``build/ab_two_rows/``, with the package's nvcc flags, and launches both
through ctypes with the wrapper's C signature on one synthetic add_mul bin
of ``--rows`` × 128 slots and an (N,) frontier.  A row's occupied slots are
a prefix of 1 to 87 slots (uniform, mean 44, about the 34 % occupancy of
the R-MAT 2^21 PageRank remote spill bin of 115,672 × 128).  Each timing is
the median of five CUDA-event windows of 30 back-to-back launches cycling
through three copies of the operands (cold in L2), in the order one, two,
two, one.  The two outputs must be bit-identical.  Prints one JSON line
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the C entry's choice of two rows a warp, replaced in the "one" variant
TWO_ROWS_IF = "if (lanes == 1 && rows >= many_rows)"


def build_variants(out: str) -> dict:
    from repro_torch.kernels.build import CSRC, NVCC_FLAGS, _nvcc
    os.makedirs(out, exist_ok=True)
    for f in CSRC.iterdir():
        if f.suffix == ".cuh":
            shutil.copy(f, out)
    src = (CSRC / "ell_spmv.cu").read_text()
    if src.count(TWO_ROWS_IF) != 1:
        raise RuntimeError("ell_spmv.cu no longer has the two-row switch")
    sources = {"two": src, "one": src.replace(TWO_ROWS_IF, "if (false)")}
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(out, f"ell_spmv_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out, f"lib_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=115672)
    ap.add_argument("--n", type=int, default=1 << 21)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.common import SEMIRING_IDS
    from repro_torch.kernels.ell_spmv.ops import _ARGS, plan_args

    libs = build_variants(os.path.join(ROOT, "build", "ab_two_rows"))
    fns = {}
    for name, lib in libs.items():
        fn = lib.graphhp_ell_spmv
        fn.argtypes, fn.restype = _ARGS, ctypes.c_int
        fns[name] = fn

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, k = args.rows, 128
    deg = torch.randint(1, 88, (rows, 1), generator=gen, device="cuda")
    sets = []
    for _ in range(3):
        idx = torch.randint(0, args.n, (rows, k), generator=gen,
                            device="cuda", dtype=torch.int32)
        val = torch.rand((rows, k), generator=gen, device="cuda")
        msk = (torch.arange(k, device="cuda")[None, :] < deg).contiguous()
        x = torch.rand((args.n,), generator=gen, device="cuda")
        sets.append((idx, val, msk, x))
    y = torch.empty((rows,), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(name, ops):
        idx, val, msk, x = ops
        rc = fns[name](SEMIRING_IDS["add_mul"], idx.data_ptr(),
                       val.data_ptr(), msk.data_ptr(), x.data_ptr(),
                       y.data_ptr(), rows, args.n, k, 1, k, stream,
                       *plan_args(None))       # K = 128: no block plan
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    outs = {}
    for name in fns:
        launch(name, sets[0])
        torch.cuda.synchronize()
        outs[name] = y.clone()
    if not torch.equal(outs["one"].view(torch.int32),
                       outs["two"].view(torch.int32)):
        raise AssertionError("one and two rows a warp differ")

    def time_ms(name, reps=30, windows=5):
        times = []
        for _ in range(windows):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(reps):
                launch(name, sets[i % len(sets)])
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / reps)
        return statistics.median(times)

    runs = [(name, time_ms(name)) for name in ("one", "two", "two", "one")]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(card=smi, rows=rows, slots=k,
                          nnz=int(deg.sum()), n=args.n,
                          ms={f"{i}:{n}": t for i, (n, t) in
                              enumerate(runs)})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
