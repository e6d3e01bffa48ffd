#!/usr/bin/env python3
"""A/B of the wide (K > 128) ``ell_spmv`` bins' block plan on one NVIDIA
GPU, kernel by kernel.

    python3 tools/ab_wide_plan.py [--parent DIR]

Times ``new``, this tree's ``ell_spmv`` kernels as the package builds
them (``repro_torch.kernels.build``), and, with ``--parent DIR`` (the
root of an unpacked ``git archive`` of the parent commit), ``parent``:
DIR's own ``ell_spmv.cu``, built into ``build/ab_wide_plan/`` with the
package's nvcc flags (``tools/variant_build.py``), whose wide bins read
their whole mask.  Each is launched through ctypes with the wrapper's C
signature (the parent's ignores the block plan's trailing arguments) on
the smoke's R-MAT 2^21 PageRank operands
(``chip_smoke.rmat_pagerank_graph``, P = 64): ``ell_spmv`` add_mul on
every bin of both edge sides with an (N,) frontier (half its entries
zero, as the smoke's kernel phase makes it), and on the spill bins with
an (N, 16) frontier.  Every variant's output must be bit-identical to the
plain version's.  Device ms per call as ``chip_smoke.device_ms`` takes it
(a replayed CUDA graph, operands cold in L2; the plan, not an operand,
stays warm), in the order parent, new, new, parent.  Beside each case:
both bounds (``chip_smoke._bound_ms`` with and without the plan),
``torch.sparse.mm``'s device ms on the bin as a CSR matrix, each wide
bin's plan (entries, bytes, build seconds), and at L = 1 the occupied
slots' gathers and the distinct 32-byte sectors of the frontier they
touch.

The last line is one JSON object with every number and the card's name
and power limit; it is also written to ``build/ab_wide_plan.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

ORDER = ("parent", "new", "new", "parent")
LANES = (1, 16)


def build_libs(out: str, parent: str | None) -> dict:
    """{variant: CDLL of ell_spmv}: this tree's, and the parent's."""
    from repro_torch.kernels.build import load
    libs = {"new": load("ell_spmv")}
    if parent:
        from variant_build import build_variants
        pc = os.path.join(parent, "src", "repro_torch", "csrc")
        libs["parent"] = build_variants(
            out, {("parent", "ell_spmv"): (pc, ())})["parent"]["ell_spmv"]
    return libs


def launcher(lib):
    """ell_spmv(idx, val, msk, x, plan) through one variant's library,
    allocating the output and the L = 1 partials as the wrapper does."""
    import torch
    from repro_torch.kernels.common import SEMIRING_IDS, fold_block
    from repro_torch.kernels.ell_spmv.ops import _ARGS, plan_args

    fn = lib.graphhp_ell_spmv
    fn.argtypes, fn.restype = _ARGS, ctypes.c_int

    def ell_spmv(idx, val, msk, x, plan):
        rows, k = idx.shape
        lanes = x.shape[1] if x.dim() == 2 else 1
        y = torch.empty(idx.shape[:1] + x.shape[1:], device=x.device)
        part = None
        if plan is not None and lanes == 1:
            part = torch.empty(plan.nnzb, device=x.device)
        rc = fn(SEMIRING_IDS["add_mul"], idx.data_ptr(), val.data_ptr(),
                msk.data_ptr(), x.data_ptr(), y.data_ptr(), rows, x.shape[0],
                k, lanes, fold_block(k),
                torch.cuda.current_stream().cuda_stream,
                *plan_args(plan, part))
        if rc:
            raise RuntimeError(f"ell_spmv: CUDA error {rc}")
        return y

    return ell_spmv


def kernels_ab(graph, prog, libs) -> list:
    """Every variant on every case: bit-identical to the plain version,
    then timed in ORDER."""
    import torch
    import chip_smoke as cs
    from repro_torch.core.runtime import slice_flat
    from repro_torch.kernels.ell_spmv import ell_block_plan, ell_spmv_ref

    fns = {v: launcher(lib) for v, lib in libs.items()}
    order = [v for v in ORDER if v in fns]
    gen = torch.Generator(device="cuda").manual_seed(0)
    p, vp = graph.n_partitions, graph.vp
    ch = prog.channels[0]
    out = []
    for edges, slices, n_src in (
            ("local", graph.local_ell, p * vp),
            ("remote", graph.remote_ell, p * (vp + graph.hp))):
        for b, s in enumerate(slices):
            _, idx, msk = slice_flat(s, graph, p)
            val = prog.ell_edge_values(ch, s.val).reshape(-1, s.kb)
            plan, plan_row = None, {}
            if s.kb > 128:
                cs.sync()
                t = time.perf_counter()
                plan = ell_block_plan(msk)
                cs.sync()
                plan_row = dict(nnzb=plan.nnzb, plan_bytes=plan.nbytes,
                                plan_build_s=time.perf_counter() - t)
            for L in LANES if not s.dense else (1,):
                shape = (n_src, L) if L > 1 else (n_src,)
                d = torch.rand(shape, generator=gen, device="cuda") * 1e-3
                x = torch.where(torch.rand(shape, generator=gen,
                                           device="cuda") < 0.5, d, 0.0)
                ops = (idx, val, msk, x)
                want = ell_spmv_ref(*ops, semiring="add_mul")
                for v, fn in fns.items():
                    if not cs._same(fn(*ops, plan), want):
                        raise AssertionError(
                            f"{edges} bin{b} L={L}: {v} != plain version")
                del want
                bound = cs._bound_ms(msk, idx, 4 * L, 2, lanes=L, plan=plan)
                mask_bound = cs._bound_ms(msk, idx, 4 * L, 2, lanes=L)
                ms = {v: [] for v in fns}
                for v in order:
                    ms[v].append(cs.device_ms(
                        lambda *a, fn=fns[v]: fn(*a, plan), ops, bound[2],
                        5 if s.kb > 1024 else 20))
                csr = cs._csr_library(idx, val, msk, n_src)
                xl = x if L > 1 else x[:, None]
                lib_ms = cs.device_ms(torch.sparse.mm, (csr, xl), bound[2],
                                      5 if s.kb > 1024 else 20)
                row = dict(case=f"{edges} bin{b} {tuple(idx.shape)}, L={L}",
                           bound_ms=bound[0], bound_by=bound[1],
                           bytes=bound[2], mask_bound_ms=mask_bound[0],
                           library_device_ms=lib_ms, device_ms=ms,
                           **plan_row)
                if L == 1:
                    src = idx[msk].long()
                    row.update(gathers=src.numel(),
                               sectors=torch.unique(src // 8).numel())
                print("[ab_wide_plan]", json.dumps(row), flush=True)
                out.append(row)
                del d, x, ops, csr, xl
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the parent commit's sources "
                    "(variant `parent`)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import IncrementalPageRank

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = build_libs(os.path.join(ROOT, "build", "ab_wide_plan"),
                      args.parent)
    graph = cs.rmat_pagerank_graph()[0]
    prog = IncrementalPageRank(tolerance=cs.PR_TOL)
    out = dict(card=smi, order=[v for v in ORDER if v in libs],
               kernels=kernels_ab(graph, prog, libs),
               seconds=time.perf_counter() - t0)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "ab_wide_plan.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
