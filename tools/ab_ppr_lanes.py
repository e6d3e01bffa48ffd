#!/usr/bin/env python3
"""A/B of PPR serving's lane (L > 1) kernels on one NVIDIA GPU:
``pr_step``'s lane path and the wide (K >= 128) ``ell_spmv`` bins' lane
path, kernel by kernel and end to end.

    python3 tools/ab_ppr_lanes.py [--lanes 4 16 64] [--parent DIR]

Kernels.  Builds ``src/repro_torch/csrc/{pr_step,ell_spmv}.cu`` into
``build/ab_ppr_lanes/`` with the package's nvcc flags, as these variants,
each a copy of the sources with ``constexpr`` values set
(``tools/variant_build.py``):

* ``old``: the design before the lane redesign of these two kernels
  (``pr_step``: ``ell_row.cuh``'s ``kLaneChunks`` false, so every
  (N, L) launch takes the thread-per-(row, lane) kernel; ``ell_spmv``:
  ``kWideLanes`` 4, so a wide bin takes 4-lane chunks of scalar gathers,
  one pass over the mask per chunk);
* ``alt`` (``ell_spmv`` only): the alternative measured beside the
  design, ``kGroup`` 128 and ``kWideLanes`` 64, a whole fold block's
  products staged at once and up to 64 lanes a pass;
* ``new``: the sources as they stand;

and, with ``--parent DIR`` (the root of an unpacked ``git archive`` of
the parent commit), ``parent``: DIR's own sources.  Each is launched
through ctypes with the wrappers' C signatures on the smoke's operands
(``chip_smoke.rmat_pagerank_graph``, R-MAT 2^21 at P = 64): ``pr_step``
on the PageRank local base bin (2,307,072 x 16; delta, rank and send
flags as the smoke's kernel phase makes them, zero extra) and
``ell_spmv`` add_mul on the four spill bins (local 1,720 x 7,056 and
23,168 x 128, remote 115,672 x 128 and 15,992 x 29,168; half the
frontier's entries zero), at each ``--lanes``.  Every variant's outputs
must be bit-identical to the plain version's.  Device ms per call as
``chip_smoke.device_ms`` takes it (a replayed CUDA graph, operands cold in
L2), in the order parent, old, alt, new, new, alt, old, parent; the bound
as ``chip_smoke._bound_ms`` counts it.

End to end (with ``--parent``).  Serving's K = 16 R-MAT ppr batch (the
smoke's 16 seeds, tolerance ``chip_smoke.SERVE_PPR_TOL``) through
``ServeEngine.run``, the kernels of the parent's sources against this
tree's: between drains the package's loaded kernel libraries
(``repro_torch.kernels.build``) are swapped for the other tree's (its
Python differs only in a launch counter), and each drain runs on a fresh
engine, whose device-loop graph it captures with that tree's kernels.
Drains in the order parent, change, change, parent, twice, under the
device loop and then under ``host_loops()``; each gives seconds, the
graph build's seconds, local steps (``pr_step`` launches), global
iterations, and ms a local step and a global iteration without the
build, and must give the first drain's lanes bit for bit.  Then 1 and 3
global iterations of each tree under each loop in ``torch.profiler`` (a
fresh engine each, its graph built inside the window, since a graph
instantiated before the profiler started does not show its kernels):
device ms by kernel group (``tools/serve_loops.py``'s groups), a steady
iteration's device ms by group as the two profiles' difference over 2
(the build cancels), and which lane kernels ran: this tree's profiles
must show ``pr_step_walk_kernel`` and the wide lane path, the
parent's neither.

The last line is one JSON object with every number and the card's name
and power limit; it is also written to ``build/ab_ppr_lanes.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

SOURCES = ("pr_step", "ell_spmv")
# variant -> source -> the (file, constexpr, value) set in its copy
VARIANTS = {
    "old": {"pr_step": [("ell_row.cuh", "kLaneChunks", "false")],
            "ell_spmv": [("ell_spmv.cu", "kWideLanes", "4")]},
    "alt": {"ell_spmv": [("ell_spmv.cu", "kGroup", "128"),
                         ("ell_spmv.cu", "kWideLanes", "64")]},
    "new": {},
}
ORDER = ("parent", "old", "alt", "new", "new", "alt", "old", "parent")
# global iterations of the two profiles whose difference is a steady one
PROFILE_ITERS = (1, 3)
# the kernels of this tree's lane paths (add_mul instances)
NEW_KERNELS = ("pr_step_walk_kernel", "ell_block_rows_kernel<0, true>",
               "ell_warp_rows_kernel<0, 1, true>")


def build_libs(out: str, parent: str | None) -> dict:
    """{variant: {source: CDLL}}, every build in parallel; raises with
    nvcc's output on a failure."""
    from repro_torch.kernels.build import CSRC
    from variant_build import build_variants
    jobs = {(v, src): (str(CSRC), edits.get(src, ()))
            for v, edits in VARIANTS.items() for src in SOURCES
            if v == "new" or src in edits}
    if parent:
        pc = os.path.join(parent, "src", "repro_torch", "csrc")
        jobs.update({("parent", src): (pc, ()) for src in SOURCES})
    return build_variants(out, jobs)


def launchers(lib: dict, damping: float, tol: float):
    """(pr_step(idx, val, msk, delta, send, rank, extra), ell_spmv(idx,
    val, msk, x)) of one variant's libraries, allocating outputs as the
    wrappers do; None for a source the variant does not build."""
    import torch
    from repro_torch.kernels.common import SEMIRING_IDS, f32, fold_block
    from repro_torch.kernels.ell_spmv import ell_block_plan
    from repro_torch.kernels.ell_spmv.ops import _ARGS as SPMV_ARGS
    from repro_torch.kernels.ell_spmv.ops import plan_args
    from repro_torch.kernels.pr_step.ops import _ARGS as PR_ARGS

    fp = fs = None
    if "pr_step" in lib:
        fp = lib["pr_step"].graphhp_pr_step
        fp.argtypes, fp.restype = PR_ARGS, ctypes.c_int
    if "ell_spmv" in lib:
        fs = lib["ell_spmv"].graphhp_ell_spmv
        fs.argtypes, fs.restype = SPMV_ARGS, ctypes.c_int

    def pr_step(idx, val, msk, delta, send, rank, extra):
        rows, k = idx.shape
        rank_out = torch.empty(rank.shape, device=delta.device)
        d_out = torch.empty_like(rank_out)
        s_out = torch.empty(rank.shape, dtype=torch.bool, device=delta.device)
        rc = fp(idx.data_ptr(), val.data_ptr(), msk.data_ptr(),
                delta.data_ptr(), send.data_ptr(), rank.data_ptr(),
                extra.data_ptr(), rank_out.data_ptr(), d_out.data_ptr(),
                s_out.data_ptr(), rows, delta.shape[0], k, delta.shape[1],
                fold_block(k), f32(damping), f32(tol),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"pr_step: CUDA error {rc}")
        return rank_out, d_out, s_out

    plans = {}

    def ell_spmv(idx, val, msk, x):
        rows, k = idx.shape
        y = torch.empty((rows, x.shape[1]), device=x.device)
        # a wide bin's block plan, built once per bin (by shape: the cold
        # copies of a bin's mask are its mask; the parent's sources take no
        # plan and ignore these trailing arguments)
        if k > 128 and (rows, k) not in plans:
            plans[rows, k] = ell_block_plan(msk)
        rc = fs(SEMIRING_IDS["add_mul"], idx.data_ptr(), val.data_ptr(),
                msk.data_ptr(), x.data_ptr(), y.data_ptr(), rows, x.shape[0],
                k, x.shape[1], fold_block(k),
                torch.cuda.current_stream().cuda_stream,
                *plan_args(plans.get((rows, k))))
        if rc:
            raise RuntimeError(f"ell_spmv: CUDA error {rc}")
        return y

    return pr_step if fp else None, ell_spmv if fs else None


def kernels_ab(graph, prog, libs, lanes) -> list:
    """Every variant on every case: bit-identical to the plain version,
    then timed in ORDER."""
    import torch
    import chip_smoke as cs
    from repro_torch.core.runtime import slice_flat
    from repro_torch.kernels.ell_spmv import ell_spmv_ref
    from repro_torch.kernels.pr_step import fused_pr_step_ref

    kw = dict(damping=prog.damping, tol=prog.tol)
    fns = {v: launchers(lib, **kw) for v, lib in libs.items()}
    order = [v for v in ORDER if v in fns] or [*fns, *reversed(fns)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []

    def ab(label, which, ops, ref, bound):
        want = ref(*ops)
        built = [v for v in fns if fns[v][which]]
        for v in built:
            if not cs._same(fns[v][which](*ops), want):
                raise AssertionError(f"{label}: {v} != plain version")
        del want
        ms = {v: [] for v in built}
        for v in order:
            if v in ms:
                ms[v].append(cs.device_ms(fns[v][which], ops, bound[2], 20))
        row = dict(case=label, bound_ms=bound[0], bound_by=bound[1],
                   bytes=bound[2], device_ms=ms)
        print("[ab_ppr_lanes]", json.dumps(row), flush=True)
        out.append(row)

    p, vp = graph.n_partitions, graph.vp
    ch = prog.channels[0]
    base = graph.local_ell[0]
    _, bidx, bmsk = slice_flat(base, graph, p)
    bval = prog.ell_edge_values(ch, base.val).reshape(-1, base.kb)
    spills = [(edges, b, s, n_src)
              for edges, slices, n_src in (
                  ("local", graph.local_ell, p * vp),
                  ("remote", graph.remote_ell, p * (vp + graph.hp)))
              for b, s in enumerate(slices) if not s.dense]
    for L in lanes:
        rows = bidx.shape[0]
        dl = torch.rand((rows, L), generator=gen, device="cuda") * 1e-3
        rl = torch.rand((rows, L), generator=gen, device="cuda")
        sl = torch.rand((rows, L), generator=gen, device="cuda") < 0.5
        ab(f"pr_step pagerank local base {tuple(bidx.shape)}, L={L}", 0,
           (bidx, bval, bmsk, dl, sl, rl, torch.zeros_like(dl)),
           lambda *a: fused_pr_step_ref(*a, **kw),
           cs._bound_ms(bmsk, bidx, 17 * L, 3, flag=sl, lanes=L))
        del dl, rl, sl
        for edges, b, s, n_src in spills:
            _, idx, msk = slice_flat(s, graph, p)
            val = prog.ell_edge_values(ch, s.val).reshape(-1, s.kb)
            d = torch.rand((n_src, L), generator=gen, device="cuda") * 1e-3
            x = torch.where(torch.rand(d.shape, generator=gen,
                                       device="cuda") < 0.5, d, 0.0)
            ab(f"ell_spmv add_mul pagerank {edges} bin{b} "
               f"{tuple(idx.shape)}, L={L}", 1, (idx, val, msk, x),
               lambda *a: ell_spmv_ref(*a, semiring="add_mul"),
               cs._bound_ms(msk, idx, 4 * L, 2, lanes=L))
            del d, x
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def kernels_of(tree_libs: dict):
    """The package's wrappers launch ``tree_libs``' kernels inside."""
    from repro_torch.kernels import build
    saved = {k: build._LIBS.get(k) for k in tree_libs}
    build._LIBS.update(tree_libs)
    try:
        yield
    finally:
        for k, lib in saved.items():
            if lib is None:
                build._LIBS.pop(k, None)
            else:
                build._LIBS[k] = lib


def _fresh_engine(graph, seeds, **kw):
    """A new K-lane engine, once the last one's graphs and their pools are
    freed (a K = 16 ppr loop's graphs hold tens of GB)."""
    import gc

    import torch
    from repro_torch.kernels.common import reset_launches
    from repro_torch.serve import ServeEngine

    reset_launches()            # lets go of the loops it kept to count
    gc.collect()
    torch.cuda.empty_cache()
    return ServeEngine(graph, lane_widths=(len(seeds),), **kw)


def _drain(eng, seeds, host: bool) -> tuple[list, dict]:
    """One K-lane ppr batch of ``seeds`` through ``eng.run()``.  Its
    device-loop graph is built inside the drain (a batch's program is its
    own): ``build_s`` (warm-up step, capture, instantiate) is reported and
    left out of the ms a step and a global iteration."""
    import chip_smoke as cs
    import torch
    from repro_torch.exec.device_loop import BUILDS, host_loops, \
        reset_builds
    from repro_torch.kernels.common import LAUNCHES, reset_launches

    for s in seeds:
        eng.submit("ppr", s, tolerance=cs.SERVE_PPR_TOL)
    torch.cuda.synchronize()
    reset_launches()
    reset_builds()
    t = time.perf_counter()
    with host_loops() if host else contextlib.nullcontext():
        qs = eng.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    build = BUILDS["capture_s"] + BUILDS["instantiate_s"]
    steps, iters = LAUNCHES["pr_step"], qs[0].iterations
    return [q.result for q in qs], dict(
        loop="host" if host else "device", seconds=secs, build_s=build,
        loops_built=BUILDS["loops"], local_steps=steps, iterations=iters,
        ms_per_step=(secs - build) / max(steps, 1) * 1e3,
        ms_per_iteration=(secs - build) / max(iters, 1) * 1e3)


def _profile(graph, seeds, host: bool, iters: int) -> dict:
    """``iters`` global iterations of a fresh engine under
    ``torch.profiler`` (its device-loop graph built inside the window: the
    kernels of a graph instantiated before the profiler started do not
    show)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from serve_loops import kernel_group
    eng = _fresh_engine(graph, seeds, max_iters=iters)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        _, row = _drain(eng, seeds, host)
        wall = time.perf_counter() - t
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    groups: dict[str, float] = {}
    calls: dict[str, int] = {}
    for e in rows:
        g = kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
        calls[g] = calls.get(g, 0) + e.count
    busy = sum(groups.values()) / 1e3
    lane_kernels = sorted({e.key.split("(")[0] for e in rows
                           if kernel_group(e.key) in ("pr_step",
                                                      "ell_spmv_wide")})
    return dict(loop=row["loop"], iters=iters, wall_s=wall,
                build_s=row["build_s"], device_busy_s=busy,
                idle_share=1 - busy / wall, local_steps=row["local_steps"],
                device_ms=groups, calls=calls, lane_kernels=lane_kernels)


def _per_iteration(one: dict, many: dict) -> dict:
    """A steady iteration's device ms by group and its calls: the
    difference of two profiles of ``one["iters"]`` and ``many["iters"]``
    iterations, each with its graph build, over their difference."""
    n = many["iters"] - one["iters"]
    keys = set(one["device_ms"]) | set(many["device_ms"])
    return dict(
        loop=one["loop"],
        device_ms={g: (many["device_ms"].get(g, 0.0)
                       - one["device_ms"].get(g, 0.0)) / n for g in keys},
        calls={g: (many["calls"].get(g, 0) - one["calls"].get(g, 0)) / n
               for g in keys},
        wall_ms=(many["wall_s"] - many["build_s"]
                 - one["wall_s"] + one["build_s"]) / n * 1e3)


def end_to_end(graph, seeds, tree_libs: dict) -> dict:
    """Drains in the order parent, change, change, parent, twice, under
    each loop, each on a fresh engine; then profiles of 1 and 3
    iterations of each tree and loop, and a steady iteration from their
    difference."""
    import numpy as np

    rows, first = [], None
    for host in (False, True):
        for tree in ("parent", "change", "change", "parent") * 2:
            with kernels_of(tree_libs[tree]):
                lanes, row = _drain(_fresh_engine(graph, seeds), seeds, host)
            if first is None:
                first = lanes
            row.update(tree=tree, bit_identical=all(
                np.array_equal(a, b) for a, b in zip(lanes, first)))
            rows.append(row)
            print("[ab_ppr_lanes]", json.dumps(row), flush=True)
    profiles, steady = [], []
    for tree in ("parent", "change"):
        for host in (False, True):
            pair = []
            for iters in PROFILE_ITERS:
                with kernels_of(tree_libs[tree]):
                    prof = dict(tree=tree,
                                **_profile(graph, seeds, host, iters))
                print("[ab_ppr_lanes] profile", json.dumps(prof), flush=True)
                profiles.append(prof)
                pair.append(prof)
            it = dict(tree=tree, **_per_iteration(*pair))
            print("[ab_ppr_lanes] steady iteration", json.dumps(it),
                  flush=True)
            steady.append(it)
    shown = {t: {k for p in profiles if p["tree"] == t
                 for k in p["lane_kernels"]} for t in tree_libs}
    new_ran = {t: [n for n in NEW_KERNELS if any(n in k for k in shown[t])]
               for t in tree_libs}
    ok = (all(r["bit_identical"] for r in rows)
          and len(new_ran["change"]) == len(NEW_KERNELS)
          and not new_ran["parent"])
    return dict(drains=rows, profiles=profiles, steady_iteration=steady,
                new_kernels_seen=new_ran, ok=ok)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, nargs="+", default=[4, 16, 64])
    ap.add_argument("--parent", help="root of the parent commit's sources "
                    "(kernel variant `parent` and the end-to-end A/B)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    import chip_smoke as cs
    from repro_torch import IncrementalPageRank
    from repro_torch.kernels.build import load

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = build_libs(os.path.join(ROOT, "build", "ab_ppr_lanes"),
                      args.parent)
    graph, (pe, _, pn), _, _ = cs.rmat_pagerank_graph()
    prog = IncrementalPageRank(tolerance=cs.PR_TOL)
    kernels = kernels_ab(graph, prog, libs, args.lanes)
    torch.cuda.empty_cache()        # the serving engines' graphs need it
    out = dict(card=smi, order=[v for v in ORDER if v in libs],
               kernels=kernels)
    ok = True
    if args.parent:
        # the smoke's serving seeds (phase_serve)
        senders = np.flatnonzero(np.bincount(pe[:, 0], minlength=pn))
        seeds = np.random.default_rng(12).choice(
            senders, cs.SERVE_LANES, replace=False).tolist()
        change = {src: load(src) for src in SOURCES}
        e2e = end_to_end(graph, seeds, {"parent": libs["parent"],
                                        "change": change})
        out["end_to_end"] = e2e
        ok = e2e["ok"]
    out.update(ok=ok, seconds=time.perf_counter() - t0)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "ab_ppr_lanes.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(smi)
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
