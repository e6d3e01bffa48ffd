#!/usr/bin/env python3
"""A/B of ``pr_step`` kernel designs on the PageRank main-path bin, one
NVIDIA GPU.

    python3 tools/ab_pr_step.py

Builds ``src/repro_torch/csrc/pr_step.cu`` as it stands ("rows": the rows
path, one row a thread; a warp walks its rows' 4-slot chunks up to the
highest occupied one, one chunk a pass; registers capped so 8 blocks fit
an SM; delta gathered beside the send flag) and variants of it, each a
textual change to a copy, into ``build/ab_pr_step/`` with the package's
nvcc flags:

* ``rows_cap6``, ``rows_uncapped``: registers capped for 6 blocks an SM,
  or not at all;
* ``rows_unrolled``: the warp's whole width summed at once, unrolled at 4,
  8 or 16 slots (uncapped);
* ``rows_full_width``: every warp walks all K slots;
* ``rows_flag_then_delta``: delta gathered only where the send flag is
  set, after the flag (one more dependent load, fewer gathers);
* ``rows_persistent``: as many blocks as the card holds at once, each
  warp walking rows a grid apart, in place of one pass;
* ``rows_stcs``: rank' and d_in by streaming (evict-first) stores;
* ``staged``: one row a thread, the warp's rows staged in shared memory
  (``ell_row.cuh``'s ``StagedRows``, ``kStageAdaptive``), gathers through
  ``PrStepSlots`` — the design of ``min_step``'s staged kernel;
* ``thread``: the thread-per-(row, lane) path, which every tile takes that
  the rows path does not.

Each is launched through ctypes with the wrapper's C signature on the base
bin of the R-MAT 2^21 PageRank graph that ``chip_smoke.py`` builds
(2,307,072 × 16), with the operands of its timed ``pr_step`` case: ranks
after ``run_hybrid``, delta = rank · 1e-3, half the send flags set, the
spill bins' ``extra``.  Every variant must be bit-identical to the plain
version.  Cold device time as ``chip_smoke.py``'s ``device_ms`` (a CUDA
graph of calls over operand copies that exceed L2, replayed; median of
five windows), and call by call as its ``ms``; after one untimed pass
over all variants, they run in order, then in reverse, so each has two
readings.  ``empty_device_ms``: the same
operands with no slot occupied, which leaves the streamed mask and row
operands and outputs, 33 bytes a row (one reading each).  Also reports
the bin's fill (rows by occupied slots, and quantiles of the occupied
slots of 32-row spans), and each K = 16 kernel's registers and stack
bytes from ptxas.  Last, as a diagnostic of where the bytes go, the rows
path again with the context's L2 fetch granularity set to 32 bytes, at
the default, and at 32 again (a helper built here; the package never
sets it).  Prints one JSON line with the card's name and power
limit and writes it to ``build/ab_pr_step.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

STAGED = r'''
template <int KT>
__global__ void pr_step_staged_kernel(const int* __restrict__ idx,
                                      const float* __restrict__ val,
                                      const unsigned char* __restrict__ msk,
                                      const float* __restrict__ delta,
                                      const unsigned char* __restrict__ send,
                                      const float* __restrict__ rank,
                                      const float* __restrict__ extra,
                                      float* __restrict__ rank_out,
                                      float* __restrict__ d_out,
                                      bool* __restrict__ send_out, int rows,
                                      float damping, float tol) {
  __shared__ StagedRows<KT> staged[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kThreads + (threadIdx.x & ~31);
  const int nrow = min(32, rows - r0);
  if (nrow <= 0) return;
  const int t = r0 + min(lane, nrow - 1);
  const float rk = rank[t];
  const float ex = extra[t];
  StagedRows<KT>& st = staged[threadIdx.x >> 5];
  const bool dense = st.template load<kStageAdaptive>(idx, val, msk, r0, nrow, lane);
  if (lane >= nrow) return;
  const float acc = fold_staged_row<kAddMul, KT>(
      st, lane, dense, true, idx + t * KT, val + t * KT,
      PrStepSlots<int>{delta, send, 1, 0, damping});
  const float d = __fadd_rn(acc, ex);
  rank_out[t] = __fadd_rn(rk, d);
  d_out[t] = d;
  send_out[t] = d > tol;
}

template <int KT>
void launch_staged(const Args& a) {
  pr_step_staged_kernel<KT><<<grid_for(a.rows), kThreads, 0, a.stream>>>(
      static_cast<const int*>(a.idx), static_cast<const float*>(a.val),
      static_cast<const unsigned char*>(a.msk), static_cast<const float*>(a.delta),
      static_cast<const unsigned char*>(a.send), static_cast<const float*>(a.rank),
      static_cast<const float*>(a.extra), static_cast<float*>(a.rank_out),
      static_cast<float*>(a.d_out), static_cast<bool*>(a.send_out),
      static_cast<int>(a.rows), a.damping, a.tol);
}

}  // namespace graphhp
'''

FULL_WIDTH = ("      if (w[q]) hi = q + 1;", "      hi = KT / 4;")
DELTA = ("g[j] = s.m[j] ? __ldg(delta + at[j])", "g[j] = f[j] ? __ldg(delta + at[j])")
CAP6 = ("constexpr int kRowBlocksPerSm = 8;", "constexpr int kRowBlocksPerSm = 6;")
UNCAPPED = ("__launch_bounds__(kThreads, kRowBlocksPerSm)", "__launch_bounds__(kThreads)")
PERSISTENT = (
    "  pr_step_rows_kernel<KT><<<grid_for(a.rows), kThreads, 0, a.stream>>>(",
    "  int dev = 0, sms = 0, per_sm = 0;\n"
    "  cudaGetDevice(&dev);\n"
    "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
    "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pr_step_rows_kernel<KT>,\n"
    "                                                kThreads, 0);\n"
    "  const unsigned blocks = std::min(grid_for(a.rows), static_cast<unsigned>(sms * per_sm));\n"
    "  pr_step_rows_kernel<KT><<<blocks, kThreads, 0, a.stream>>>(")
# the whole width that a warp's rows need summed at once, unrolled at 4, 8
# or 16 slots, in place of one chunk a pass
ROW_SUM = r'''template <int C, int KT>
__device__ __forceinline__ float row_sum(const unsigned (&w)[KT / 4], const int* ip,
                                         const float* vp,
                                         const PrStepSlots<int>& terms) {
  Slots<C> s;
#pragma unroll
  for (int q = 0; q < C / 4; ++q) s.unpack(w[q], 4 * q);
  s.load_occupied(ip, vp);
  float o[C];
  terms(s, o);
  float acc = o[0];
#pragma unroll
  for (int j = 1; j < C; ++j) acc = __fadd_rn(acc, o[j]);
  if constexpr (C < KT) acc = __fadd_rn(acc, 0.0f);
  return acc;
}

template <int KT>
__global__ void __launch_bounds__(kThreads)
pr_step_rows_kernel('''
CHUNK_LOOP_START = "    float acc = 0.0f;                      // KT empty slots sum to +0.0\n"
CHUNK_LOOP_END = "    if (need > 0 && need < KT / 4) acc = __fadd_rn(acc, 0.0f);\n"
UNROLLED_BODY = (
    "    float acc = 0.0f;\n"
    "    if (need == 1)\n"
    "      acc = row_sum<4, KT>(w, ip, vp, terms);\n"
    "    else if (need == 2)\n"
    "      acc = row_sum<8, KT>(w, ip, vp, terms);\n"
    "    else if (need > 2)\n"
    "      acc = row_sum<KT, KT>(w, ip, vp, terms);\n")
STCS = ("      rank_out[r] = __fadd_rn(rk, d);\n      d_out[r] = d;\n",
        "      __stcs(rank_out + r, __fadd_rn(rk, d));\n      __stcs(d_out + r, d);\n")


def unrolled(src: str) -> str:
    """``rows_unrolled``: the chunk loop replaced by one unrolled sum."""
    a, b = src.index(CHUNK_LOOP_START), src.index(CHUNK_LOOP_END)
    src = src[:a] + UNROLLED_BODY + src[b + len(CHUNK_LOOP_END):]
    head = ("template <int KT>\n__global__ void __launch_bounds__(kThreads, "
            "kRowBlocksPerSm)\npr_step_rows_kernel(")
    return src.replace(head, ROW_SUM)


# variant -> [(text of pr_step.cu, its replacement)], each text found once,
# or a function of the text
VARIANTS = {
    "rows": [],
    "rows_cap6": [CAP6],
    "rows_uncapped": [UNCAPPED],
    "rows_unrolled": unrolled,
    "rows_full_width": [FULL_WIDTH],
    "rows_flag_then_delta": [DELTA],
    "rows_persistent": [PERSISTENT],
    "rows_stcs": [STCS],
    "staged": [("}  // namespace graphhp\n", STAGED),
               ("    launch_rows<16>(a);", "    launch_staged<16>(a);"),
               ("    launch_rows<8>(a);", "    launch_staged<8>(a);")],
    "thread": [("fits && lanes == 1 && k_slots == 16 && mask_rows_aligned", "false"),
               ("fits && lanes == 1 && k_slots == 8 && mask_rows_aligned", "false")],
}


# Diagnostic only, built here and never in the package: the context's L2
# fetch granularity (cudaLimitMaxL2FetchGranularity), read, and set unless
# `bytes` is negative.
L2_FETCH = r'''
#include <cuda_runtime.h>
extern "C" int l2_fetch_granularity(int bytes, int* before) {
  size_t v = 0;
  int rc = static_cast<int>(cudaDeviceGetLimit(&v, cudaLimitMaxL2FetchGranularity));
  if (rc) return rc;
  *before = static_cast<int>(v);
  return bytes >= 0 ? static_cast<int>(
                          cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, bytes))
                    : 0;
}
'''


def build_variants(out: str) -> tuple[dict, dict]:
    """{variant: loaded library}, {variant: its kernels' registers}."""
    from repro_torch.kernels.build import CSRC, NVCC_FLAGS, _nvcc
    os.makedirs(out, exist_ok=True)
    for f in CSRC.iterdir():
        if f.suffix == ".cuh":
            shutil.copy(f, out)
    src = (CSRC / "pr_step.cu").read_text()
    procs = {}
    sources = {}
    for name, edits in VARIANTS.items():
        text = src
        if callable(edits):
            text = edits(text)
            edits = []
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: pr_step.cu no longer has {old!r}")
            text = text.replace(old, new)
        sources[name] = text
    sources["l2_fetch"] = L2_FETCH
    for name, text in sources.items():
        cu = os.path.join(out, f"pr_step_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out, f"lib_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs, regs = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
        regs[name] = registers_k16(log)
    return libs, regs


def registers_k16(log: str) -> dict:
    """{kernel: [registers, stack frame bytes]} of the K = 16 instances in
    a ptxas report."""
    out, entry, stack = {}, None, 0
    for line in log.splitlines():
        if "Compiling entry function '" in line:
            entry, stack = line.split("'")[1], 0
        elif "bytes stack frame" in line:
            stack = int(line.split("bytes stack frame")[0].split()[-1])
        elif "Used " in line and entry and "ILi16E" in entry:
            name = entry.split("graphhp")[1].lstrip("0123456789")
            out[name.split("ILi16E")[0] + "<16>"] = [
                int(line.split("Used ")[1].split(" ")[0]), stack]
    return out


def main_path_operands():
    """The PageRank base bin and the operands of ``chip_smoke.py``'s timed
    ``pr_step`` case."""
    import torch
    import chip_smoke
    from repro_torch import IncrementalPageRank, run_hybrid
    from repro_torch.exec.local_phase import _spill_extra, fused_step_fn

    graph, _, _ = chip_smoke.rmat_pagerank_graph()
    prog = IncrementalPageRank(tolerance=chip_smoke.PR_TOL)
    es, _ = run_hybrid(graph, prog)
    p = graph.n_partitions
    _, slices, views = fused_step_fn(graph, prog, "pr_step", p)
    _, idx, msk = views[0]
    val = slices[0].val.reshape(-1, slices[0].kb)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rank = es.state["rank"].contiguous()
    delta = (rank * 1e-3).contiguous()
    send = torch.rand(delta.shape, generator=gen, device="cuda") < 0.5
    ch = prog.channels[0]
    extra = _spill_extra(graph, prog, ch, slices, views, {ch.name: delta},
                         send, p)
    flat = [a.reshape(-1).contiguous() for a in (delta, send, rank)]
    return prog, (idx, val, msk, *flat, extra)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels.common import f32, fold_block
    from repro_torch.kernels.pr_step import fused_pr_step_ref
    from repro_torch.kernels.pr_step.ops import _ARGS

    libs, regs = build_variants(os.path.join(ROOT, "build", "ab_pr_step"))
    l2_fetch = libs.pop("l2_fetch").l2_fetch_granularity
    l2_fetch.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    l2_fetch.restype = ctypes.c_int
    regs.pop("l2_fetch")
    fns = {}
    for name, lib in libs.items():
        fn = lib.graphhp_pr_step
        fn.argtypes, fn.restype = _ARGS, ctypes.c_int
        fns[name] = fn

    prog, ops = main_path_operands()
    idx, val, msk, delta, send, rank, extra = ops
    rows, k = idx.shape
    kw = dict(damping=prog.damping, tol=prog.tol)
    want = fused_pr_step_ref(*ops, **kw)
    outs = tuple(torch.empty_like(t) for t in want)

    def call(name, *o):
        rc = fns[name](*(t.data_ptr() for t in o + outs), rows,
                       delta.shape[0], k, 1, fold_block(k), f32(kw["damping"]),
                       f32(kw["tol"]), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    for name in fns:
        for t in outs:
            t.fill_(7)
        call(name, *ops)
        chip_smoke.sync()
        if not chip_smoke._same(outs, want):
            raise AssertionError(f"{name} differs from the plain version")

    bound = chip_smoke._bound_ms(msk, idx, 17, 3, flag=send)
    for name in fns:                       # warm-up, untimed
        chip_smoke.device_ms(lambda *o, name=name: call(name, *o), ops,
                             bound[2], 20, windows=1)
    order = list(fns) + list(reversed(fns))
    readings = {name: dict(device_ms=[], ms=[]) for name in fns}
    for name in order:
        fn = lambda *o, name=name: call(name, *o)
        readings[name]["device_ms"].append(
            chip_smoke.device_ms(fn, ops, bound[2], 20))
        readings[name]["ms"].append(chip_smoke.time_ms(lambda: fn(*ops), 20))
    empty = (idx, val, torch.zeros_like(msk), *ops[3:])
    for name in fns:
        fn = lambda *o, name=name: call(name, *o)
        readings[name]["empty_device_ms"] = chip_smoke.device_ms(
            fn, empty, 33 * rows, 20)
    # the rows path again with a 32-byte L2 fetch granularity, then back
    default = ctypes.c_int(0)
    fetch = dict(rows_device_ms_by_granularity={})
    for gran in (32, -1, 32):
        if l2_fetch(gran, ctypes.byref(default)):
            raise RuntimeError("cudaDeviceSetLimit failed")
        chip_smoke.sync()
        fetch["rows_device_ms_by_granularity"].setdefault(
            str(gran) if gran > 0 else "default", []).append(
                chip_smoke.device_ms(lambda *o: call("rows", *o), ops,
                                     bound[2], 20))
        if gran > 0 and l2_fetch(default.value, ctypes.byref(ctypes.c_int(0))):
            raise RuntimeError("cudaDeviceSetLimit failed")
    fetch["default_bytes"] = default.value
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    fill = msk.sum(dim=1)
    steps = fill[:rows // 32 * 32].reshape(-1, 32).sum(dim=1).float()
    line = json.dumps(dict(card=smi, rows=rows, slots=k, nnz=bound[3],
                           occupied_rows=int((fill > 0).sum()),
                           row_fill=torch.bincount(fill, minlength=k + 1).tolist(),
                           step32_fill_q50_q90_q99_max=[
                               float(steps.quantile(q)) for q in (0.5, 0.9, 0.99)]
                           + [float(steps.max())],
                           bound_ms=bound[0], bound_bytes=bound[2],
                           registers=regs, readings=readings,
                           l2_fetch=fetch))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "ab_pr_step.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
