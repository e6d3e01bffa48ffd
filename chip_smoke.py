#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of GraphHP on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero and prints no result):

1. device   — a CUDA device must exist; prints ``nvidia-smi``'s name and
              power limit.
2. build    — compiles the three CUDA kernels from ``src/repro_torch/csrc``
              with nvcc (one process per source, in parallel).
2a. sweep   — both ``ell_spmv`` paths (K = 7, 8, 16; 128; 300, 7,056,
              32,897), ``min_step`` (K = 7, 8, 16) and both ``pr_step``
              paths (K = 7, 8, 16, 300; aligned, one row and one element
              into a larger buffer) on synthetic tiles
              against their plain versions: every semiring, (N,), (N, 4)
              and (N, 6) frontiers,
              1 % / 50 % / 100 % occupancy and empty fold blocks between
              occupied ones, signed zeros, ±inf ties and NaN; bit-identical,
              NaN by position only.
3. graphs   — builds the two main-path graphs on the host and moves them
              to the card: SSSP on a 2048 x 2048 road-like grid (4,194,304
              vertices, 16,769,024 weighted edges, 8 x 8 geographic tiles,
              P = 64) and incremental PageRank on R-MAT 2^21 (avg degree
              8, fennel at P = 64, ``ell_base_slices=16`` so hubs spill into
              extra ELL bins, 1/out-degree weights).
4. main     — ``run_hybrid`` on each graph, with the kernel launch counts
              and host-read counts zeroed just before and read just after;
              prints iterations, paper counters, build and run seconds,
              peak device memory, host syncs and launches per kernel.
              Fails unless every kernel launched.
5. oracle   — SSSP against scipy's Dijkstra (rtol 1e-4: float32 sums
              over up to ~4,000 hops against float64), PageRank against a
              scipy power iteration (rtol 2e-3, atol 5e-3: Algorithm 5
              drops residuals <= tolerance at each receipt).
6. kernels  — every kernel's wrapper on the card at every shape the main
              path gave it, held bit-identical to its plain PyTorch version
              on the same CUDA tensors, and the engine's fused steps
              (``fused_step_fn``) against the same steps built over the
              plain versions; times the kernel and, where one PyTorch call
              computes the same function, that call (``library_ms``), each
              issued call by call from Python (``ms``, ``library_ms``) and
              as device time on cold operands (``device_ms``,
              ``library_device_ms``: a CUDA graph of a run of calls over
              copies of the operands, replayed), the plain version call by
              call, beside the bound the card's memory rate and float32
              rate set for the same work.
7. profile  — the first global iterations of each run again under
              ``torch.profiler``: device busy share and device time by
              kernel, ours and PyTorch's glue around them.
8. engines  — Hama and AM-Hama on both graphs: ``run_bsp`` and
              ``run_am`` (ELL) on the grid, their distances held bit for
              bit against ``run_hybrid``'s (a monotone fixed point does
              not depend on the engine); ``run_bsp``, ``run_am`` and
              ``run_bsp(use_ell=False)`` (the dense path at full size) on
              the R-MAT graph against the power-iteration oracle; one
              dense ``deliver(edges="all")`` on the R-MAT graph after
              ``init_state`` and an exchange (16.4 M edges, the hubs'
              in-degrees), card against host copies bit for bit — the
              ordered segment fold of the sum channel; and the paper's
              table of I, M and pseudo-supersteps for hybrid, BSP and AM
              on both graphs.  Each run counted like ``main`` (ELL BSP/AM
              must launch ``ell_spmv`` only).
9. apps     — WCC through ``run_hybrid`` on the grid against scipy's
              connected components (exact labels); then WidestPath,
              RandomWalk (odds, logprob), BipartiteMatching,
              MultiSourceMonotone (K = 4, min_add and max_min) and
              PersonalizedPageRank (K = 4) on R-MAT 2^16 (bipartite:
              2^15 + 2^15), each through all three engines × {ell, dense}
              on the card and on the host, state, masks, iterations and
              counters bit for bit; launches per kernel per app.  Fails
              unless ``min_step`` ran under a semiring other than
              ``min_add`` and ``pr_step`` ran with lanes.
10. io       — the grid's edge list staged to disk, spilled to a ``.ghp``
              under its tile labels and built out-of-core onto the card
              (``build_partitioned_graph_from_path``, default chunk size):
              seconds for stage, spill and build apart, the host's peak
              RSS and the card's peak memory; its ``graph_digest`` must
              equal the in-memory build's, and ``run_hybrid`` on it the
              ``main`` run's distances and counters bit for bit.
11. ft       — on both full-size graphs: (a) ``run_hybrid_ft`` stopped at
              ``max_iters`` (10 of SSSP's 20 iterations, 25 of PageRank's
              50) and resumed from its checkpoint, (b) one call with
              worker 1 of 4 killed by ``FaultPlan.kill_at`` and
              ``checkpoint_every=3``, exactly one recovery; each must end
              on the ``main`` run's final state and counters bit for bit
              (NaN by position), with ``ell_spmv`` and ``min_step`` (SSSP)
              and ``pr_step`` (PageRank) launched inside the runs.  Prints
              checkpoint bytes, snapshot / write / restore seconds,
              iterations lost and the ``graph_digest`` seconds.  Then
              WidestPath on the apps phase's R-MAT 2^16: its ``.ghp``
              resized P = 16 -> 9 (``resize_ghp``), a checkpoint
              re-sharded (``resize_checkpoint``) and restored elastically
              must reach the uninterrupted run's fixed point bit for bit.

Every phase prints its wall time.

The second-to-last line is ``{"kernels": [...]}``, the line before it the
card's name and power limit, and the last line
``{"ok": true, "device": {...}}``.  A detailed report goes to
``build/chip_smoke_report.json``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

GRID_SIDE = 2048          # SSSP grid: GRID_SIDE^2 vertices
GRID_TILES = 8            # geographic labels: GRID_TILES^2 partitions
RMAT_LOG2 = 21            # PageRank R-MAT: 2^RMAT_LOG2 vertices
PARTITIONS = 64
PR_TOL = 1e-5
# NVIDIA's data sheet, H100 SXM: HBM rate and float32 rate outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operand bytes a timed run of graph-replayed calls cycles through: three
# times the H100's 50 MB L2, so no call finds its operands there
COLD_BYTES = 150_000_000

# (TPU kernel it replaces, CUDA source) per kernel
KERNELS = {
    "ell_spmv": ("src/repro/kernels/ell_spmv/ell_spmv.py:71",
                 "src/repro_torch/csrc/ell_spmv.cu"),
    "min_step": ("src/repro/kernels/min_step/min_step.py:75",
                 "src/repro_torch/csrc/min_step.cu"),
    "pr_step": ("src/repro/kernels/pr_step/pr_step.py:63",
                "src/repro_torch/csrc/pr_step.cu"),
}


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def sync():
    import torch
    torch.cuda.synchronize()


def time_ms(fn, reps: int, windows: int = 5) -> float:
    """Median over ``windows`` CUDA-event windows of ``reps`` calls each,
    after one warm-up call, of the mean ms per call: one stalled window
    does not move it.  The calls are issued from Python one by one, so a
    call shorter than its host-side launch path measures the host."""
    import torch
    fn()
    sync()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        sync()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _clone(t):
    import torch
    if t.layout == torch.sparse_csr:
        return torch.sparse_csr_tensor(
            t.crow_indices().clone(), t.col_indices().clone(),
            t.values().clone(), size=t.shape)
    return t.clone()


def device_ms(call, ops, nbytes: int, reps: int, windows: int = 5) -> float:
    """Device time per call of ``call(*ops)``: a run of calls captured once
    into a CUDA graph, each of ``windows`` windows replaying it (median of
    the windows' mean ms per call), without the host's launch path between
    calls.  The calls cycle through copies of ``ops`` whose bytes read by
    a call (``nbytes``, the bound's count) add up to at least
    ``COLD_BYTES``, so every call reads its operands from HBM, as the
    engine reaches a bin between passes over larger ones; the run is
    ``reps`` calls or one per copy, whichever is more.  Raises if the calls
    cannot be captured."""
    import torch
    uniq = {id(t): t for t in ops}
    copies = max(1, -(-COLD_BYTES // nbytes))
    sets = [ops]
    for _ in range(copies - 1):
        memo = {k: _clone(t) for k, t in uniq.items()}
        sets.append(tuple(memo[id(t)] for t in ops))
    reps = max(reps, copies)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call(*ops)
        call(*ops)
    torch.cuda.current_stream().wait_stream(side)
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            call(*sets[i % copies])
    graph.replay()
    sync()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        sync()
        times.append(start.elapsed_time(end) / reps)
    del graph, sets
    return statistics.median(times)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())
    return smi


def phase_build():
    from repro_torch.kernels import build
    t = time.perf_counter()
    logs = build.build()
    secs = time.perf_counter() - t
    regs = {}
    for name, log in logs.items():
        regs[name] = sorted({int(l.split("Used ")[1].split(" ")[0])
                             for l in log.splitlines() if "Used " in l})
    say("build", seconds=f"{secs:.2f}", dir=build.build_dir(),
        registers=json.dumps(regs).replace(" ", ""))
    return secs


def grid_tiles(n):
    """The grid's geographic labels: GRID_TILES x GRID_TILES square tiles."""
    import numpy as np
    vid = np.arange(n)
    tile = GRID_SIDE // GRID_TILES
    return ((vid // GRID_SIDE // tile) * GRID_TILES
            + (vid % GRID_SIDE) // tile).astype(np.int32)


def grid_sssp_graph():
    from repro_torch import build_partitioned_graph
    from repro_torch.data.graphs import grid_graph

    t = time.perf_counter()
    edges, w, n = grid_graph(GRID_SIDE, GRID_SIDE, seed=0)
    graph = build_partitioned_graph(edges, n, grid_tiles(n), weights=w)
    sync()
    secs = time.perf_counter() - t
    say("graphs", app="sssp", V=n, E=len(edges), P=graph.n_partitions,
        host_build_s=f"{secs:.2f}", shape=graph.shape_summary.replace(" ", ","),
        local_bins=[tuple(s.flat_idx.shape) for s in graph.local_ell],
        remote_bins=[tuple(s.flat_idx.shape) for s in graph.remote_ell])
    return graph, (edges, w, n), secs


def rmat_pagerank_graph():
    from repro_torch import build_partitioned_graph, pagerank_edge_weights
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.partition import make_partition

    t = time.perf_counter()
    edges, n = rmat_graph(1 << RMAT_LOG2, avg_degree=8, seed=1)
    part = make_partition("fennel", edges, n, PARTITIONS, seed=0)
    w = pagerank_edge_weights(edges, n)
    graph = build_partitioned_graph(edges, n, part, weights=w,
                                    ell_base_slices=16)
    sync()
    secs = time.perf_counter() - t
    say("graphs", app="pagerank", V=n, E=len(edges), P=graph.n_partitions,
        host_build_s=f"{secs:.2f}", shape=graph.shape_summary.replace(" ", ","),
        local_bins=[tuple(s.flat_idx.shape) for s in graph.local_ell],
        remote_bins=[tuple(s.flat_idx.shape) for s in graph.remote_ell])
    return graph, (edges, w, n), secs


def run_counted(phase, app, engine, graph, prog, use_ell=True, vdata=None,
                quiet=False):
    """One ``run_hybrid`` / ``run_bsp`` / ``run_am`` (``engine``) through
    the entry point a user calls, launch and host-read counts zeroed just
    before and read just after."""
    import torch
    from repro_torch import run_am, run_bsp, run_hybrid
    from repro_torch.exec.syncs import host_reads, reset_host_reads
    from repro_torch.kernels.common import LAUNCHES, reset_launches

    runner = {"hybrid": run_hybrid, "bsp": run_bsp, "am": run_am}[engine]
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reset_host_reads()
    t = time.perf_counter()
    es, iters = runner(graph, prog, vdata=vdata, use_ell=use_ell)
    sync()
    secs = time.perf_counter() - t
    launches = dict(LAUNCHES)
    syncs = host_reads()
    c = es.counters
    counters = dict(iterations=int(c.iterations),
                    pseudo_supersteps=int(c.pseudo_supersteps.sum()),
                    net_messages=int(c.net_messages),
                    net_local_messages=int(c.net_local_messages),
                    mem_messages=int(c.mem_messages))
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not quiet:
        say(phase, app=app, engine=engine,
            delivery="ell" if use_ell else "dense", iterations=iters,
            run_s=f"{secs:.3f}", peak_device_GiB=f"{peak:.2f}",
            host_syncs=syncs, launches=json.dumps(launches).replace(" ", ""),
            counters=json.dumps(counters).replace(" ", ""))
    return es, dict(iterations=iters, run_s=secs, peak_device_GiB=peak,
                    host_syncs=syncs, launches=launches, counters=counters)


def check_sssp(graph, es, data):
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    from repro_torch import unpack_vertex

    edges, w, n = data
    got = unpack_vertex(graph, es.state["dist"])
    adj = csr_matrix((w.astype(np.float64), (edges[:, 0], edges[:, 1])),
                     shape=(n, n))
    want = dijkstra(adj, indices=0)
    err = float(np.max(np.abs(got - want) / np.maximum(want, 1e-30)))
    ok = bool(np.isfinite(got).all()) and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4)
    say("oracle", app="sssp", max_rel_err=f"{err:.3e}", finite=ok,
        max_dist=f"{float(want.max()):.2f}")
    if not ok:
        raise AssertionError("SSSP distances not finite")
    return err


def check_pagerank(graph, es, data):
    import numpy as np
    from scipy.sparse import csr_matrix
    from repro_torch import unpack_vertex

    edges, _, n = data
    got = unpack_vertex(graph, es.state["rank"])
    deg = np.maximum(np.bincount(edges[:, 0], minlength=n), 1)
    a = csr_matrix((0.85 / deg[edges[:, 0]], (edges[:, 1], edges[:, 0])),
                   shape=(n, n))
    r = np.full(n, 0.15)
    for _ in range(200):
        r = 0.15 + a @ r
    err = float(np.max(np.abs(got - r)))
    np.testing.assert_allclose(got, r, rtol=2e-3, atol=5e-3)
    if not np.isfinite(got).all():
        raise AssertionError("PageRank ranks not finite")
    say("oracle", app="pagerank", max_abs_err=f"{err:.3e}",
        rank_sum=f"{float(got.sum()):.1f}")
    return err


# --------------------------------------------------------------------------
# kernels against their plain versions, at the main path's shapes
# --------------------------------------------------------------------------

def _bits(t):
    import torch
    return t.view(torch.uint8) if t.dtype == torch.bool else t.view(torch.int32)


def _same(a, b):
    import torch
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and bool(torch.equal(_bits(a), _bits(b)))


def _max_abs_err(a, b):
    import torch
    if isinstance(a, tuple):
        return max(_max_abs_err(x, y) for x, y in zip(a, b))
    if a.dtype == torch.bool:
        return float((a != b).sum())
    d = (a - b).abs()
    d = torch.where(torch.isnan(d), torch.zeros_like(d), d)   # inf - inf
    return float(d.max()) if d.numel() else 0.0


def _same_nan(a, b):
    """Bit-identical outside NaNs, and NaN at the same positions.  NaN
    payloads are not compared: a kernel's select and torch's ops may carry
    different ones."""
    import torch
    if isinstance(a, tuple):
        return all(_same_nan(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        return False
    if a.dtype == torch.bool:
        return bool(torch.equal(a, b))
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and \
        bool(torch.equal(_bits(a)[~na], _bits(b)[~nb]))


# --------------------------------------------------------------------------
# synthetic sweep: both ell_spmv paths and min_step on edge-case values
# --------------------------------------------------------------------------

# (K, rows, frontier lanes) of the ell_spmv tiles, lanes 0 for an (N,)
# frontier: the narrow path (K = 7 takes the scalar fallback, 8 and 16 the
# unrolled rows), a warp per row (128; two rows a warp on an (N,) frontier
# from 33,792 rows on, four per warp the card holds), a block per row with
# a ragged last fold block (300), the local hub bin's width, and 258 fold
# blocks (more than the 256 a round holds, the last one slot wide).  Six
# lanes take a second lane chunk of four.
SWEEP_SPMV = ((7, 512, (0, 4)), (8, 512, (0, 4)), (16, 512, (0, 4)),
              (128, 512, (0, 4, 6)), (128, 40000, (0, 4, 6)),
              (300, 256, (0, 4, 6)), (7056, 32, (0, 4, 6)),
              (32897, 8, (0, 6)))
SWEEP_MIN_STEP = ((7, 512), (8, 512), (16, 512))
# (K, rows, frontier lanes) of the pr_step tiles: the rows path
# (K = 8 and 16 on an (N,) frontier, also over 600,001 rows: thousands of
# warps of every fill) and the thread-per-(row, lane) path (K = 7 and 300 with its
# ragged last fold block, every lane frontier).  Row counts are not
# multiples of 32.  Each tile also lies one row into a larger buffer
# (still aligned at K = 8 and 16) and one element in (misaligned: the
# thread path).
SWEEP_PR_STEP = ((7, 517, (0, 4, 6)), (8, 517, (0, 4, 6)),
                 (16, 517, (0, 4, 6)), (300, 517, (0, 4, 6)),
                 (8, 600_001, (0,)), (16, 600_001, (0,)))
SWEEP_OFFSETS = ("none", "row", "element")
# from this width on the plain version of a sweep tile runs on the CPU: it
# folds slot by slot, and on the card each slot's few ops cost a launch each
SWEEP_HOST_REF_K = 1024
SWEEP_FILLS = {"1%": 0.01, "50%": 0.5, "100%": 1.0, "gaps": 0.5}
SWEEP_N = 4096            # frontier length


def _sweep_tile(gen, rows, k, fill, n):
    """idx/msk of a synthetic tile.  ``gaps``: every third fold block (or
    4-slot chunk, below 128 slots) and every fifth row all padding, between
    occupied ones."""
    import torch
    idx = torch.randint(0, n, (rows, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    msk = torch.rand((rows, k), generator=gen, device="cuda") < \
        SWEEP_FILLS[fill]
    if fill == "gaps":
        chunk = torch.arange(k, device="cuda") // (128 if k >= 128 else 4)
        msk &= (chunk % 3 != 1)[None, :]
        msk &= (torch.arange(rows, device="cuda") % 5 != 0)[:, None]
    return idx, msk


def _sweep_values(gen, shape, mode, zero=None, neg_rows=False):
    """``zeros``: signed zeros only, random signs (``neg_rows``: every
    fourth row all -0.0) or all ``zero``, the zero that keeps a ⊗-product's
    sign that of the other operand, so folds of ±0 products hit the
    signed-zero ties and the skipped-padding rule.  ``infs``: ±inf, ±0, ±1 mixed into
    uniform values, giving ±inf ties and NaNs (inf - inf, 0 · inf)."""
    import torch
    kw = dict(generator=gen, device="cuda")
    if mode == "zeros":
        if zero is not None:
            return torch.full(shape, zero, device="cuda")
        v = torch.where(torch.rand(shape, **kw) < 0.5, -0.0, 0.0)
        if neg_rows:
            v[::4] = -0.0
        return v
    pal = torch.tensor([float("inf"), float("-inf"), 0.0, -0.0, 1.0, -1.0],
                       device="cuda")
    pick = pal[torch.randint(0, len(pal), shape, **kw)]
    u = torch.rand(shape, **kw) * 4 - 2
    return torch.where(torch.rand(shape, **kw) < 0.25, pick, u).contiguous()


def _offset(t, how):
    """``t`` copied into a larger buffer, one row (``row``) or one element
    (``element``) from its start, or ``t`` itself (``none``)."""
    import torch
    if how == "none":
        return t
    pad = t.shape[1] if how == "row" else 1
    buf = torch.empty(t.numel() + pad, dtype=t.dtype, device=t.device)
    buf[pad:] = t.reshape(-1)
    return buf[pad:].view(t.shape)


def _pr_step_sweep_case(gen, k, rows, lanes, fill, mode, offset):
    """Operands of one pr_step sweep case.  ``zeros``: ±0 edge values with
    every fourth row all -0.0, delta +0.0 (so every term keeps its edge
    value's sign) and an ``extra`` of -0.0.  ``infs``: the ``infs``
    palette for every operand, every fourth row's edge values negative,
    plus NaN edge values.  Either way about a
    third of the send flags are clear, so occupied slots with a clear flag
    carry -0.0, -1, ±inf and NaN values."""
    import torch
    idx, msk = _sweep_tile(gen, rows, k, fill, SWEEP_N)
    shape = (SWEEP_N, lanes) if lanes else (SWEEP_N,)
    rshape = (rows, lanes) if lanes else (rows,)
    val = _sweep_values(gen, (rows, k), mode, neg_rows=True)
    if mode == "zeros":
        delta = _sweep_values(gen, shape, mode, 0.0)
        extra = torch.full(rshape, -0.0, device="cuda")
    else:
        val[::4] = -val[::4].abs()
        nan = torch.rand((rows, k), generator=gen, device="cuda") < 0.05
        val = torch.where(nan, float("nan"), val)
        delta = _sweep_values(gen, shape, mode)
        extra = _sweep_values(gen, rshape, mode)
    rank = _sweep_values(gen, rshape, mode)
    send = torch.rand(shape, generator=gen, device="cuda") < 0.7
    idx, val, msk = (_offset(t, offset) for t in (idx, val, msk))
    return idx, val, msk, delta, send, rank, extra


def phase_sweep():
    """Each kernel path against its plain version on synthetic tiles: every
    semiring, (N,), (N, 4) and (N, 6) frontiers (``SWEEP_SPMV``,
    ``SWEEP_PR_STEP``), 1 %, 50 %, 100 % occupancy and
    all-padding blocks between occupied ones, signed zeros and ±inf ties;
    ``pr_step`` also on tiles offset into a larger buffer
    (``SWEEP_OFFSETS``).  Bit-identical, NaN by position only
    (``_same_nan``)."""
    import torch
    from repro_torch.kernels.common import MONOTONE_SEMIRINGS, SEMIRINGS
    from repro_torch.kernels.ell_spmv import ell_spmv, ell_spmv_ref
    from repro_torch.kernels.min_step import (fused_min_step,
                                              fused_min_step_ref)
    from repro_torch.kernels.pr_step import fused_pr_step, fused_pr_step_ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    t = time.perf_counter()
    n_cases, bad = 0, []
    # the zero that keeps a ⊗-product's sign that of the tile value
    keep_sign = {"add_mul": 0.0, "min_mul": 0.0, "max_min": 0.0,
                 "min_add": -0.0, "max_add": -0.0}
    for k, rows, lanes, fill, mode in (
            (k, r, L, f, m) for k, r, lane_set in SWEEP_SPMV
            for L in lane_set for f in SWEEP_FILLS for m in ("zeros", "infs")):
        idx, msk = _sweep_tile(gen, rows, k, fill, SWEEP_N)
        xshape = (SWEEP_N, lanes) if lanes else (SWEEP_N,)
        val = _sweep_values(gen, (rows, k), mode, neg_rows=True)
        on = "cpu" if k >= SWEEP_HOST_REF_K else "cuda"
        for sr in SEMIRINGS:
            x = _sweep_values(gen, xshape, mode, keep_sign[sr])
            got = ell_spmv(idx, val, msk, x, semiring=sr).to(on)
            want = ell_spmv_ref(*(t.to(on) for t in (idx, val, msk, x)),
                                semiring=sr)
            n_cases += 1
            if not _same_nan(got, want):
                bad.append(f"ell_spmv K={k} {fill} {mode} L={lanes} {sr}")
    for (k, rows), fill, mode, lanes in (
            (kr, f, m, L) for kr in SWEEP_MIN_STEP for f in SWEEP_FILLS
            for m in ("zeros", "infs") for L in (0, 4)):
        idx, msk = _sweep_tile(gen, rows, k, fill, rows)
        xshape = (rows, lanes) if lanes else (rows,)
        val = _sweep_values(gen, (rows, k), mode, neg_rows=True)
        for sr in sorted(MONOTONE_SEMIRINGS):
            x = _sweep_values(gen, xshape, mode, keep_sign[sr])
            xrow = _sweep_values(gen, xshape, mode)
            extra = _sweep_values(gen, xshape, mode)
            send = torch.rand(xshape, generator=gen, device="cuda") < 0.7
            got = fused_min_step(idx, val, msk, x, send, xrow, extra,
                                 semiring=sr)
            want = fused_min_step_ref(idx, val, msk, x, send, xrow, extra,
                                      semiring=sr)
            n_cases += 1
            if not _same_nan(got, want):
                bad.append(f"min_step K={k} {fill} {mode} L={lanes} {sr}")
    for k, rows, lanes, fill, mode, offset in (
            (k, r, L, f, m, o) for k, r, lane_set in SWEEP_PR_STEP
            for L in lane_set for f in SWEEP_FILLS for m in ("zeros", "infs")
            for o in SWEEP_OFFSETS):
        ops = _pr_step_sweep_case(gen, k, rows, lanes, fill, mode, offset)
        got = fused_pr_step(*ops)
        want = fused_pr_step_ref(*ops)
        n_cases += 1
        if not _same_nan(got, want):
            bad.append(f"pr_step K={k} rows={rows} {fill} {mode} L={lanes} "
                       f"offset={offset}")
    sync()
    say("sweep", cases=n_cases, failed=len(bad),
        seconds=f"{time.perf_counter() - t:.1f}")
    if bad:
        raise AssertionError(f"kernel != plain version in {len(bad)} sweep "
                             f"cases, first: {bad[:8]}")
    return n_cases


def _bound_ms(msk, idx, rows_bytes, ops_per_slot, flag=None,
              x_is_row=False):
    """Least time for the work these inputs need, over the HBM rate: each
    mask byte, the idx/val words of occupied slots, ``rows_bytes`` of row
    operands and outputs per row, and the frontier entries of the distinct
    sources of occupied slots.  A plain product reads a 4-byte value per
    source.  A fused step (``flag``: its send flags) reads a flag byte per
    source and the value only where the flag is set; where the value
    vector is also the row operand (``x_is_row``, the engine's
    ``xrow = x``) those words are already counted per row.  Against that,
    the per-slot operations over the float32 rate."""
    import torch
    nnz = int(msk.sum())
    src = torch.unique(idx[msk])
    rows = idx.shape[0]
    nbytes = msk.numel() + 8 * nnz + rows_bytes * rows
    if flag is None:
        nbytes += 4 * src.numel()
    else:
        nbytes += src.numel()
        if not x_is_row:
            nbytes += 4 * int(flag[src.long()].sum())
    ops = ops_per_slot * nnz
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, nnz


def _csr_library(idx, val, msk, n_cols):
    """torch.sparse CSR matrix of one ELL bin (the yardstick's operand)."""
    import torch
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None] \
        .expand_as(idx)[msk]
    cols = idx[msk].long()
    vals = val[msk]
    order = torch.argsort(rows * n_cols + cols)
    counts = torch.bincount(rows, minlength=idx.shape[0])
    crow = torch.zeros(idx.shape[0] + 1, dtype=torch.int64, device=idx.device)
    crow[1:] = torch.cumsum(counts, 0)
    with warnings.catch_warnings():      # "beta" / "invariant checks off"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, cols[order], vals[order],
                                       size=(idx.shape[0], n_cols))


def kernel_checks(sssp_graph, sssp_prog, sssp_es, pr_graph, pr_prog, pr_es):
    """Every kernel at every main-path shape, against its plain version on
    the same CUDA tensors, and the engine's fused steps (``fused_step_fn``)
    against the same steps over the plain versions.  Returns (rows of the
    detailed report, the timed case of each kernel)."""
    import torch
    from repro_torch.core.runtime import slice_flat
    from repro_torch.exec.local_phase import _spill_extra, fused_step_fn
    from repro_torch.kernels.common import SEMIRINGS
    from repro_torch.kernels.ell_spmv import ell_spmv, ell_spmv_ref
    from repro_torch.kernels.min_step import (fused_min_step,
                                              fused_min_step_ref)
    from repro_torch.kernels.pr_step import fused_pr_step, fused_pr_step_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    report = []

    def rand_send(shape):
        return torch.rand(shape, generator=gen, device="cuda") < 0.5

    def case(name, label, call, ops, ref, bound, library=None,
             lib_ops=(), reps=20, plain_reps=2):
        """``call(*ops)`` against ``ref(*ops)``.  ``ms``/``library_ms``:
        calls issued one by one from Python on warm operands (the meter of
        the first port's table); ``device_ms``/``library_device_ms``: the
        same calls replayed from a CUDA graph on cold operands."""
        fn = lambda: call(*ops)
        got, want = fn(), ref(*ops)
        sync()
        same = _same(got, want)
        err = _max_abs_err(got, want)
        row = dict(name=name, shape=label, bit_identical=same,
                   max_abs_err=err)
        row["bound_ms"], row["bound_by"], row["bytes"], row["nnz"] = bound
        row["ms"] = time_ms(fn, reps)
        row["device_ms"] = device_ms(call, ops, row["bytes"], reps)
        row["plain_ms"] = time_ms(lambda: ref(*ops), plain_reps, windows=3)
        row["library_ms"] = row["library_device_ms"] = None
        if library:
            row["library_ms"] = time_ms(lambda: library(*lib_ops), reps)
            row["library_device_ms"] = device_ms(library, lib_ops,
                                                 row["bytes"], reps)
        say("kernels", **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                          for k, v in row.items()})
        report.append(row)
        if not same:
            raise AssertionError(f"{name} {label}: kernel and plain version "
                                 f"differ (max abs err {err})")
        return row

    def step_operands(app, graph, prog, kind, args):
        """The engine's fused step on ``args`` against the same step over
        the plain versions; returns the fused kernel's operands as the
        step passes them, its spill bins' ``extra`` included."""
        p = graph.n_partitions
        step, slices, views = fused_step_fn(graph, prog, kind, p)
        plain, _, _ = fused_step_fn(graph, prog, kind, p, plain=True)
        got, want = step(*args), plain(*args)
        sync()
        same, err = _same(got, want), _max_abs_err(got, want)
        say("kernels", step=kind, app=app, spill_bins=len(slices) - 1,
            bit_identical=same, max_abs_err=err)
        report.append(dict(name=f"{kind} step", shape=f"{app} fused step",
                           bit_identical=same, max_abs_err=err))
        if not same:
            raise AssertionError(f"{app} {kind} step: kernels and plain "
                                 f"versions differ (max abs err {err})")
        ch = prog.channels[0]
        _, idx, msk = views[0]
        val = prog.ell_edge_values(ch, slices[0].val).reshape(
            -1, slices[0].kb)
        extra = _spill_extra(graph, prog, ch, slices, views,
                             {ch.name: args[-2]}, args[-1], p)
        if extra is None:
            extra = torch.full((idx.shape[0],), SEMIRINGS[ch.semiring][2],
                               device="cuda")
        flat = [a.reshape(-1).contiguous() for a in args]
        return idx, val, msk, flat, extra

    # --- min_step: the SSSP local phase's step over its base bin ----------
    x = sssp_es.state["dist"].contiguous()
    idx, val, msk, (xf, sf), extra = step_operands(
        "sssp", sssp_graph, sssp_prog, "min_step", (x, rand_send(x.shape)))
    timed = {}
    timed["min_step"] = case(
        "min_step", f"sssp local base {tuple(idx.shape)}",
        fused_min_step, (idx, val, msk, xf, sf, xf, extra),
        fused_min_step_ref,
        _bound_ms(msk, idx, 17, 2, flag=sf, x_is_row=True))

    # --- pr_step: the PageRank local phase's step, spill bins in extra ----
    rank = pr_es.state["rank"].contiguous()
    delta = (rank * 1e-3).contiguous()
    idx, val, msk, (rf, df, sf), extra = step_operands(
        "pagerank", pr_graph, pr_prog, "pr_step",
        (rank, delta, rand_send(delta.shape)))
    pr_kw = dict(damping=pr_prog.damping, tol=pr_prog.tol)
    timed["pr_step"] = case(
        "pr_step", f"pagerank local base {tuple(idx.shape)}, spill extra",
        lambda *a: fused_pr_step(*a, **pr_kw),
        (idx, val, msk, df, sf, rf, extra),
        lambda *a: fused_pr_step_ref(*a, **pr_kw),
        _bound_ms(msk, idx, 17, 3, flag=sf))

    # --- ell_spmv: every bin of both graphs' layouts ----------------------
    def frontier(graph, es, name, semiring, edges):
        out = es.out[name]
        if edges == "remote":
            out = torch.cat([out, torch.zeros((out.shape[0], graph.hp),
                                              device="cuda")], dim=1)
        x = out.reshape(-1).contiguous()
        ident = SEMIRINGS[semiring][2]
        return torch.where(rand_send(x.shape), x, ident).contiguous()

    for app, graph, es, name, sr in (
            ("sssp", sssp_graph, sssp_es, "dist", "min_add"),
            ("pagerank", pr_graph, pr_es, "delta", "add_mul")):
        for edges in ("local", "remote"):
            slices = graph.local_ell if edges == "local" else \
                graph.remote_ell
            x = frontier(graph, es, name, sr, edges)
            for b, s in enumerate(slices):
                _, idx, msk = slice_flat(s, graph, graph.n_partitions)
                val = s.val.reshape(-1, s.kb)
                lib, lib_ops = None, ()
                if sr == "add_mul":
                    lib = torch.sparse.mm
                    lib_ops = (_csr_library(idx, val, msk, x.shape[0]),
                               x[:, None])
                long_row = s.kb > 1024
                row = case(
                    "ell_spmv", f"{app} {edges} bin{b} {tuple(idx.shape)}",
                    lambda *a, sr=sr: ell_spmv(*a, semiring=sr),
                    (idx, val, msk, x),
                    lambda *a, sr=sr: ell_spmv_ref(*a, semiring=sr),
                    _bound_ms(msk, idx, 4, 2),
                    library=lib, lib_ops=lib_ops,
                    reps=5 if long_row else 20,
                    plain_reps=1 if long_row else 2)
                # the ell_spmv of the JSON line: the PageRank local phase's
                # widest spill bin, launched every pseudo-superstep
                if app == "pagerank" and edges == "local" and not s.dense:
                    timed["ell_spmv"] = row

    # --- lanes and semirings: a small (N, L) sweep -------------------------
    s = sssp_graph.local_ell[0]
    idx = s.flat_idx[:65536].contiguous()
    val = s.val.reshape(-1, s.kb)[:65536].contiguous()
    msk = s.msk.reshape(-1, s.kb)[:65536].contiguous()
    xl = torch.rand((idx.shape[0], 4), generator=gen, device="cuda")
    sl = rand_send(xl.shape)
    el = torch.rand(xl.shape, generator=gen, device="cuda")
    for sr in SEMIRINGS:
        ok = _same(ell_spmv(idx, val, msk, xl, semiring=sr),
                   ell_spmv_ref(idx, val, msk, xl, semiring=sr))
        # non-identity spill partials, as the engine's extra carries
        if sr != "add_mul":
            ok = ok and _same(
                fused_min_step(idx, val, msk, xl, sl, xl, el, semiring=sr),
                fused_min_step_ref(idx, val, msk, xl, sl, xl, el,
                                   semiring=sr))
        else:
            ok = ok and _same(
                fused_pr_step(idx, val, msk, xl, sl, xl, el * 1e-3,
                              tol=1e-3),
                fused_pr_step_ref(idx, val, msk, xl, sl, xl, el * 1e-3,
                                  tol=1e-3))
        sync()
        say("kernels", sweep=sr, lanes=4, rows=idx.shape[0],
            bit_identical=ok)
        if not ok:
            raise AssertionError(f"lane sweep {sr}: kernel != plain")
    return report, timed


def phase_profile(app, graph, prog, iters):
    """Where the time goes: the first ``iters`` global iterations of the
    main path under ``torch.profiler`` — device busy share of the wall time
    and the kernels (ours and PyTorch's glue) by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import run_hybrid

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run_hybrid(graph, prog, max_iters=iters)
        sync()
        wall = time.perf_counter() - t
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    top = sorted(rows, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    table = [dict(kernel=e.key[:90], calls=e.count,
                  device_ms=e.self_device_time_total / 1e3) for e in top]
    say("profile", app=app, iterations=iters, wall_s=f"{wall:.3f}",
        device_busy_s=f"{busy:.3f}",
        idle_share=f"{1 - busy / wall:.3f}" if rows else "not captured")
    for r in table:
        say("profile", app=app, calls=r["calls"],
            device_ms=f"{r['device_ms']:.2f}", kernel=repr(r["kernel"]))
    return dict(iterations=iters, wall_s=wall, device_busy_s=busy,
                top_kernels=table)


# --------------------------------------------------------------------------
# engines: Hama (BSP) and AM-Hama on the two full-size graphs
# --------------------------------------------------------------------------

def cpu_copy(graph):
    """The graph's tensors on the host, without its ELL layouts: what the
    dense delivery path reads, at a fraction of the copy."""
    import dataclasses
    import torch
    kw = {f.name: getattr(graph, f.name).cpu()
          for f in dataclasses.fields(graph)
          if isinstance(getattr(graph, f.name), torch.Tensor)}
    return dataclasses.replace(graph, local_ell=(), remote_ell=(), **kw)


def check_dense_deliver(graph, prog):
    """One dense ``deliver(edges="all")`` after ``init_state`` and one
    exchange (every vertex sends, so all of the graph's edges carry a
    message, hubs included), on the card and on host copies of the graph
    and state: pending inboxes and counters bit for bit.  Also counts the
    destinations where ``index_add_`` on the card (atomics, any order)
    lands elsewhere than the ordered fold — the check's sensitivity."""
    import torch
    from repro_torch.convert import engine_state_from_numpy, to_numpy
    from repro_torch.core.runtime import dense_plan, deliver, exchange, \
        init_state

    es = exchange(graph, init_state(graph, prog, None))
    t = time.perf_counter()
    got, _ = deliver(graph, prog, es, "all", use_ell=False)
    sync()
    card_s = time.perf_counter() - t
    cpu_graph = cpu_copy(graph)
    cpu_es = engine_state_from_numpy(to_numpy(es), device="cpu")
    t = time.perf_counter()
    want, _ = deliver(cpu_graph, prog, cpu_es, "all", use_ell=False)
    cpu_s = time.perf_counter() - t
    ch = prog.channels[0].name
    (g,), g_has = got.pending[ch]
    (w,), w_has = want.pending[ch]
    same = _same((g.cpu(), g_has.cpu()), (w, w_has))
    for f in ("net_messages", "net_local_messages", "mem_messages"):
        same = same and int(getattr(got.counters, f)) == \
            int(getattr(want.counters, f))
    # the same messages through index_add_ on the card
    plan = dense_plan(graph)
    src = plan.src
    cat = torch.cat([es.out[ch], es.halo_out[ch]], dim=1).reshape(-1)
    sent = torch.cat([es.send, es.halo_send], dim=1).reshape(-1)[src]
    (msg,), _ = prog.emit(prog.channels[0], {ch: cat[src]},
                          graph.edge_w.reshape(-1), None, None)
    msg = torch.where(sent & graph.edge_mask.reshape(-1), msg, 0.0)
    atomic = torch.zeros(g.numel(), device=g.device).index_add_(
        0, plan.dst, msg)
    differ = int((atomic.view(torch.int32)
                  != g.reshape(-1).view(torch.int32)).sum())
    say("engines", check="dense deliver all", edges=graph.n_edges,
        net_messages=int(got.counters.net_messages),
        mem_messages=int(got.counters.mem_messages),
        card_s=f"{card_s:.3f}", host_s=f"{cpu_s:.3f}",
        bit_identical=same, index_add_differs_at=differ)
    if not same:
        raise AssertionError("dense deliver: card and host differ")
    return dict(card_s=card_s, host_s=cpu_s, bit_identical=same,
                index_add_differs_at=differ)


def phase_engines(sssp_graph, sssp_es, sssp_run, pr_graph, pr_run,
                  pr_data):
    """``run_bsp`` and ``run_am`` (ELL) on both full-size graphs — SSSP
    distances bit-identical to ``run_hybrid``'s, PageRank against the
    power-iteration oracle — ``run_bsp`` on the dense path on the R-MAT
    graph, one full-size dense ``deliver``, and the paper's I / M /
    pseudo-superstep table."""
    import torch
    from repro_torch import SSSP, IncrementalPageRank

    t0 = time.perf_counter()
    runs = {("sssp", "hybrid-ell"): sssp_run,
            ("pagerank", "hybrid-ell"): pr_run}
    oracle = {}
    want = sssp_es.state["dist"]
    for engine in ("bsp", "am"):
        es, run = run_counted("engines", "sssp", engine, sssp_graph,
                              SSSP(source=0))
        same = _same(es.state["dist"], want)
        say("engines", app="sssp", engine=engine,
            dist_bit_identical_to_hybrid=same)
        if not same:
            raise AssertionError(f"{engine} SSSP distances differ from "
                                 f"hybrid's")
        runs[("sssp", f"{engine}-ell")] = run
        del es
    for engine, use_ell in (("bsp", True), ("am", True), ("bsp", False)):
        es, run = run_counted("engines", "pagerank", engine, pr_graph,
                              IncrementalPageRank(tolerance=PR_TOL),
                              use_ell=use_ell)
        label = f"{engine}-{'ell' if use_ell else 'dense'}"
        oracle[label] = check_pagerank(pr_graph, es, pr_data)
        runs[("pagerank", label)] = run
        del es
    for (app, label), run in runs.items():
        if label.endswith("ell") and not label.startswith("hybrid"):
            extra = {k: v for k, v in run["launches"].items()
                     if k != "ell_spmv" and v}
            if extra or not run["launches"]["ell_spmv"]:
                raise AssertionError(f"{app} {label}: launches "
                                     f"{run['launches']}, want ell_spmv "
                                     f"only")
    dense = check_dense_deliver(pr_graph,
                                IncrementalPageRank(tolerance=PR_TOL))
    torch.cuda.empty_cache()
    table = []
    for (app, label), run in runs.items():
        c = run["counters"]
        row = dict(graph=app, engine=label, I=c["iterations"],
                   M=c["net_messages"], M_local=c["net_local_messages"],
                   in_memory=c["mem_messages"],
                   pseudo_supersteps=c["pseudo_supersteps"],
                   run_s=round(run["run_s"], 3),
                   host_syncs=run["host_syncs"],
                   peak_device_GiB=round(run["peak_device_GiB"], 2),
                   launches=run["launches"])
        table.append(row)
        say("engines", table=json.dumps(row).replace(" ", ""))
    secs = time.perf_counter() - t0
    say("engines", phase_s=f"{secs:.1f}")
    return dict(table=table, pagerank_oracle_max_abs_err=oracle,
                dense_deliver=dense, phase_s=secs)


# --------------------------------------------------------------------------
# apps: the other apps, card against host, every engine x delivery
# --------------------------------------------------------------------------

APPS_LOG2 = 16            # R-MAT size of the apps phase
APPS_PARTITIONS = 16
APPS_LANES = 4


def apps_inputs():
    """The apps phase's R-MAT 2^16 from fixed seeds: ``(edges, n, part,
    uniform weights, lane sources)``."""
    import numpy as np
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.partition import hash_partition

    edges, n = rmat_graph(1 << APPS_LOG2, avg_degree=8, seed=2)
    part = hash_partition(n, APPS_PARTITIONS, seed=0)
    uniform = np.random.default_rng(3).uniform(0.5, 8.0, len(edges)) \
        .astype(np.float32)
    senders = np.flatnonzero(np.bincount(edges[:, 0], minlength=n))
    sources = np.random.default_rng(4).choice(senders, APPS_LANES,
                                              replace=False)
    return edges, n, part, uniform, sources


def apps_workloads(device):
    """``{app: (graph, make_prog, vdata)}`` of the apps phase on ``device``:
    R-MAT 2^16 (avg degree 8, hash partition, P = 16, a 16-slot ELL base
    bin, so hubs spill as on the PageRank graph) in each app's weight
    convention, and ``bipartite_graph(2^15, 2^15)`` for the matching.
    Everything is made from fixed seeds, so both devices get the same."""
    from repro_torch import (BipartiteMatching, MultiSourceMonotone,
                             PersonalizedPageRank, RandomWalk, WidestPath,
                             build_partitioned_graph, pagerank_edge_weights,
                             random_walk_edge_weights)
    from repro_torch.data.graphs import bipartite_graph
    from repro_torch.partition import hash_partition

    edges, n, part, uniform, sources = apps_inputs()
    graphs = {}

    def graph(weights):
        if weights not in graphs:
            w = {"uniform": uniform,
                 "pagerank": pagerank_edge_weights(edges, n),
                 "odds": random_walk_edge_weights(edges, n, "odds"),
                 "logprob": random_walk_edge_weights(edges, n, "logprob"),
                 }[weights]
            graphs[weights] = build_partitioned_graph(
                edges, n, part, weights=w, ell_base_slices=16,
                device=device)
        return graphs[weights]

    lanes = {"sources": sources}
    s0 = int(sources[0])
    out = {
        "widest_path": (graph("uniform"), lambda: WidestPath(source=s0),
                        None),
        "random_walk_odds": (graph("odds"),
                             lambda: RandomWalk(s0, "odds"), None),
        "random_walk_logprob": (graph("logprob"),
                                lambda: RandomWalk(s0, "logprob"), None),
        "multi_min_add": (graph("uniform"), lambda: MultiSourceMonotone(
            lanes=APPS_LANES, semiring="min_add"), lanes),
        "multi_max_min": (graph("uniform"), lambda: MultiSourceMonotone(
            lanes=APPS_LANES, semiring="max_min"), lanes),
        "personalized_pagerank": (graph("pagerank"),
                                  lambda: PersonalizedPageRank(
                                      lanes=APPS_LANES, tolerance=1e-5),
                                  lanes),
    }
    bedges, n_left, bn = bipartite_graph(1 << (APPS_LOG2 - 1),
                                         1 << (APPS_LOG2 - 1), seed=5)
    bg = build_partitioned_graph(bedges, bn,
                                 hash_partition(bn, APPS_PARTITIONS, seed=1),
                                 ell_base_slices=16, device=device)
    out["bipartite_matching"] = (
        bg, lambda: BipartiteMatching(seed=1),
        {"is_left": bg.vertex_gid < n_left, "degree": bg.out_degree})
    return out


def _run_snapshot(es, iters):
    """Numpy copies of what a run leaves: state, send/active, counters."""
    from repro_torch.convert import to_numpy
    return iters, to_numpy({"state": es.state, "send": es.send,
                            "active": es.active, "counters": es.counters})


def _tree_same(a, b):
    import numpy as np
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_same(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tree_same(x, y)
                                        for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a.reshape(-1).view(np.uint8),
                       b.reshape(-1).view(np.uint8))


def check_wcc_grid(graph, data):
    """WCC through ``run_hybrid`` on the full-size grid against scipy's
    connected components: labels exact (each component's smallest id)."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    from repro_torch import WCC, unpack_vertex

    edges, _, n = data
    es, run = run_counted("apps", "wcc", "hybrid", graph, WCC())
    got = unpack_vertex(graph, es.state["label"])
    n_comp, comp = connected_components(
        csr_matrix((np.ones(len(edges), np.int8), (edges[:, 0], edges[:, 1])),
                   shape=(n, n)), directed=False)
    first = np.full(n_comp, n, dtype=np.int64)
    np.minimum.at(first, comp, np.arange(n))
    exact = bool(np.array_equal(got, first[comp]))
    say("apps", app="wcc", graph="grid", components=n_comp,
        labels_exact=exact)
    if not exact:
        raise AssertionError("WCC labels differ from connected components")
    return dict(components=int(n_comp), **run)


def phase_apps(sssp_graph, sssp_data):
    """WCC on the full-size grid against scipy, then every other app on
    the card and on the host, bit for bit, through all three engines ×
    {ell, dense}, with launches per kernel per app.  Fails unless
    ``min_step`` ran under a semiring other than ``min_add`` and
    ``pr_step`` ran with lanes."""
    from repro_torch import run_am, run_bsp, run_hybrid
    from repro_torch.kernels.common import LAUNCHES

    runners = {"hybrid": run_hybrid, "bsp": run_bsp, "am": run_am}
    t0 = time.perf_counter()
    wcc = check_wcc_grid(sssp_graph, sssp_data)
    card, host = apps_workloads("cuda"), apps_workloads("cpu")
    rows = {}
    for app, (graph, make, vdata) in card.items():
        hgraph, _, hvdata = host[app]
        launches = {k: 0 for k in LAUNCHES}
        per_config = {}
        t = time.perf_counter()
        for engine in ("bsp", "am", "hybrid"):
            for use_ell in (True, False):
                es, run = run_counted("apps", app, engine, graph, make(),
                                      use_ell=use_ell, vdata=vdata,
                                      quiet=True)
                got = _run_snapshot(es, run["iterations"])
                want = _run_snapshot(*runners[engine](
                    hgraph, make(), vdata=hvdata, use_ell=use_ell,
                    device="cpu"))
                same = got[0] == want[0] and _tree_same(got[1], want[1])
                label = f"{engine}-{'ell' if use_ell else 'dense'}"
                per_config[label] = dict(iterations=run["iterations"],
                                         launches=run["launches"],
                                         bit_identical=same)
                for k, v in run["launches"].items():
                    launches[k] += v
                if not same:
                    raise AssertionError(f"{app} {label}: card and host "
                                         f"runs differ")
        secs = time.perf_counter() - t
        say("apps", app=app, configs=len(per_config), bit_identical=True,
            iterations=json.dumps({k: v["iterations"] for k, v in
                                   per_config.items()}).replace(" ", ""),
            launches=json.dumps(launches).replace(" ", ""),
            seconds=f"{secs:.1f}")
        rows[app] = dict(launches=launches, configs=per_config, seconds=secs)
    # min_step under max_min / min_mul / max_add, pr_step on lanes
    other = [a for a in ("widest_path", "random_walk_odds",
                         "random_walk_logprob", "multi_max_min")
             if rows[a]["launches"]["min_step"]]
    if not other:
        raise AssertionError("min_step never ran under a semiring other "
                             "than min_add")
    if not rows["personalized_pagerank"]["launches"]["pr_step"]:
        raise AssertionError("pr_step never ran with lanes")
    secs = time.perf_counter() - t0
    say("apps", phase_s=f"{secs:.1f}", min_step_semirings_beyond_min_add=
        ",".join(other), pr_step_lane_launches=rows[
            "personalized_pagerank"]["launches"]["pr_step"])
    return dict(wcc_grid=wcc, apps=rows, phase_s=secs)


# --------------------------------------------------------------------------
# io: the grid from disk, built out-of-core onto the card
# --------------------------------------------------------------------------

def _host_rss_gib():
    """This process's resident set now (``VmRSS``), GiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    raise RuntimeError("/proc/self/status has no VmRSS")


class _PeakRss:
    """The peak of this process's resident set over a ``with`` block,
    sampled every 20 ms by a thread (the card's machine keeps no
    ``VmHWM`` that a block could reset)."""

    def __enter__(self):
        import threading
        self.start = self.peak = _host_rss_gib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, _host_rss_gib())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, _host_rss_gib())


def _timed_digest(graph):
    from repro_torch.io import graph_digest
    t = time.perf_counter()
    digest = graph_digest(graph)
    return digest, time.perf_counter() - t


def phase_io(sssp_graph, sssp_data, sssp_es, sssp_run):
    """The grid's edge list staged to disk, spilled to a ``.ghp`` under its
    tile labels, and built out-of-core onto the card at the default chunk
    size; its ``graph_digest`` must equal the in-memory build's, and
    ``run_hybrid`` on it must give the ``main`` run's distances and
    counters bit for bit."""
    import tempfile
    import torch
    from repro_torch import SSSP
    from repro_torch.io import (build_partitioned_graph_from_path,
                                degree_pass, open_edge_source, spill_to_ghp)
    from repro_torch.io.stage import stage_arrays

    t0 = time.perf_counter()
    edges, w, n = sssp_data
    want, digest_s = _timed_digest(sssp_graph)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wd, \
            _PeakRss() as rss:
        sync()
        torch.cuda.reset_peak_memory_stats()
        card_before = torch.cuda.memory_allocated() / 2**30
        t = time.perf_counter()
        staged = os.path.join(wd, "staged")
        stage_arrays(staged, edges, weights=w, n_vertices=n)
        stage_s = time.perf_counter() - t
        t = time.perf_counter()
        source = open_edge_source(staged)
        _, _, _, in_deg = degree_pass(source)
        ghp = os.path.join(wd, "grid.ghp")
        sg = spill_to_ghp(source, grid_tiles(n), n, in_deg, ghp)
        spill_s = time.perf_counter() - t
        t = time.perf_counter()
        graph = build_partitioned_graph_from_path(ghp, device="cuda",
                                                  workdir=wd)
        sync()
        build_s = time.perf_counter() - t
        card_peak = torch.cuda.max_memory_allocated() / 2**30
        ghp_bytes = sum(os.path.getsize(os.path.join(r, f))
                        for r, _, fs in os.walk(ghp) for f in fs)
    got, ooc_digest_s = _timed_digest(graph)
    say("io", graph="sssp grid", V=n, E=len(edges),
        shards=sg.n_partitions, ghp_bytes=ghp_bytes,
        stage_s=f"{stage_s:.3f}", spill_s=f"{spill_s:.3f}",
        build_s=f"{build_s:.3f}", host_rss_before_GiB=f"{rss.start:.2f}",
        host_peak_rss_GiB=f"{rss.peak:.2f}",
        card_before_GiB=f"{card_before:.2f}",
        card_peak_GiB=f"{card_peak:.2f}",
        digest_s=f"{digest_s:.3f}", digest_equal=got == want)
    if got != want:
        raise AssertionError("out-of-core grid: graph_digest differs from "
                             "the in-memory build's")
    es, run = run_counted("io", "sssp", "hybrid", graph, SSSP(source=0))
    same = _same(es.state["dist"], sssp_es.state["dist"]) and \
        run["counters"] == sssp_run["counters"]
    say("io", app="sssp", dist_and_counters_bit_identical_to_main=same)
    if not same:
        raise AssertionError("out-of-core grid: run_hybrid differs from the "
                             "main run")
    del es, graph
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    say("io", phase_s=f"{secs:.1f}")
    return dict(stage_s=stage_s, spill_s=spill_s, build_s=build_s,
                ghp_bytes=ghp_bytes, host_rss_before_GiB=rss.start,
                host_peak_rss_GiB=rss.peak, card_before_GiB=card_before,
                card_peak_GiB=card_peak,
                digest_s=digest_s, ooc_digest_s=ooc_digest_s,
                digest=got, run=run, phase_s=secs)


# --------------------------------------------------------------------------
# ft: kill and resume, injected kill, elastic resume
# --------------------------------------------------------------------------

# global iteration at which (a) stops the first call, and the tick at which
# (b) kills worker 1 of 4 (detected two ticks later, past the last
# checkpoint of checkpoint_every=3, so one iteration is lost)
FT_PLAN = {"sssp": (10, 9), "pagerank": (25, 24)}


def _ft_counted(fn):
    """``fn()`` with launch and host-read counts zeroed just before and
    read just after, and its wall seconds."""
    from repro_torch.exec.syncs import host_reads, reset_host_reads
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    sync()
    reset_launches()
    reset_host_reads()
    t = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t, dict(LAUNCHES), host_reads()


def _state_same(got, want):
    """Every leaf of an engine state against a numpy snapshot of another:
    bit for bit, NaN by position."""
    import numpy as np
    from repro_torch.convert import to_numpy

    def walk(a, b):
        if isinstance(b, dict):
            return a.keys() == b.keys() and all(walk(a[k], b[k]) for k in b)
        if isinstance(b, list):
            return len(a) == len(b) and all(walk(x, y) for x, y in zip(a, b))
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype.kind == "f":
            nan = np.isnan(b)
            if not np.array_equal(np.isnan(a), nan):
                return False
            a, b = a[~nan], b[~nan]
        return np.array_equal(a.reshape(-1).view(np.uint8),
                              b.reshape(-1).view(np.uint8))

    return walk(to_numpy(got), want)


def ft_app(app, graph, make, want, want_iters, base):
    """(a) ``run_hybrid_ft`` stopped at ``max_iters=k`` and run again with
    ``resume=True``; (b) one call with worker 1 of 4 killed and
    ``checkpoint_every=3``.  Both must end on ``want`` (a numpy snapshot of
    the ``main`` run's final state) bit for bit, counters included."""
    from repro_torch.checkpoint import (AsyncCheckpointer, latest_checkpoint,
                                        load_checkpoint, read_manifest)
    from repro_torch.exec.iteration import init_hybrid
    from repro_torch.ft import FaultInjector, FaultPlan, run_hybrid_ft

    k, kill_tick = FT_PLAN[app]
    ck = AsyncCheckpointer(os.path.join(base, app, "a"), keep=3,
                           codec="raw")
    r1, s1, l1, h1 = _ft_counted(lambda: run_hybrid_ft(
        graph, make(), checkpointer=ck, max_iters=k))
    path = latest_checkpoint(ck.base)
    step_a = read_manifest(path)["step"]    # before the resume's GC drops it
    template = init_hybrid(graph, make(), None)
    t = time.perf_counter()
    load_checkpoint(path, template)
    sync()
    restore_s = time.perf_counter() - t
    del template
    r2, s2, l2, h2 = _ft_counted(lambda: run_hybrid_ft(
        graph, make(), checkpointer=ck, resume=True))
    ck.close()
    lost_a = r1.iterations - step_a if r2.resumed_from == path else None
    ck_a = ck.written
    written_a = dict(checkpoints=ck_a, iterations_lost=lost_a,
                     checkpoint_bytes=ck.bytes_written,
                     snapshot_s=ck.save_seconds, write_s=ck.write_seconds)
    same_a = _state_same(r2.es, want) and r2.iterations == want_iters
    launches_a = {name: l1[name] + l2[name] for name in l1}
    say("ft", app=app, run="kill-resume", killed_at=r1.iterations,
        resumed_from=os.path.basename(r2.resumed_from or ""),
        iterations=r2.iterations, seconds=f"{s1:.3f}+{s2:.3f}",
        checkpoints=ck_a, checkpoint_bytes=ck.bytes_written,
        snapshot_s=f"{ck.save_seconds:.3f}",
        write_s=f"{ck.write_seconds:.3f}", restore_s=f"{restore_s:.3f}",
        iterations_lost=lost_a, host_syncs=h1 + h2,
        launches=json.dumps(launches_a).replace(" ", ""),
        bit_identical_to_main=same_a)
    del r1, r2
    ck = AsyncCheckpointer(os.path.join(base, app, "b"), keep=3,
                           codec="raw")
    inj = FaultInjector(FaultPlan.kill_at(kill_tick, worker=1), n_workers=4)
    rb, sb, lb, hb = _ft_counted(lambda: run_hybrid_ft(
        graph, make(), checkpointer=ck, checkpoint_every=3, n_workers=4,
        injector=inj))
    ck.close()
    same_b = _state_same(rb.es, want) and rb.iterations == want_iters
    ev = rb.recoveries[0] if len(rb.recoveries) == 1 else None
    say("ft", app=app, run="injected-kill", recoveries=len(rb.recoveries),
        tick=ev and ev.tick, restored_iteration=ev and ev.restored_iteration,
        iterations_lost=ev and ev.iterations_lost,
        restore_s=f"{ev.restore_seconds:.3f}" if ev else None,
        bytes_read=ev and ev.bytes_read, seconds=f"{sb:.3f}",
        checkpoints=ck.written, checkpoint_bytes=ck.bytes_written,
        snapshot_s=f"{ck.save_seconds:.3f}",
        write_s=f"{ck.write_seconds:.3f}", host_syncs=hb,
        launches=json.dumps(lb).replace(" ", ""),
        bit_identical_to_main=same_b)
    out = dict(
        kill_resume=dict(killed_at=k, seconds=[s1, s2], **written_a,
                         restore_s=restore_s, launches=launches_a,
                         host_syncs=h1 + h2, bit_identical=same_a),
        injected_kill=dict(recoveries=len(rb.recoveries),
                           event=_event_dict(ev), seconds=sb,
                           checkpoints=ck.written,
                           checkpoint_bytes=ck.bytes_written,
                           snapshot_s=ck.save_seconds,
                           write_s=ck.write_seconds, launches=lb,
                           host_syncs=hb, bit_identical=same_b))
    if not (same_a and same_b):
        raise AssertionError(f"ft {app}: a resumed or recovered run "
                             f"differs from the main run")
    if lost_a != 0 or ck_a != want_iters:
        raise AssertionError(f"ft {app}: the resume lost {lost_a} "
                             f"iterations and {ck_a} checkpoints were "
                             f"written, want 0 and {want_iters}")
    if ev is None:
        raise AssertionError(f"ft {app}: {len(rb.recoveries)} recoveries, "
                             f"want exactly one")
    need = ("ell_spmv", "min_step") if app == "sssp" else ("pr_step",)
    for label, counts in (("kill-resume", launches_a),
                          ("injected-kill", lb)):
        idle = [name for name in need if not counts[name]]
        if idle:
            raise AssertionError(f"ft {app} {label}: never launched {idle}")
    return out


def _event_dict(obj):
    """A ``RecoveryEvent`` as JSON-ready values."""
    import dataclasses
    return None if obj is None else {
        k: (list(v) if isinstance(v, tuple) else
            {str(a): b for a, b in v.items()} if isinstance(v, dict) else v)
        for k, v in dataclasses.asdict(obj).items()}


def ft_elastic(base):
    """WidestPath on the apps phase's R-MAT 2^16: its ``.ghp`` (P = 16)
    resized to P = 9 with ``resize_ghp``, a checkpoint of the P = 16 run
    re-sharded with ``resize_checkpoint``, ``elastic_restore`` on the P = 9
    graph, run to quiescence: the fixed point must equal the uninterrupted
    P = 16 run's, vertex by vertex, bit for bit."""
    import numpy as np
    from repro_torch import WidestPath, unpack_vertex
    from repro_torch.exec.driver import run_engine
    from repro_torch.exec.policy import hybrid_policy
    from repro_torch.ft import elastic_restore, run_hybrid_ft
    from repro_torch.io import build_from_sharded, load_graph, save_graph
    from repro_torch.io.resize import resize_checkpoint, resize_ghp

    t = time.perf_counter()
    edges, n, part, uniform, sources = apps_inputs()
    make = lambda: WidestPath(source=int(sources[0]))      # noqa: E731
    src, dst = os.path.join(base, "wp16.ghp"), os.path.join(base, "wp9.ghp")
    save_graph(src, edges, n, part, weights=uniform, positions=True)
    g16 = build_from_sharded(load_graph(src), ell_base_slices=16)
    ref = run_hybrid_ft(g16, make())
    ck16 = os.path.join(base, "wp16.ck")
    run_hybrid_ft(g16, make(), ckpt_dir=ck16, max_iters=3)
    sg9 = resize_ghp(src, dst, 9)
    g9 = build_from_sharded(sg9, ell_base_slices=16)
    digest9, _ = _timed_digest(g9)
    ck9 = resize_checkpoint(ck16, os.path.join(base, "wp9.ck"), part,
                            sg9.part, digest9)
    es, it = elastic_restore(ck9, g9, make(), None, part, sg9.part,
                             expect_digest=digest9)
    ctx = run_engine(g9, make(), hybrid_policy(), es=es)
    got = unpack_vertex(g9, ctx.es.state["cap"])
    want = unpack_vertex(g16, ref.es.state["cap"])
    same = got.dtype == want.dtype and np.array_equal(
        got.view(np.uint32), want.view(np.uint32))
    secs = time.perf_counter() - t
    say("ft", app="widest_path", run="elastic 16->9", restored_iteration=it,
        iterations=f"{ref.iterations}->{ctx.iteration}",
        fixed_point_bit_identical=same, seconds=f"{secs:.1f}")
    if not same:
        raise AssertionError("elastic resume: the P = 9 fixed point differs "
                             "from the P = 16 run's")
    return dict(restored_iteration=it, iterations=[ref.iterations,
                                                   ctx.iteration],
                bit_identical=same, seconds=secs)


def phase_ft(sssp_graph, sssp_want, sssp_iters, pr_graph, pr_want,
             pr_iters):
    """Kill-and-resume and injected-kill recovery on both full-size graphs
    (the in-memory R-MAT graph of ``graphs``), then the elastic resume."""
    import tempfile
    import torch
    from repro_torch import SSSP, IncrementalPageRank

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wd:
        for app, graph, make, want, iters in (
                ("sssp", sssp_graph, lambda: SSSP(source=0), sssp_want,
                 sssp_iters),
                ("pagerank", pr_graph,
                 lambda: IncrementalPageRank(tolerance=PR_TOL), pr_want,
                 pr_iters)):
            _, digest_s = _timed_digest(graph)
            out[app] = ft_app(app, graph, make, want, iters, wd)
            out[app]["graph_digest_s"] = digest_s
            say("ft", app=app, graph_digest_s=f"{digest_s:.3f}")
            torch.cuda.empty_cache()
        out["elastic"] = ft_elastic(wd)
    secs = time.perf_counter() - t0
    say("ft", phase_s=f"{secs:.1f}")
    out["phase_s"] = secs
    return out


def main() -> int:
    t0 = time.perf_counter()
    smi = phase_device()
    import torch
    from repro_torch import SSSP, IncrementalPageRank

    build_s = phase_build()
    sweep_cases = phase_sweep()
    sssp_graph, sssp_data, sssp_build_s = grid_sssp_graph()
    pr_graph, pr_data, pr_build_s = rmat_pagerank_graph()

    sssp_prog, pr_prog = SSSP(source=0), IncrementalPageRank(tolerance=PR_TOL)
    sssp_es, sssp_run = run_counted("main", "sssp", "hybrid", sssp_graph,
                                    sssp_prog)
    pr_es, pr_run = run_counted("main", "pagerank", "hybrid", pr_graph,
                                pr_prog)
    launches = {k: sssp_run["launches"][k] + pr_run["launches"][k]
                for k in KERNELS}
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")

    sssp_err = check_sssp(sssp_graph, sssp_es, sssp_data)
    pr_err = check_pagerank(pr_graph, pr_es, pr_data)

    report, timed = kernel_checks(sssp_graph, sssp_prog, sssp_es,
                                  pr_graph, pr_prog, pr_es)
    profiles = dict(
        sssp=phase_profile("sssp", sssp_graph, SSSP(source=0), 2),
        pagerank=phase_profile("pagerank", pr_graph,
                               IncrementalPageRank(tolerance=PR_TOL), 5))
    engines = phase_engines(sssp_graph, sssp_es, sssp_run, pr_graph, pr_run,
                            pr_data)
    from repro_torch.convert import to_numpy
    pr_want = to_numpy(pr_es)        # the ft phase's reference, on the host
    del pr_es
    apps = phase_apps(sssp_graph, sssp_data)
    io = phase_io(sssp_graph, sssp_data, sssp_es, sssp_run)
    ft = phase_ft(sssp_graph, to_numpy(sssp_es), sssp_run["iterations"],
                  pr_graph, pr_want, pr_run["iterations"])

    kernels = []
    for name, (replaces, source) in KERNELS.items():
        row = timed[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], device_ms=row["device_ms"],
            library_device_ms=row["library_device_ms"],
            shape=row["shape"]))

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke_report.json"),
              "w") as f:
        json.dump(dict(card=smi, build_s=build_s, sweep_cases=sweep_cases,
                       sssp=dict(host_build_s=sssp_build_s,
                                 oracle_max_rel_err=sssp_err, **sssp_run),
                       pagerank=dict(host_build_s=pr_build_s,
                                     oracle_max_abs_err=pr_err, **pr_run),
                       kernel_cases=report, kernels=kernels,
                       profiles=profiles, engines=engines, apps=apps,
                       io=io, ft=ft), f, indent=1)

    say("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:              # every phase failure ends here
        import traceback
        traceback.print_exc()
        print(f"[FAIL] {type(exc).__name__}: {exc}", file=sys.stderr)
        sys.exit(1)
