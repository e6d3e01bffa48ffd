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
              against their plain versions: every semiring, (N,), (N, 4),
              (N, 6) and (N, 16) frontiers,
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
5a. dist    — the distributed hybrid step (``repro_torch.core.
              distributed``) at world 4 on both graphs, rebuilt on the
              host with ``edge_blocks=4`` under the ``graphs`` phase's
              labels: 4 spawned ranks share the card and talk through
              gloo (NCCL refuses two ranks on one device), each rank's
              16-partition block cut from the host graph, which reaches
              the ranks through shared memory, and copied to the card.
              Each run bit for bit against ``run_hybrid`` on the card on
              the same graph (the whole state, iterations, counters,
              per-partition pseudo-supersteps), SSSP also against
              ``main``'s distances; fails unless ``ell_spmv`` and
              ``min_step`` (SSSP), ``pr_step`` and ``ell_spmv`` (PageRank)
              launched in every rank; each kernel once at a rank's block
              shapes against its plain version.  Prints seconds, per-rank
              pseudo-supersteps, host syncs, collectives and exchange
              bytes per iteration, staged bytes and peak device memory.
              Then SSSP over a bfloat16 wire, traced, stopped at 24
              iterations: its Dijkstra error printed, not held (see
              ``phase_dist``).
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
              rate set for the same work.  Also the serving shapes:
              ``min_step`` and ``ell_spmv`` on the grid's base bin and
              ``pr_step`` and ``ell_spmv`` (beside ``torch.sparse.mm`` with
              a dense (N, 16) operand) on R-MAT's, all at L = 16.
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
              on the card, and one engine × delivery per app (round robin,
              so each of the six is held) again on the host, state,
              masks, iterations and counters bit for bit; launches per
              kernel per app.  Fails
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
              50) and resumed from its checkpoint (PageRank checkpointing
              every 5th iteration), (b) one call with
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
12. serve    — ``ServeEngine(lane_widths=(1, 4, 16))`` on both graphs:
              16 grid sssp queries as one K = 16 batch (the source-0 lane
              bit-identical to ``main``), a solo query (bit-identical to
              its lane), ``stream()`` over 4 queries (each yield
              bit-identical to ``run()``'s, in order of convergence), the
              same 4 checkpointed, killed from ``on_iteration`` and resumed
              by a fresh engine (bit-identical, one ``ResumeEvent``, the
              checkpoint family deleted); 16 R-MAT ppr seeds as one K = 16
              batch and one seed's K = 1 dispatch (bit-identical to its
              lane).  Every sssp lane against scipy's Dijkstra (rtol
              1e-4), every ppr lane against a personalized power iteration
              (the ``oracle`` tolerances), both computed by spawned worker
              processes beside the card's work.  Per batch: K, iterations,
              seconds, queries/s, peak device memory, host syncs, launches
              per kernel and those with L > 1; the persisted registry's
              ``serve.compiles.<program>.K<K>`` must be 1 each.  Fails
              unless every kernel launched with L > 1.  The same 16 ppr
              seeds also go out at the program's default tolerance (1e-4)
              and at 1e-5; their oracle errors are printed, not held to
              the oracle's tolerance (Algorithm 5 keeps deltas at or below
              the query's tolerance from propagating).
13. obs      — ``run_engine`` with ``trace_hooks(Tracer())`` on both graphs
              (state and counters bit-identical to ``main``, one superstep
              span per iteration, span deltas summed equal to the
              counters past init, the Chrome trace under ``build/``
              against the schema of ``tests/test_obs.py``);
              ``phased_run`` (ELL), hybrid on both and BSP on R-MAT, with
              seconds per phase, barriers, exchange bytes and the
              local-compute fraction, bit-identical to the fused engines;
              ``run_hybrid_ft`` on the grid with a tracer, a registry and
              one injected kill (one ``recovery`` span, the registry's
              flags read back off the registry equal to the run's);
              ``python -m repro_torch.obs.report`` in a subprocess, exit 0.
14. lm       — the LM substrate (``repro_torch.models``, ``train``,
              ``optim``, ``core.hybrid_sync``), float32 with TF32 off, on
              ``demo-100m`` (``examples/train_lm.py``'s 14 × 640 LM, 32,768
              tokens, tied; ``count_params`` printed).  Serving: 4 prompts
              of 256 tokens left-padded to 256 / 201 / 130 / 64 through
              ``start``, ``prefill`` into a cache of 288, 32 greedy
              ``decode_step``s, every step's logits against ``forward``
              over that request's own unpadded prefix (atol 1e-4); prefill
              ms, ms a decode step, tokens/s, peak memory.  Training: 100
              steps of ``make_train_step`` at the example's settings (batch
              8 × 256 from ``SyntheticTokens``, peak lr 3e-4, warmup 50)
              under ``torch.use_deterministic_algorithms(True)``,
              checkpointed by ``AsyncCheckpointer`` at step 50; a fresh
              model and optimizer restored from it run steps 50–99 again,
              bit for bit the uninterrupted run (losses, weights, AdamW
              state); the loss finite throughout and its last 10 steps'
              mean below ln(vocab); ms a step, tokens/s, peak memory,
              checkpoint bytes and seconds; one more step under
              ``torch.profiler`` (device ms and launches a step).  Then every family of
              ``configs.lm_smoke.SMOKE_FAMILIES`` (dense GQA, window +
              softcap, MLA, MoE with a dense head and shared experts,
              Mamba, Mamba/attention, encoder-decoder, VLM) on the card
              against the host: forward, prefill + 4 decode steps
              (``LM_FAMILY_ATOL``), one train step held as its gradients
              leaf by leaf (``LM_GRAD_RTOL``), AdamW on the host's
              gradients against the host's update (``LM_UPDATE_RTOL``)
              and the card's step against AdamW on its own gradients, bit
              for bit; then ``microbatches=4`` against 1, and two pods of
              inner steps, then two rounds of
              ``global_sync(compress=True)`` on the same pods, card against
              host (``LM_SYNC_RTOL``).
15. mesh     — the LM substrate's sharding (``repro_torch.sharding``,
              ``launch``) on a (data 2, model 2) ``DeviceMesh`` of 4
              spawned ranks sharing the card over gloo (every collective
              staged through pinned host memory), ``demo-100m`` at full
              size, float32, TF32 off, its weights drawn once on the host
              and handed to the ranks.  (b) the lm phase's 4 requests with
              the batch over data and the 288-row cache's sequence over
              model (``decode_axis``): logits within 1e-4 of the
              single-device decode on the card, tokens equal.  (a) 3
              sharded train steps (parameters and AdamW moments placed by
              the rules, weights gathered at use) against 3 single-device
              steps on the card from the same weights and batches, each
              value against its own scale: each step's loss
              (``MESH_LOSS_RTOL``) and clipping norm (``MESH_NORM_RTOL``),
              each leaf's first moment against its largest |mu|
              (``MESH_MU_RTOL``) and its weights after step 3 against its
              largest move (``MESH_UPDATE_RTOL``); each rank's parameter
              and moment bytes (the caching allocator's requested bytes;
              its ``memory_allocated`` blocks are printed beside them)
              equal the dry run's per-rank argument bytes for the same
              mesh.  (c) two pods on ranks 0 and 1, 2 inner steps each,
              then two
              ``global_sync(compress=True, group=)`` rounds (the second
              the residuals alone), bit for bit the one-process sync of
              the same pods, the pods equal after it; wire bytes against
              the float32 deltas'.  (d) ``python -m
              repro_torch.launch.dryrun`` of demo-100m (the four shapes ×
              both production meshes, the graph and sync cells) on the
              host on ``meta`` tensors, one process per (shape, mesh) and
              one for the graph and sync cells, started when the ranks are
              done (no timed run shares the host with it):
              per-rank bytes, FLOPs and collective bytes, ``long_500k``
              skipped with the reference's reason.

Every phase prints its wall time; the ``[done]`` line gives the seconds
of each phase (``phase_s``), set-up and checks included.

Cut to stay inside the 1200 s limit with ``dist``: ``apps`` reruns one
configuration per app on the host (was all six), ``ft``'s PageRank
stop-and-resume checkpoints every 5th iteration (was every one); and
with ``mesh``: ``dist``'s bfloat16-wire run stops at 24 iterations (was
40), and the PageRank oracle (200 scipy power-iteration steps) is
computed once and held against by every PageRank check (was once per
check, four times).

The third-to-last line is ``{"kernels": [...]}``, the line after it the
card's name and power limit, and the last line
``{"ok": true, "device": {...}}``.  A detailed report goes to
``build/chip_smoke_report.json``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# cuBLAS is deterministic under torch.use_deterministic_algorithms (the
# lm phase's resumed training run) only with a fixed workspace, set before
# its first call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

from repro_torch.configs.lm_smoke import DEMO_100M  # noqa: E402

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

# the serving layer's lane widths; its widest batch takes 16 queries
SERVE_WIDTHS = (1, 4, 16)
SERVE_LANES = SERVE_WIDTHS[-1]

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
    return graph, (edges, w, n), secs, part


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
    err = _rel_err(got, want)
    ok = bool(np.isfinite(got).all()) and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4)
    say("oracle", app="sssp", max_rel_err=f"{err:.3e}", finite=ok,
        max_dist=f"{float(want.max()):.2f}")
    if not ok:
        raise AssertionError("SSSP distances not finite")
    return err, want


def _rel_err(got, want):
    import numpy as np
    return float(np.max(np.abs(got - want) / np.maximum(want, 1e-30)))


_PR_ORACLE: dict = {}


def pagerank_oracle(data):
    """scipy's power iteration on the graph of ``data``, computed once per
    graph (every PageRank check of the run holds its ranks to it)."""
    import numpy as np
    from scipy.sparse import csr_matrix
    edges, _, n = data
    key = id(edges)
    if key not in _PR_ORACLE:
        deg = np.maximum(np.bincount(edges[:, 0], minlength=n), 1)
        a = csr_matrix((0.85 / deg[edges[:, 0]], (edges[:, 1], edges[:, 0])),
                       shape=(n, n))
        r = np.full(n, 0.15)
        for _ in range(200):
            r = 0.15 + a @ r
        _PR_ORACLE[key] = (edges, r)       # edges kept: the id stays theirs
    return _PR_ORACLE[key][1]


def check_pagerank(graph, es, data):
    import numpy as np
    from repro_torch import unpack_vertex

    got = unpack_vertex(graph, es.state["rank"])
    r = pagerank_oracle(data)
    err = float(np.max(np.abs(got - r)))
    np.testing.assert_allclose(got, r, rtol=2e-3, atol=5e-3)
    if not np.isfinite(got).all():
        raise AssertionError("PageRank ranks not finite")
    say("oracle", app="pagerank", max_abs_err=f"{err:.3e}",
        rank_sum=f"{float(got.sum()):.1f}")
    return err


# --------------------------------------------------------------------------
# dist: the distributed step, 4 ranks sharing the card over gloo
# --------------------------------------------------------------------------

DIST_WORLD = 4
DIST_DEVICE = "cuda:0"    # every rank on the one card
DIST_DEADLINE_S = 300.0   # per spawn: a hung rank fails the phase
# the bf16-wire grid run stops here: at this scale it does not reach
# quiescence (see phase_dist).  24 iterations (40 before the mesh phase
# joined the smoke): past the 20 in which the float32 run reaches every
# vertex, so every distance is finite (12 left some at inf)
DIST_BF16_MAX_ITERS = 24


def dist_graphs(sssp_data, pr_data, pr_part):
    """Both main-path graphs rebuilt on the host with ``edge_blocks=4``
    (one edge block per rank) under the ``graphs`` phase's labels: only
    the block layout differs from ``main``'s graphs."""
    from repro_torch import build_partitioned_graph

    out = {}
    for app, (edges, w, n), part, kw in (
            ("sssp", sssp_data, None, {}),
            ("pagerank", pr_data, pr_part, dict(ell_base_slices=16))):
        t = time.perf_counter()
        part = grid_tiles(n) if part is None else part
        out[app] = build_partitioned_graph(
            edges, n, part, weights=w, edge_blocks=DIST_WORLD,
            device="cpu", **kw)
        say("dist", app=app, host_build_s=f"{time.perf_counter() - t:.2f}",
            shape=out[app].shape_summary.replace(" ", ","))
    return out


def dist_kernel_checks(app, graph, prog, es):
    """Each kernel of ``app``'s path once at rank 0's block shapes (its
    block view on the card, the block of the card run's final state and
    a random send mask), against its plain version: the fused local step
    (and its spill bins' ``ell_spmv``) and every remote bin's
    ``ell_spmv``."""
    import torch
    from repro_torch.core.distributed import block_state, block_view
    from repro_torch.core.runtime import slice_flat
    from repro_torch.exec.local_phase import fused_step_fn
    from repro_torch.kernels.ell_spmv import ell_spmv, ell_spmv_ref

    bg = block_view(graph, 0, DIST_WORLD, DIST_DEVICE)
    bes = block_state(es, 0, DIST_WORLD, DIST_DEVICE)
    p = bg.vertex_gid.shape[0]
    ch = prog.channels[0]
    gen = torch.Generator(device=DIST_DEVICE).manual_seed(1)
    kind = "min_step" if app == "sssp" else "pr_step"
    x = bes.state["dist" if kind == "min_step" else "rank"].contiguous()
    send = torch.rand(x.shape, generator=gen, device=DIST_DEVICE) < 0.5
    args = (x, send) if kind == "min_step" else (x, x * 1e-3, send)
    rows = []

    def check(name, shape, got, want):
        same = _same_nan(got, want)
        rows.append(dict(name=name, shape=shape, bit_identical=same,
                         max_abs_err=_max_abs_err(got, want)))
        say("dist", app=app, kernel=name, block_shape=shape,
            bit_identical=same, max_abs_err=rows[-1]["max_abs_err"])
        if not same:
            raise AssertionError(f"dist {app} {name} {shape}: kernel and "
                                 f"plain version differ at block shapes")

    step, slices, views = fused_step_fn(bg, prog, kind, p)
    plain, _, _ = fused_step_fn(bg, prog, kind, p, plain=True)
    check(f"{kind} step", f"{tuple(views[0][1].shape)}+{len(slices) - 1}"
          f" spill", step(*args), plain(*args))
    table = torch.cat([bes.out[ch.name], bes.halo_out[ch.name]], dim=1)
    xr = table.reshape(-1).to(torch.float32).contiguous()
    for s in bg.remote_ell:
        _, idx, msk = slice_flat(s, bg, p)
        v = prog.ell_edge_values(ch, s.val).reshape(-1, s.kb)
        check("ell_spmv", f"remote {tuple(idx.shape)}",
              ell_spmv(idx, v, msk, xr, semiring=ch.semiring),
              ell_spmv_ref(idx, v, msk, xr, semiring=ch.semiring))
    return rows


def dist_run(app, graph, make, **kw):
    """``run_dist_hybrid`` on 4 ranks sharing ``cuda:0`` over gloo, the
    global host graph reaching them through shared memory; prints one
    line for the run and one per rank."""
    from repro_torch.core.distributed import run_dist_hybrid

    t = time.perf_counter()
    r = run_dist_hybrid(graph, make(), DIST_WORLD, backend="gloo",
                        device=DIST_DEVICE, deadline_s=DIST_DEADLINE_S, **kw)
    secs = time.perf_counter() - t
    it = r.iterations
    wire = kw.get("wire_dtype")
    ranks = []
    for rank, x in enumerate(r.ranks):
        per_it = {k: x["comm"][k] / it
                  for k in ("collectives", "wire_bytes")}
        ranks.append(dict(
            rank=rank, run_s=x["seconds"], block_s=x["block_s"],
            pseudo_supersteps=int(x["pseudo_supersteps"].sum()),
            host_syncs=x["host_syncs"], launches=x["launches"],
            collectives_per_iteration=per_it["collectives"],
            exchange_bytes_per_iteration=per_it["wire_bytes"],
            staged_bytes=x["comm"]["staged_bytes"],
            peak_device_GiB=x["peak_device_bytes"] / 2**30))
        say("dist", app=app, rank=rank, wire=str(wire),
            run_s=f"{x['seconds']:.3f}", block_s=f"{x['block_s']:.3f}",
            pseudo_supersteps=ranks[-1]["pseudo_supersteps"],
            host_syncs=x["host_syncs"],
            launches=json.dumps(x["launches"]).replace(" ", ""),
            collectives_per_iteration=f"{per_it['collectives']:.3f}",
            exchange_bytes_per_iteration=f"{per_it['wire_bytes']:.0f}",
            staged_bytes=x["comm"]["staged_bytes"],
            peak_device_GiB=f"{ranks[-1]['peak_device_GiB']:.2f}")
    say("dist", app=app, world=DIST_WORLD, backend="gloo", wire=str(wire),
        iterations=it, seconds=f"{secs:.2f}", share_s=f"{r.share_s:.2f}",
        run_s=f"{max(x['run_s'] for x in ranks):.3f}")
    return r, dict(iterations=it, seconds=secs, share_s=r.share_s,
                   ranks=ranks)


def phase_dist(sssp_graph, sssp_data, sssp_es, sssp_dijkstra, pr_data,
               pr_part):
    """The distributed hybrid step at world 4 on both full-size graphs:
    each held bit for bit against ``run_hybrid`` on the card on the same
    ``edge_blocks=4`` graph (the whole engine state, iterations, every
    counter, per-partition pseudo-supersteps), with ``ell_spmv`` and
    ``min_step`` (SSSP) or ``pr_step`` and ``ell_spmv`` (PageRank)
    launched inside every rank, and each kernel once at a rank's block
    shapes against its plain version.  SSSP is also held to ``main``'s
    distances (a min fixed point does not depend on the layout).

    Then SSSP over a bfloat16 wire, traced (one ``dist_step`` span per
    iteration), stopped after ``DIST_BF16_MAX_ITERS`` iterations; its
    error against Dijkstra is printed, not held.  Every partition
    crossing rounds a distance to 8 significant bits: on this grid's
    distances (to ~12,700, where bf16 values are 64 apart) a crossing
    can round a distance down by up to 32, more than a round trip's
    edge weights (2 to 20), so each echo across a cut lowers distances
    below the true ones and the run does not reach quiescence — the
    error is the wire's, and no fixed tolerance states it."""
    import numpy as np
    import torch
    from repro_torch import IncrementalPageRank, SSSP, unpack_vertex
    from repro_torch.convert import to_numpy
    from repro_torch.core.distributed import block_view

    graphs = dist_graphs(sssp_data, pr_data, pr_part)
    makes = {"sssp": lambda: SSSP(source=0),
             "pagerank": lambda: IncrementalPageRank(tolerance=PR_TOL)}
    need = {"sssp": ("ell_spmv", "min_step"),
            "pagerank": ("pr_step", "ell_spmv")}
    out = {}
    for app in ("sssp", "pagerank"):
        graph = graphs[app]
        card = block_view(graph, 0, 1, DIST_DEVICE)
        es, host = run_counted("dist", app, "hybrid", card, makes[app]())
        want = to_numpy(es)
        kernels = dist_kernel_checks(app, graph, makes[app](), es)
        del card, es
        torch.cuda.empty_cache()
        r, row = dist_run(app, graph, makes[app])
        same = _state_same(r.es, want) and \
            r.iterations == host["iterations"]
        idle = [(rank, k) for rank, x in enumerate(row["ranks"])
                for k in need[app] if not x["launches"][k]]
        row.update(host_run_s=host["run_s"], bit_identical_to_host=same,
                   kernels=kernels)
        if app == "sssp":
            got = unpack_vertex(graph, r.es.state["dist"])
            main = unpack_vertex(sssp_graph, sssp_es.state["dist"])
            row["bit_identical_to_main"] = bool(np.array_equal(
                got.view(np.uint32), main.view(np.uint32)))
        say("dist", app=app, bit_identical_to_host=same,
            bit_identical_to_main=row.get("bit_identical_to_main"),
            host_run_s=f"{host['run_s']:.3f}", idle=idle or None)
        out[app] = row
        if not same or row.get("bit_identical_to_main") is False:
            raise AssertionError(f"dist {app}: the ranks' run differs from "
                                 f"the single-process run")
        if idle:
            raise AssertionError(f"dist {app}: (rank, kernel) never "
                                 f"launched: {idle}")
        del r

    r, row = dist_run("sssp", graphs["sssp"], makes["sssp"],
                      wire_dtype=torch.bfloat16, trace=True,
                      max_iters=DIST_BF16_MAX_ITERS)
    got = unpack_vertex(graphs["sssp"], r.es.state["dist"])
    spans = [s for s in r.spans if s.name == "dist_step"]
    row.update(max_rel_err_vs_dijkstra=_rel_err(got, sssp_dijkstra),
               quiescent=r.iterations < DIST_BF16_MAX_ITERS,
               spans=len(spans),
               traced_exchange_bytes=[s.args["exchange_bytes"]
                                      for s in spans],
               pseudo_supersteps_per_iteration=[
                   sum(s.args["pseudo_supersteps_per_block"])
                   for s in spans])
    say("dist", app="sssp", wire="torch.bfloat16",
        max_rel_err_vs_dijkstra=f"{row['max_rel_err_vs_dijkstra']:.3e}",
        quiescent=row["quiescent"], dist_step_spans=len(spans),
        iterations=r.iterations,
        traced_exchange_bytes=sum(row["traced_exchange_bytes"]),
        pseudo_supersteps_per_iteration=json.dumps(
            row["pseudo_supersteps_per_iteration"]).replace(" ", ""))
    if len(spans) != r.iterations or not np.isfinite(got).all():
        raise AssertionError(f"dist bf16: {len(spans)} dist_step spans for "
                             f"{r.iterations} iterations, or distances "
                             f"not finite")
    out["sssp_bf16"] = row
    return out


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
# lanes take a second lane chunk of four; sixteen, the serving layer's
# widest batch, four chunks.
SWEEP_SPMV = ((7, 512, (0, 4, 16)), (8, 512, (0, 4, 16)),
              (16, 512, (0, 4, 16)), (128, 512, (0, 4, 6, 16)),
              (128, 40000, (0, 4, 6, 16)), (300, 256, (0, 4, 6, 16)),
              (7056, 32, (0, 4, 6, 16)), (32897, 8, (0, 6, 16)))
SWEEP_MIN_STEP = ((7, 512), (8, 512), (16, 512))
SWEEP_MIN_STEP_LANES = (0, 4, 16)
# (K, rows, frontier lanes) of the pr_step tiles: the rows path
# (K = 8 and 16 on an (N,) frontier, also over 600,001 rows: thousands of
# warps of every fill) and the thread-per-(row, lane) path (K = 7 and 300 with its
# ragged last fold block, every lane frontier).  Row counts are not
# multiples of 32.  Each tile also lies one row into a larger buffer
# (still aligned at K = 8 and 16) and one element in (misaligned: the
# thread path).
SWEEP_PR_STEP = ((7, 517, (0, 4, 6, 16)), (8, 517, (0, 4, 6, 16)),
                 (16, 517, (0, 4, 6, 16)), (300, 517, (0, 4, 6, 16)),
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
    semiring, (N,), (N, 4), (N, 6) and (N, 16) frontiers (``SWEEP_SPMV``,
    ``SWEEP_MIN_STEP_LANES``, ``SWEEP_PR_STEP``), 1 %, 50 %, 100 %
    occupancy and
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
            for m in ("zeros", "infs") for L in SWEEP_MIN_STEP_LANES):
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
              x_is_row=False, lanes=1):
    """Least time for the work these inputs need, over the HBM rate: each
    mask byte, the idx/val words of occupied slots, ``rows_bytes`` of row
    operands and outputs per row, and the frontier entries of the distinct
    sources of occupied slots.  A plain product reads a 4-byte value per
    source and lane.  A fused step (``flag``: its send flags, one per
    source and lane) reads a flag byte per source and lane and the value
    only where the flag is set; where the value vector is also the row
    operand (``x_is_row``, the engine's ``xrow = x``) those words are
    already counted per row.  Against that, the per-slot operations of
    every lane over the float32 rate."""
    import torch
    nnz = int(msk.sum())
    src = torch.unique(idx[msk])
    rows = idx.shape[0]
    nbytes = msk.numel() + 8 * nnz + rows_bytes * rows
    if flag is None:
        nbytes += 4 * lanes * src.numel()
    else:
        nbytes += lanes * src.numel()
        if not x_is_row:
            nbytes += 4 * int(flag[src.long()].sum())
    ops = ops_per_slot * nnz * lanes
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

    # --- the serving shapes: (N, 16) frontiers on the base bins ----------
    L = SERVE_LANES
    s = sssp_graph.local_ell[0]
    _, idx, msk = slice_flat(s, sssp_graph, sssp_graph.n_partitions)
    val = s.val.reshape(-1, s.kb)
    xl = torch.rand((idx.shape[0], L), generator=gen, device="cuda") * 100
    sl = rand_send(xl.shape)
    timed["min_step_L16"] = case(
        "min_step", f"sssp local base {tuple(idx.shape)}, L={L}",
        fused_min_step, (idx, val, msk, xl, sl, xl,
                         torch.full_like(xl, float("inf"))),
        fused_min_step_ref,
        _bound_ms(msk, idx, 17 * L, 2, flag=sl, x_is_row=True, lanes=L))
    timed["ell_spmv_L16_grid"] = case(
        "ell_spmv", f"sssp local base {tuple(idx.shape)}, L={L}",
        lambda *a: ell_spmv(*a, semiring="min_add"), (idx, val, msk, xl),
        lambda *a: ell_spmv_ref(*a, semiring="min_add"),
        _bound_ms(msk, idx, 4 * L, 2, lanes=L))
    del xl, sl
    s = pr_graph.local_ell[0]
    _, idx, msk = slice_flat(s, pr_graph, pr_graph.n_partitions)
    val = pr_prog.ell_edge_values(pr_prog.channels[0], s.val).reshape(
        -1, s.kb)
    dl = torch.rand((idx.shape[0], L), generator=gen, device="cuda") * 1e-3
    rl = torch.rand((idx.shape[0], L), generator=gen, device="cuda")
    sl = rand_send(dl.shape)
    timed["pr_step_L16"] = case(
        "pr_step", f"pagerank local base {tuple(idx.shape)}, L={L}",
        lambda *a: fused_pr_step(*a, **pr_kw),
        (idx, val, msk, dl, sl, rl, torch.zeros_like(dl)),
        lambda *a: fused_pr_step_ref(*a, **pr_kw),
        _bound_ms(msk, idx, 17 * L, 3, flag=sl, lanes=L))
    xd = torch.where(sl, dl, 0.0).contiguous()
    timed["ell_spmv_L16_rmat"] = case(
        "ell_spmv", f"pagerank local base {tuple(idx.shape)}, L={L}",
        lambda *a: ell_spmv(*a, semiring="add_mul"), (idx, val, msk, xd),
        lambda *a: ell_spmv_ref(*a, semiring="add_mul"),
        _bound_ms(msk, idx, 4 * L, 2, lanes=L),
        library=torch.sparse.mm,
        lib_ops=(_csr_library(idx, val, msk, xd.shape[0]), xd))
    del dl, rl, sl, xd

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


def _profiled(fn, top: int):
    """``fn()`` under ``torch.profiler`` -> (wall s, device busy s, kernel
    launches, the ``top`` kernels by device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    table = [dict(kernel=e.key[:90], calls=e.count,
                  device_ms=e.self_device_time_total / 1e3)
             for e in sorted(rows, key=lambda e: e.self_device_time_total,
                             reverse=True)[:top]]
    return wall, busy, sum(e.count for e in rows), table


def phase_profile(app, graph, prog, iters):
    """Where the time goes: the first ``iters`` global iterations of the
    main path under ``torch.profiler`` — device busy share of the wall time
    and the kernels (ours and PyTorch's glue) by device time."""
    from repro_torch import run_hybrid

    wall, busy, launches, table = _profiled(
        lambda: run_hybrid(graph, prog, max_iters=iters), 12)
    say("profile", app=app, iterations=iters, wall_s=f"{wall:.3f}",
        device_busy_s=f"{busy:.3f}",
        idle_share=f"{1 - busy / wall:.3f}" if launches else "not captured")
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
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
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


APPS_CONFIGS = [(engine, use_ell) for engine in ("bsp", "am", "hybrid")
                for use_ell in (True, False)]


def phase_apps(sssp_graph, sssp_data):
    """WCC on the full-size grid against scipy, then every other app on
    the card through all three engines × {ell, dense}, with launches per
    kernel per app; one configuration per app (the i-th app the i-th of
    ``APPS_CONFIGS``, round robin, so each configuration is held) again
    on the host, bit for bit.  The CPU tests hold every app × engine ×
    delivery against the reference.  Fails unless ``min_step`` ran under
    a semiring other than ``min_add`` and ``pr_step`` ran with lanes."""
    from repro_torch import run_am, run_bsp, run_hybrid
    from repro_torch.kernels.common import LAUNCHES

    runners = {"hybrid": run_hybrid, "bsp": run_bsp, "am": run_am}
    t0 = time.perf_counter()
    wcc = check_wcc_grid(sssp_graph, sssp_data)
    card, host = apps_workloads("cuda"), apps_workloads("cpu")
    rows = {}
    for i, (app, (graph, make, vdata)) in enumerate(card.items()):
        hgraph, _, hvdata = host[app]
        launches = {k: 0 for k in LAUNCHES}
        per_config = {}
        held = APPS_CONFIGS[i % len(APPS_CONFIGS)]
        t = time.perf_counter()
        for engine, use_ell in APPS_CONFIGS:
            es, run = run_counted("apps", app, engine, graph, make(),
                                  use_ell=use_ell, vdata=vdata, quiet=True)
            label = f"{engine}-{'ell' if use_ell else 'dense'}"
            per_config[label] = dict(iterations=run["iterations"],
                                     launches=run["launches"])
            for k, v in run["launches"].items():
                launches[k] += v
            if (engine, use_ell) != held:
                continue
            got = _run_snapshot(es, run["iterations"])
            want = _run_snapshot(*runners[engine](
                hgraph, make(), vdata=hvdata, use_ell=use_ell,
                device="cpu"))
            same = got[0] == want[0] and _tree_same(got[1], want[1])
            per_config[label]["bit_identical"] = same
            if not same:
                raise AssertionError(f"{app} {label}: card and host "
                                     f"runs differ")
        secs = time.perf_counter() - t
        say("apps", app=app, configs=len(per_config), bit_identical=True,
            host_held=f"{held[0]}-{'ell' if held[1] else 'dense'}",
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
# checkpoint cadence of the stop-and-resume half: PageRank's 192 MB
# checkpoints every 5th iteration (the stop at 25 lands on one)
FT_EVERY = {"sssp": 1, "pagerank": 5}


def _counted(fn):
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
    ``resume=True``, checkpointing every ``FT_EVERY[app]`` iterations;
    (b) one call with worker 1 of 4 killed and ``checkpoint_every=3``.  Both must end on ``want`` (a numpy snapshot of
    the ``main`` run's final state) bit for bit, counters included."""
    from repro_torch.checkpoint import (AsyncCheckpointer, latest_checkpoint,
                                        load_checkpoint, read_manifest)
    from repro_torch.exec.iteration import init_hybrid
    from repro_torch.ft import FaultInjector, FaultPlan, run_hybrid_ft

    k, kill_tick = FT_PLAN[app]
    every = FT_EVERY[app]
    ck = AsyncCheckpointer(os.path.join(base, app, "a"), keep=3,
                           codec="raw")
    r1, s1, l1, h1 = _counted(lambda: run_hybrid_ft(
        graph, make(), checkpointer=ck, checkpoint_every=every,
        max_iters=k))
    path = latest_checkpoint(ck.base)
    step_a = read_manifest(path)["step"]    # before the resume's GC drops it
    template = init_hybrid(graph, make(), None)
    t = time.perf_counter()
    load_checkpoint(path, template)
    sync()
    restore_s = time.perf_counter() - t
    del template
    r2, s2, l2, h2 = _counted(lambda: run_hybrid_ft(
        graph, make(), checkpointer=ck, checkpoint_every=every,
        resume=True))
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
        checkpoint_every=every, checkpoints=ck_a, checkpoint_bytes=ck.bytes_written,
        snapshot_s=f"{ck.save_seconds:.3f}",
        write_s=f"{ck.write_seconds:.3f}", restore_s=f"{restore_s:.3f}",
        iterations_lost=lost_a, host_syncs=h1 + h2,
        launches=json.dumps(launches_a).replace(" ", ""),
        bit_identical_to_main=same_a)
    del r1, r2
    ck = AsyncCheckpointer(os.path.join(base, app, "b"), keep=3,
                           codec="raw")
    inj = FaultInjector(FaultPlan.kill_at(kill_tick, worker=1), n_workers=4)
    rb, sb, lb, hb = _counted(lambda: run_hybrid_ft(
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
        kill_resume=dict(killed_at=k, checkpoint_every=every,
                         seconds=[s1, s2], **written_a,
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
    if lost_a != 0 or ck_a != want_iters // every:
        raise AssertionError(f"ft {app}: the resume lost {lost_a} "
                             f"iterations and {ck_a} checkpoints were "
                             f"written, want 0 and {want_iters // every}")
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


# --------------------------------------------------------------------------
# serve: K-lane graph queries through ServeEngine on both full-size graphs
# --------------------------------------------------------------------------

SERVE_STREAM = 4          # queries of the streamed and the killed batch
SERVE_CKPT_EVERY = 2      # the killed batch's checkpoint cadence
PPR_ORACLE_ITERS = 60     # personalized power iteration: 0.85^60 < 6e-5
# the ppr queries' tolerance: a lane's mass is 1 and Algorithm 5 keeps
# every delta at or below the tolerance from propagating, so a lane's
# error follows its tolerance; the held queries use 1e-7, and the
# program's default (None: 1e-4) and 1e-5 are run and printed beside it
SERVE_PPR_TOL = 1e-7
PPR_TOL_PRINTED = (None, 1e-5)
ORACLE_WORKERS = 4


def serve_sources():
    """The grid's 16 serving sources from a fixed seed; the first is vertex
    0, the ``main`` run's source."""
    import numpy as np
    n = GRID_SIDE * GRID_SIDE
    grid = [0] + np.random.default_rng(11).choice(
        np.arange(1, n), SERVE_LANES - 1, replace=False).tolist()
    return grid


def _oracle_csr(path, rows, cols, vals, n):
    """An n x n CSR matrix saved for the oracle workers."""
    import numpy as np
    from scipy.sparse import csr_matrix
    m = csr_matrix((vals, (rows, cols)), shape=(n, n))
    np.savez(path, data=m.data, indices=m.indices, indptr=m.indptr,
             n=np.int64(n))


def _load_csr(path):
    import numpy as np
    from scipy.sparse import csr_matrix
    z = np.load(path)
    n = int(z["n"])
    return csr_matrix((z["data"], z["indices"], z["indptr"]), shape=(n, n))


def _oracle_dijkstra(csr_path, sources, out_path):
    """Worker: scipy's Dijkstra from ``sources`` -> (len, n) float64."""
    import numpy as np
    from scipy.sparse.csgraph import dijkstra
    np.save(out_path, dijkstra(_load_csr(csr_path), indices=list(sources)))
    return out_path


def _oracle_ppr(csr_path, seeds, iters, out_path):
    """Worker: personalized power iteration, one column per seed:
    ``R = 0.15 E + A R`` with ``A = 0.85 / outdeg(src)`` at (dst, src),
    ``PPR_ORACLE_ITERS`` times -> (n, len) float64."""
    import numpy as np
    a = _load_csr(csr_path)
    e = np.zeros((a.shape[0], len(seeds)))
    e[list(seeds), np.arange(len(seeds))] = 0.15
    r = e.copy()
    for _ in range(iters):
        r = e + a @ r
    np.save(out_path, r)
    return out_path


def start_oracles(pool, wd, sssp_data, pr_data, grid_src, ppr_seeds):
    """Submit the serving phase's oracles to ``pool`` (spawned worker
    processes, so they run beside the card's work): Dijkstra for the 16
    grid sources and the personalized power iteration for the 16 R-MAT
    seeds, four lanes a worker.  Returns the futures of each."""
    import numpy as np
    edges, w, n = sssp_data
    grid_csr = os.path.join(wd, "grid_csr.npz")
    _oracle_csr(grid_csr, edges[:, 0], edges[:, 1], w.astype(np.float64),
                n)
    pe, _, pn = pr_data
    deg = np.maximum(np.bincount(pe[:, 0], minlength=pn), 1)
    rmat_csr = os.path.join(wd, "rmat_csr.npz")
    _oracle_csr(rmat_csr, pe[:, 1], pe[:, 0], 0.85 / deg[pe[:, 0]], pn)
    chunk = SERVE_LANES // ORACLE_WORKERS
    dij = [pool.submit(_oracle_dijkstra, grid_csr, grid_src[i:i + chunk],
                       os.path.join(wd, f"dij{i}.npy"))
           for i in range(0, SERVE_LANES, chunk)]
    ppr = [pool.submit(_oracle_ppr, rmat_csr, ppr_seeds[i:i + chunk],
                       PPR_ORACLE_ITERS, os.path.join(wd, f"ppr{i}.npy"))
           for i in range(0, SERVE_LANES, chunk)]
    return dij, ppr


def _serve_counted(label, fn, n_queries, K):
    """``fn()`` (a dispatch) counted as ``_counted`` counts, with its
    launches with L > 1 apart and the card's peak memory."""
    import torch
    from repro_torch.kernels.common import LANE_LAUNCHES
    sync()
    torch.cuda.reset_peak_memory_stats()
    out, secs, launches, syncs = _counted(fn)
    row = dict(batch=label, K=K, queries=n_queries, seconds=secs,
               queries_per_s=n_queries / secs,
               peak_device_GiB=torch.cuda.max_memory_allocated() / 2**30,
               host_syncs=syncs, launches=launches,
               lane_launches=dict(LANE_LAUNCHES))
    return out, row


def _say_batch(row):
    say("serve", batch=row["batch"], K=row["K"], queries=row["queries"],
        iterations=row["iterations"], seconds=f"{row['seconds']:.3f}",
        queries_per_s=f"{row['queries_per_s']:.2f}",
        peak_device_GiB=f"{row['peak_device_GiB']:.2f}",
        host_syncs=row["host_syncs"],
        launches=json.dumps(row["launches"]).replace(" ", ""),
        launches_L_gt_1=json.dumps(row["lane_launches"]).replace(" ", ""))


def _killer(kill_at):
    class Killed(RuntimeError):
        pass

    def kill(engine, program, K, iteration):
        if iteration == kill_at:
            raise Killed(f"injected kill at iteration {iteration}")
    return kill, Killed


def serve_grid(graph, want0, grid_src, wd, rows):
    """The grid's batches: 16 sssp queries as one K = 16 batch (the source-0
    lane against ``main``'s distances), a solo query, a streamed K = 4
    batch, and the same K = 4 batch checkpointed, killed and resumed by a
    fresh engine.  Returns the K = 16 results and the checks."""
    from repro_torch.obs.metrics import load_registry
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(graph, lane_widths=SERVE_WIDTHS,
                      stats_dir=os.path.join(wd, "grid_stats"))
    qs = [eng.submit("sssp", s) for s in grid_src]
    _, row = _serve_counted("grid sssp", eng.run, len(qs), SERVE_LANES)
    row["iterations"] = qs[0].iterations
    _say_batch(row)
    rows.append(row)
    lane0 = _tree_same(qs[0].result, want0)
    solo_j = 5
    solo = eng.submit("sssp", grid_src[solo_j])
    _, row = _serve_counted("grid sssp solo", eng.run, 1, 1)
    row["iterations"] = solo.iterations
    _say_batch(row)
    rows.append(row)
    solo_ok = _tree_same(solo.result, qs[solo_j].result)

    picks = list(range(1, 1 + SERVE_STREAM))
    for j in picks:
        eng.submit("sssp", grid_src[j])
    got, row = _serve_counted("grid sssp stream", lambda: list(eng.stream()),
                              SERVE_STREAM, SERVE_STREAM)
    row["iterations"] = max(q.iterations for q in got)
    _say_batch(row)
    rows.append(row)
    by_src = {grid_src[j]: qs[j] for j in picks}
    stream_iters = [q.iterations for q in got]
    stream_ok = (sorted(q.source for q in got) ==
                 sorted(grid_src[j] for j in picks)
                 and stream_iters == sorted(stream_iters)
                 and all(_tree_same(q.result, by_src[q.source].result)
                         for q in got))
    say("serve", check="grid", source0_lane_bit_identical_to_main=lane0,
        solo_bit_identical_to_lane=solo_ok,
        stream_order=",".join(f"{q.source}@{q.iterations}" for q in got),
        stream_bit_identical_to_run=stream_ok)
    compiles = eng.trace_counts

    # the streamed batch again, checkpointed every SERVE_CKPT_EVERY
    # iterations: killed after the first checkpoint past its first lane's
    # convergence, resumed by a fresh engine
    its = {q.source: q.iterations for q in got}
    first = min(its.values())
    ck = -(-first // SERVE_CKPT_EVERY) * SERVE_CKPT_EVERY
    if ck >= max(its.values()):
        ck = SERVE_CKPT_EVERY
    kill_at = ck + 1
    ckdir = os.path.join(wd, "grid_ck")
    kill, killed_exc = _killer(kill_at)
    batch = [grid_src[j] for j in picks]
    k_eng = ServeEngine(graph, lane_widths=SERVE_WIDTHS, ckpt_dir=ckdir,
                        checkpoint_every=SERVE_CKPT_EVERY, on_iteration=kill)
    for s in batch:
        k_eng.submit("sssp", s)
    t = time.perf_counter()
    try:
        k_eng.run()
        killed = False
    except killed_exc:
        killed = True
    killed_s = time.perf_counter() - t
    r_eng = ServeEngine(graph, lane_widths=SERVE_WIDTHS, ckpt_dir=ckdir,
                        checkpoint_every=SERVE_CKPT_EVERY)
    rq = [r_eng.submit("sssp", s) for s in batch]
    _, row = _serve_counted("grid sssp resumed", r_eng.run, SERVE_STREAM,
                            SERVE_STREAM)
    row["iterations"] = rq[0].iterations
    row["killed_s"] = killed_s
    _say_batch(row)
    rows.append(row)
    events = r_eng.resume_events
    ev = events[0] if len(events) == 1 else None
    want_done = tuple(its[s] <= ck for s in batch)
    resume_ok = (killed and ev is not None and ev.iteration == ck
                 and ev.lanes_done == want_done
                 and all(_tree_same(q.result, by_src[q.source].result)
                         for q in rq))
    left = sorted(os.listdir(ckdir))
    say("serve", check="kill-resume", killed_at=kill_at, killed_s=
        f"{killed_s:.3f}", resumed_at=ev and ev.iteration,
        lanes_done=ev and ",".join(str(int(b)) for b in ev.lanes_done),
        bit_identical_to_uninterrupted=resume_ok, left_in_ckpt_dir=left)
    reg = load_registry(eng.stats_path)
    compiles_ok = all(reg.value(f"serve.compiles.sssp.K{k}") == 1.0
                      for k in (1, SERVE_STREAM, SERVE_LANES)) and \
        all(v == 1 for e in (eng, k_eng, r_eng)
            for v in e.trace_counts.values())
    checks = dict(source0_lane_bit_identical_to_main=lane0,
                  solo_bit_identical_to_lane=solo_ok,
                  stream_bit_identical_to_run=stream_ok,
                  stream_iterations=stream_iters,
                  kill_resume_bit_identical=resume_ok,
                  resume_event=_event_dict(ev),
                  ckpt_family_deleted=left == ["serve_stats.json"],
                  compiles={f"{k[0]}.K{K}": v for (k, K), v in
                            compiles.items()},
                  compiles_one_each=compiles_ok)
    return qs, checks


def serve_rmat(graph, seeds, wd, rows):
    """16 ppr seeds on R-MAT as one K = 16 batch, and one seed's K = 1
    dispatch, which must equal its lane bit for bit."""
    from repro_torch.obs.metrics import load_registry
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(graph, lane_widths=SERVE_WIDTHS,
                      stats_dir=os.path.join(wd, "rmat_stats"))
    qs = [eng.submit("ppr", s, tolerance=SERVE_PPR_TOL) for s in seeds]
    _, row = _serve_counted("rmat ppr", eng.run, len(qs), SERVE_LANES)
    row["iterations"] = qs[0].iterations
    _say_batch(row)
    rows.append(row)
    j = 3
    solo = eng.submit("ppr", seeds[j], tolerance=SERVE_PPR_TOL)
    _, row = _serve_counted("rmat ppr solo", eng.run, 1, 1)
    row["iterations"] = solo.iterations
    _say_batch(row)
    rows.append(row)
    solo_ok = _tree_same(solo.result, qs[j].result)
    reg = load_registry(eng.stats_path)
    compiles_ok = all(reg.value(f"serve.compiles.ppr.K{k}") == 1.0
                      for k in (1, SERVE_LANES))
    say("serve", check="rmat", solo_bit_identical_to_lane=solo_ok,
        compiles_one_each=compiles_ok)
    # the same seeds at the tolerances a user gets by default, for the
    # printed (not held) oracle errors
    loose = ServeEngine(graph, lane_widths=SERVE_WIDTHS)
    by_tol = {tol: [loose.submit("ppr", s, **({} if tol is None else
                                             {"tolerance": tol}))
                    for s in seeds]
              for tol in PPR_TOL_PRINTED}
    loose.run()
    return qs, by_tol, dict(solo_bit_identical_to_lane=solo_ok,
                            compiles_one_each=compiles_ok)


def phase_serve(sssp_graph, sssp_data, sssp_es, pr_graph, pr_data):
    """``ServeEngine`` on both full-size graphs: grid sssp batches (K = 16,
    solo, streamed, killed and resumed) and R-MAT ppr batches (K = 16,
    solo), every lane against its oracle (computed by worker processes
    beside the card's work), the persisted registry's compile counts, and
    every kernel launched with L > 1."""
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    import numpy as np
    import torch
    from repro_torch import unpack_vertex

    t0 = time.perf_counter()
    grid_src = serve_sources()
    pe, _, pn = pr_data
    senders = np.flatnonzero(np.bincount(pe[:, 0], minlength=pn))
    seeds = np.random.default_rng(12).choice(senders, SERVE_LANES,
                                             replace=False).tolist()
    rows = []
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wd, \
            ProcessPoolExecutor(
                ORACLE_WORKERS,
                mp_context=multiprocessing.get_context("spawn")) as pool:
        t = time.perf_counter()
        dij_f, ppr_f = start_oracles(pool, wd, sssp_data, pr_data, grid_src,
                                     seeds)
        oracle_setup_s = time.perf_counter() - t
        want0 = unpack_vertex(sssp_graph, sssp_es.state["dist"])
        digest, digest_s = _timed_digest(sssp_graph)
        grid_qs, grid_checks = serve_grid(sssp_graph, want0, grid_src, wd,
                                          rows)
        del want0
        torch.cuda.empty_cache()
        rmat_qs, by_tol, rmat_checks = serve_rmat(pr_graph, seeds, wd,
                                                  rows)
        torch.cuda.empty_cache()
        t = time.perf_counter()
        dij = np.concatenate([np.load(f.result()) for f in dij_f])
        ppr = np.concatenate([np.load(f.result()) for f in ppr_f], axis=1)
        oracle_wait_s = time.perf_counter() - t
    sssp_err, ppr_err, ppr_max = 0.0, 0.0, 0.0
    for j, q in enumerate(grid_qs):
        if not np.isfinite(q.result).all():
            raise AssertionError(f"serve: sssp lane {j} not finite")
        np.testing.assert_allclose(q.result, dij[j], rtol=1e-4)
        sssp_err = max(sssp_err, float(np.max(
            np.abs(q.result - dij[j]) / np.maximum(dij[j], 1e-30))))
    for j, q in enumerate(rmat_qs):
        if not np.isfinite(q.result).all():
            raise AssertionError(f"serve: ppr lane {j} not finite")
        np.testing.assert_allclose(q.result, ppr[:, j], rtol=2e-3,
                                   atol=5e-3)
        ppr_err = max(ppr_err, float(np.max(np.abs(q.result - ppr[:, j]))))
        ppr_max = max(ppr_max, float(ppr[:, j].max()))
    say("serve", oracle="sssp dijkstra", lanes=len(grid_qs),
        max_rel_err=f"{sssp_err:.3e}")
    say("serve", oracle="ppr power iteration", lanes=len(rmat_qs),
        max_abs_err=f"{ppr_err:.3e}", max_rank=f"{ppr_max:.4f}",
        oracle_setup_s=f"{oracle_setup_s:.2f}",
        oracle_wait_s=f"{oracle_wait_s:.2f}")
    from repro_torch.core.apps.multi import PersonalizedPageRank
    ppr_by_tol = {}
    for tol, qs in by_tol.items():
        tol = PersonalizedPageRank(lanes=1).tol if tol is None else tol
        err = max(float(np.max(np.abs(q.result - ppr[:, j])))
                  for j, q in enumerate(qs))
        inside = sum(bool(np.allclose(q.result, ppr[:, j], rtol=2e-3,
                                      atol=5e-3)) for j, q in enumerate(qs))
        ppr_by_tol[tol] = dict(iterations=qs[0].iterations,
                               max_abs_err=err, lanes_inside_oracle=inside)
        say("serve", oracle="ppr power iteration", tolerance=f"{tol:g}",
            lanes=len(qs), iterations=qs[0].iterations,
            max_abs_err=f"{err:.3e}", lanes_inside_oracle_tol=inside,
            held=False)
    lane_launches = {k: sum(r["lane_launches"][k] for r in rows)
                     for k in KERNELS}
    secs = time.perf_counter() - t0
    say("serve", graph_digest_s=f"{digest_s:.3f}",
        lane_launches=json.dumps(lane_launches).replace(" ", ""),
        phase_s=f"{secs:.1f}")
    checks = dict(grid=grid_checks, rmat=rmat_checks)
    bad = [k for k, v in {**grid_checks, **{f"rmat_{k}": v for k, v in
                                            rmat_checks.items()}}.items()
           if v is False]
    if bad:
        raise AssertionError(f"serve: checks failed: {bad}")
    idle = [k for k, v in lane_launches.items() if not v]
    if idle:
        raise AssertionError(f"serve: never launched with L > 1: {idle}")
    return dict(batches=rows, checks=checks, lane_launches=lane_launches,
                sssp_oracle_max_rel_err=sssp_err,
                ppr_oracle_max_abs_err=ppr_err, ppr_by_tolerance=ppr_by_tol,
                graph_digest_s=digest_s,
                oracle_setup_s=oracle_setup_s, oracle_wait_s=oracle_wait_s,
                phase_s=secs)


# --------------------------------------------------------------------------
# obs: tracing, the phased profiler, a traced FT run and the report CLI
# --------------------------------------------------------------------------

def _schema_check(doc):
    """The Chrome trace-event schema ``tests/test_obs.py`` holds the
    reference's export to: complete and instant events with name, cat,
    ts, pid and tid, durations >= 0, timestamps monotone per track."""
    evs = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    ok = bool(evs)
    by_track = {}
    for e in evs:
        ok = ok and e["ph"] in ("X", "i") and all(
            f in e for f in ("name", "cat", "ts", "pid", "tid")) and \
            isinstance(e["ts"], (int, float)) and \
            (e["ph"] != "X" or e["dur"] >= 0)
        by_track.setdefault((e["pid"], e["tid"]), []).append(e["ts"])
    return ok and all(ts == sorted(ts) for ts in by_track.values())


def obs_traced(app, graph, make, want):
    """``run_engine`` (hybrid, ELL) with ``trace_hooks(Tracer())``: state
    and counters against ``main``'s, one superstep span per iteration, the
    span deltas summed against the run's counters past its init, and the
    Chrome trace written under ``build/`` against the schema."""
    from repro_torch.exec.driver import run_engine
    from repro_torch.exec.policy import make_policy
    from repro_torch.obs.export import write_chrome_trace
    from repro_torch.obs.trace import Tracer, trace_hooks

    policy = make_policy("hybrid")
    prog = make()
    es0 = policy.init(graph, prog, None)
    c0 = {f: int(getattr(es0.counters, f)) for f in
          ("net_messages", "net_local_messages", "mem_messages")}
    tracer = Tracer()
    tracer.name_track(0, app)
    sync()
    t = time.perf_counter()
    ctx = run_engine(graph, prog, policy, es=es0, hooks=trace_hooks(tracer))
    sync()
    secs = time.perf_counter() - t
    same = _state_same(ctx.es, want)
    steps = [s for s in tracer.spans if s.cat == "superstep"]
    c = ctx.es.counters
    sums = all(sum(s.args[f] for s in steps) == int(getattr(c, f)) - c0[f]
               for f in c0) and \
        sum(s.args["pseudo_supersteps"] for s in steps) == \
        int(c.pseudo_supersteps.sum())
    path = os.path.join(ROOT, "build", f"obs_trace_{app}.json")
    write_chrome_trace(tracer, path)
    with open(path) as f:
        schema = _schema_check(json.load(f))
    span_s = sum(s.dur for s in steps)
    say("obs", run="traced", app=app, iterations=ctx.iteration,
        spans=len(steps), run_s=f"{secs:.3f}", span_s=f"{span_s:.3f}",
        exchange_bytes=sum(s.args["exchange_bytes"] for s in steps),
        bit_identical_to_main=same, span_sums_equal_counters=sums,
        trace=os.path.relpath(path, ROOT), schema_ok=schema)
    ok = same and sums and schema and len(steps) == ctx.iteration
    if not ok:
        raise AssertionError(f"obs traced {app}: state {same}, spans "
                             f"{len(steps)}/{ctx.iteration}, sums {sums}, "
                             f"schema {schema}")
    return dict(iterations=ctx.iteration, run_s=secs, span_s=span_s,
                bit_identical=same, span_sums_equal_counters=sums,
                schema_ok=schema)


def obs_phased(app, engine, graph, make, want):
    """``phased_run`` (ELL): seconds per phase summed over the supersteps,
    barriers, exchange bytes and the mean local-compute fraction; the
    final state and counters against ``want``."""
    from repro_torch.obs.trace import phased_run

    sync()
    t = time.perf_counter()
    res = phased_run(graph, make(), engine, None, use_ell=True)
    secs = time.perf_counter() - t
    same = _state_same(res.es, want)
    phases = {}
    for r in res.records:
        for k, v in r.phase_seconds.items():
            phases[k] = phases.get(k, 0.0) + v
    say("obs", run="phased", app=app, engine=engine,
        supersteps=res.iterations, barriers=res.total_barriers,
        exchange_bytes=res.total_exchange_bytes,
        phase_s=json.dumps({k: round(v, 4) for k, v in phases.items()})
        .replace(" ", ""),
        local_compute_fraction=f"{res.mean_local_compute_fraction:.3f}",
        run_s=f"{secs:.3f}", bit_identical=same)
    if not same:
        raise AssertionError(f"obs phased {app} {engine}: final state "
                             f"differs from the fused engine's")
    return dict(supersteps=res.iterations, barriers=res.total_barriers,
                exchange_bytes=res.total_exchange_bytes,
                phase_seconds=phases,
                local_compute_fraction=res.mean_local_compute_fraction,
                run_s=secs, bit_identical=same)


def obs_ft(graph, want, wd):
    """``run_hybrid_ft`` on the grid with a tracer, a registry and worker 1
    of 4 killed: one ``recovery`` span, the flags read off the registry
    equal to the flags from the counters, the final state ``main``'s."""
    from repro_torch import SSSP
    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.ft import (FaultInjector, FaultPlan, flag_slow_shards,
                                run_hybrid_ft)
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer

    tracer, reg = Tracer(), MetricsRegistry()
    ck = AsyncCheckpointer(os.path.join(wd, "ft"), keep=3, codec="raw")
    inj = FaultInjector(FaultPlan.kill_at(FT_PLAN["sssp"][1], worker=1),
                        n_workers=4)
    t = time.perf_counter()
    res = run_hybrid_ft(graph, SSSP(source=0), checkpointer=ck,
                        checkpoint_every=3, n_workers=4, injector=inj,
                        tracer=tracer, registry=reg)
    secs = time.perf_counter() - t
    ck.close()
    rec = [s for s in tracer.spans if s.cat == "ft"]
    flags = flag_slow_shards(registry=res.registry)
    flags_ok = flags == res.straggler_flags
    same = _state_same(res.es, want)
    hooks = {}
    for s in tracer.spans:
        if s.cat == "hook":
            hooks[s.name] = hooks.get(s.name, 0.0) + s.dur
    say("obs", run="ft traced", recoveries=len(res.recoveries),
        recovery_spans=len(rec), flags=len(flags),
        flags_from_registry_equal=flags_ok,
        superstep_spans=sum(s.cat == "superstep" for s in tracer.spans),
        hook_s=json.dumps({k: round(v, 3) for k, v in hooks.items()})
        .replace(" ", ""), seconds=f"{secs:.3f}", bit_identical_to_main=same)
    if len(rec) != 1 or rec[0].name != "recovery" or not flags_ok or \
            not same:
        raise AssertionError(f"obs ft: {len(rec)} recovery spans, flags "
                             f"equal {flags_ok}, state {same}")
    return dict(recovery_spans=len(rec), recovery=dict(rec[0].args),
                flags=len(flags), flags_equal=flags_ok, hook_seconds=hooks,
                seconds=secs, bit_identical=same)


def obs_report():
    """``python -m repro_torch.obs.report`` in a subprocess: exit code 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs.report"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    secs = time.perf_counter() - t
    lines = [l for l in r.stdout.splitlines() if l.startswith(
        ("fixture", "[", "same", "global", "exchange", "local"))]
    for line in lines:
        say("obs", report=repr(line))
    say("obs", run="report", rc=r.returncode, seconds=f"{secs:.1f}")
    if r.returncode != 0:
        raise AssertionError(f"obs report exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    return dict(rc=r.returncode, seconds=secs, summary=lines)


def phase_obs(sssp_graph, sssp_want, pr_graph, pr_want):
    """Tracing on both full-size graphs, the phased profiler (hybrid on
    both, BSP on R-MAT), a traced FT run with one injected kill, and the
    report CLI."""
    import tempfile
    import torch
    from repro_torch import SSSP, IncrementalPageRank, run_bsp
    from repro_torch.convert import to_numpy

    t0 = time.perf_counter()
    sssp = lambda: SSSP(source=0)                           # noqa: E731
    pr = lambda: IncrementalPageRank(tolerance=PR_TOL)      # noqa: E731
    out = dict(traced=dict(
        sssp=obs_traced("sssp", sssp_graph, sssp, sssp_want),
        pagerank=obs_traced("pagerank", pr_graph, pr, pr_want)))
    torch.cuda.empty_cache()
    es, _ = run_bsp(pr_graph, pr())
    bsp_want = to_numpy(es)
    del es
    out["phased"] = dict(
        sssp_hybrid=obs_phased("sssp", "hybrid", sssp_graph, sssp,
                               sssp_want),
        pagerank_hybrid=obs_phased("pagerank", "hybrid", pr_graph, pr,
                                   pr_want),
        pagerank_bsp=obs_phased("pagerank", "bsp", pr_graph, pr, bsp_want))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wd:
        out["ft"] = obs_ft(sssp_graph, sssp_want, wd)
    torch.cuda.empty_cache()
    out["report"] = obs_report()
    secs = time.perf_counter() - t0
    say("obs", phase_s=f"{secs:.1f}")
    out["phase_s"] = secs
    return out


# --------------------------------------------------------------------------
# lm: the LM substrate — serving, then training, then every family
# --------------------------------------------------------------------------

LM_DEVICE = "cuda"
LM_CFG = DEMO_100M
LM_SERVE = dict(batch=4, prompt=256, max_len=288, decode=32)
LM_PROMPT_LENS = (256, 201, 130, 64)   # left-padded through ``start``
LM_TRAIN = dict(steps=100, batch=8, seq=256, peak_lr=3e-4, warmup=50,
                resume_at=50)
LM_TIMED_FROM = 10        # ms per step over the steps after the first 10
# the loss must fall: the mean of the last 10 steps below ln(vocab), the
# loss of a uniform prediction, which is all that a model learning nothing
# of the sequences reaches (the random walk's tokens are uniform).  50 of
# the 100 steps are warm-up, so the loss falls by a few per cent here, not
# by the 10 % a longer run reaches
# decode logits against a full forward over the same prefix: float32 with
# TF32 off, the two paths sum over other shapes (one token against the
# cache, 288 tokens at once), so they agree to float32 rounding of logits
# of magnitude ~1
LM_DECODE_ATOL = 1e-4
# the families on the card against the same code on the host, float32, TF32
# off: logits and losses to float32 rounding (LM_FAMILY_ATOL).  The train
# step in three parts, each held against a scale of its own: the gradients,
# leaf by leaf against the leaf's largest gradient (LM_GRAD_RTOL); AdamW on
# the card fed the host's gradients against the host's update, leaf by leaf
# against the leaf's largest move (LM_UPDATE_RTOL); and the card's
# ``make_train_step`` against its own ``adamw_update`` on its own gradients,
# bit for bit under deterministic algorithms.  Weights after a step from
# each side's own gradients cannot be held tighter than the step: AdamW's
# first step moves a weight by ~lr whatever its gradient's size, so one
# whose gradient rounds to the other sign moves apart by up to 2·lr
LM_FAMILY_ATOL = 1e-4
LM_FAMILY_LR = 1e-4
LM_GRAD_RTOL = 1e-4
LM_UPDATE_RTOL = 1e-2
# the global phase card against host on the same pods: the anchor, the
# momentum and the int8 residuals leaf by leaf against the leaf's largest
# first-round residual (about half its int8 step), which is what dropping
# the compression or the residual's carry would move them by
LM_SYNC_RTOL = 1e-2


def _lm_batch(cfg, b, s, seed, device):
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab, (b, s)),
             "labels": rng.randint(0, cfg.vocab, (b, s))}
    if cfg.family == "audio":
        batch["audio_embed"] = rng.randn(b, cfg.enc_frames,
                                         cfg.d_model).astype(np.float32)
    if cfg.family == "vlm":
        batch["vis_embed"] = rng.randn(b, cfg.vis_tokens,
                                       cfg.vis_dim).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _max_err(a, b) -> float:
    return float((a.detach().float().cpu() - b.detach().float().cpu())
                 .abs().max())


def lm_serve(cfg, model, device):
    """Four left-padded prompts prefilled into the cache, then greedy
    decode steps; each step's logits against ``forward`` over the same
    prefix (one forward per request, its own tokens unpadded)."""
    import numpy as np
    import torch
    from repro_torch.models.registry import get_model
    api = get_model(cfg)
    b, s, max_len, n_dec = (LM_SERVE[k] for k in ("batch", "prompt",
                                                   "max_len", "decode"))
    lens = torch.tensor(LM_PROMPT_LENS, device=device)
    start = s - lens
    rng = np.random.RandomState(1)
    tokens = torch.from_numpy(rng.randint(1, cfg.vocab, (b, s))).to(device)
    tokens = torch.where(torch.arange(s, device=device)[None] >= start[:, None],
                         tokens, 0)

    def serve():
        cache = api.init_cache(cfg, b, max_len, torch.float32, device)
        sync()
        t0 = time.perf_counter()
        logits, cache = api.prefill(model, {"tokens": tokens, "start": start},
                                    cache, cfg)
        sync()
        t1 = time.perf_counter()
        out, steps = [logits[:, -1]], []
        for j in range(n_dec):
            tok = out[-1].argmax(-1)[:, None]
            steps.append(tok)
            logits, cache = api.decode_step(model, tok, cache, s + j, cfg,
                                            kv_start=start)
            out.append(logits[:, -1])
        sync()
        return t1 - t0, time.perf_counter() - t1, out, steps

    with torch.no_grad():
        serve()                                   # warm-up
        torch.cuda.reset_peak_memory_stats()
        prefill_s, decode_s, out, steps = serve()
        peak = torch.cuda.max_memory_allocated() / 2**30
        gen = torch.cat(steps, dim=1)             # (b, n_dec)
        err = 0.0
        for i in range(b):
            seq = torch.cat([tokens[i, int(start[i]):], gen[i]])[None]
            full = api.forward(model, {"tokens": seq}, cfg)[0]
            n = int(lens[i])
            want = full[n - 1:n - 1 + len(out)]   # prefill, then each step
            got = torch.stack([o[i] for o in out])
            err = max(err, _max_err(got, want))
    if not err <= LM_DECODE_ATOL:
        raise AssertionError(f"decode logits differ from forward by {err}")
    row = dict(requests=b, prompt_lens=list(LM_PROMPT_LENS),
               max_len=max_len, decode_steps=n_dec,
               prefill_ms=prefill_s * 1e3,
               decode_ms_per_step=decode_s * 1e3 / n_dec,
               decode_tokens_per_s=b * n_dec / decode_s,
               prefill_tokens_per_s=float(lens.sum()) / prefill_s,
               peak_GiB=peak, decode_vs_forward_max_abs_err=err,
               tolerance=LM_DECODE_ATOL)
    say("lm", part="serve", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                for k, v in row.items()})
    return row


def lm_train(cfg, device, wd):
    """``make_train_step`` at the example's settings, checkpointed at
    ``resume_at``; a fresh model and optimizer restored from that
    checkpoint run the rest again and must match bit for bit."""
    import torch
    from repro_torch.checkpoint import AsyncCheckpointer, load_checkpoint
    from repro_torch.checkpoint.ckpt import latest_checkpoint
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.trainer import make_train_step
    api = get_model(cfg)
    tr = LM_TRAIN
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=tr["seq"],
                                      global_batch=tr["batch"]))
    step_fn = make_train_step(cfg, api, peak_lr=tr["peak_lr"],
                              warmup=tr["warmup"], total_steps=tr["steps"])

    def batch(step):
        return {k: torch.from_numpy(v).to(device)
                for k, v in data.batch(step).items()}

    def run(model, opt, first, ckpt=None):
        losses, marks = [], {}
        for step in range(first, tr["steps"]):
            if step == LM_TIMED_FROM:
                sync()
                marks["timed"] = time.perf_counter()
            if ckpt is not None and step == tr["resume_at"]:
                ckpt.save(step, {"p": model.state_dict(), "o": opt})
            model, opt, m = step_fn(model, opt, batch(step), step)
            losses.append(m["loss"])
        sync()
        marks["end"] = time.perf_counter()
        return model, opt, torch.stack(losses).cpu(), marks

    torch.cuda.reset_peak_memory_stats()
    model = api.init(torch.Generator().manual_seed(0), cfg, torch.float32,
                     device)
    ckpt = AsyncCheckpointer(wd, keep=1)
    model, opt, losses, marks = run(model, adamw_init(model), 0, ckpt)
    ckpt.wait()
    ckpt.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_timed = tr["steps"] - LM_TIMED_FROM
    ms = (marks["end"] - marks["timed"] - ckpt.save_seconds) * 1e3 / n_timed
    final = {k: v.clone() for k, v in model.state_dict().items()}
    final_opt = opt
    del model, opt

    fresh = api.init(torch.Generator().manual_seed(1), cfg, torch.float32,
                     device)
    path = latest_checkpoint(wd)
    t0 = time.perf_counter()
    state, at = load_checkpoint(path, {"p": fresh.state_dict(),
                                       "o": adamw_init(fresh)})
    restore_s = time.perf_counter() - t0
    if at != tr["resume_at"]:
        raise AssertionError(f"checkpoint at step {at}")
    fresh.load_state_dict(state["p"])
    fresh, opt, resumed, _ = run(fresh, state["o"], at)
    same = (torch.equal(resumed, losses[at:])
            and all(torch.equal(v, final[k])
                    for k, v in fresh.state_dict().items())
            and all(torch.equal(opt.mu[k], final_opt.mu[k])
                    and torch.equal(opt.nu[k], final_opt.nu[k])
                    for k in opt.mu)
            and torch.equal(opt.step, final_opt.step))
    first, last10 = float(losses[0]), float(losses[-10:].mean())
    finite = bool(torch.isfinite(losses).all() and torch.isfinite(resumed)
                  .all())
    bar = math.log(cfg.vocab)
    # one more step under the profiler: where a step's time goes
    wall, busy, launches, table = _profiled(
        lambda: step_fn(fresh, opt, batch(tr["steps"] - 1), tr["steps"] - 1),
        5)
    prof = dict(wall_ms=wall * 1e3, device_ms=busy * 1e3, launches=launches,
                idle_share=(1 - busy / wall) if launches else None,
                top_kernels=table)
    row = dict(steps=tr["steps"], batch=tr["batch"], seq=tr["seq"],
               loss_first=first, loss_last10_mean=last10,
               loss_bar_ln_vocab=bar,
               loss_every_10=[round(float(x), 4) for x in losses[::10]],
               ms_per_step=ms,
               tokens_per_s=tr["batch"] * tr["seq"] / ms * 1e3,
               peak_GiB=peak, ckpt_bytes=ckpt.bytes_written,
               ckpt_snapshot_s=ckpt.save_seconds,
               ckpt_write_s=ckpt.write_seconds, restore_s=restore_s,
               resumed_at=at, resumed_bit_identical=same, profile=prof)
    say("lm", part="train", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                for k, v in row.items() if k != "profile"})
    say("lm", part="train_profile", **{
        k: (f"{v:.4g}" if isinstance(v, float) else v)
        for k, v in prof.items() if k != "top_kernels"})
    for r in prof["top_kernels"]:
        say("lm", part="train_profile", calls=r["calls"],
            device_ms=f"{r['device_ms']:.2f}", kernel=repr(r["kernel"]))
    if not finite or not last10 < bar:
        raise AssertionError(f"loss did not fall below ln(vocab) = {bar}: "
                             f"{first} -> {last10}")
    if not same:
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted one")
    return row


def _rel(diff: float, scale: float) -> float:
    """``diff`` against ``scale``; nothing against nothing is 0."""
    return diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)


def _leafwise_rel(got, want, scale) -> float:
    """The largest of each leaf's max |got - want| over its own scale."""
    return max(_rel(_max_err(got[k], want[k]), scale[k]) for k in want)


def _absmax(tree) -> dict:
    return {k: float(v.detach().float().abs().max()) for k, v in tree.items()}


def lm_family(name, cfg, device):
    """One family on the card against the same code on the host: forward,
    prefill (left-padded where the family takes ``start``) and 4 decode
    steps; then one train step, held as its gradients, AdamW on the host's
    gradients and ``make_train_step``'s wiring (see ``LM_GRAD_RTOL``)."""
    import copy
    import torch
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import adamw_init, adamw_update, named
    from repro_torch.train.trainer import make_loss_fn, make_train_step
    api = get_model(cfg)
    loss_fn = make_loss_fn(cfg, api)
    step_fn = make_train_step(cfg, api, peak_lr=LM_FAMILY_LR, warmup=1)
    host = api.init(torch.Generator().manual_seed(2), cfg, torch.float32,
                    "cpu")
    card = copy.deepcopy(host).to(device)
    errs = {}
    b, s, max_len = 2, 32, 48
    padded = cfg.family not in ("audio", "vlm")
    res = {}
    for side, dev, model in (("host", "cpu", host), ("card", device, card)):
        batch = _lm_batch(cfg, b, s, 3, dev)
        if padded:
            batch["start"] = torch.tensor([0, 7], device=dev)
        with torch.no_grad():
            fwd = api.forward(model, batch, cfg)
            cache = api.init_cache(cfg, b, max_len, torch.float32, dev)
            logits, cache = api.prefill(model, batch, cache, cfg)
            outs = [logits]
            cur = s + (cfg.vis_tokens if cfg.family == "vlm" else 0)
            tok = logits.argmax(-1)
            if side == "card":            # the host's tokens drive both
                tok = res["host"]["toks"][0].to(dev)
            toks = [tok.cpu()]
            for j in range(4):
                kw = dict(kv_start=batch["start"]) if padded else {}
                logits, cache = api.decode_step(model, tok, cache, cur + j,
                                                cfg, **kw)
                outs.append(logits)
                tok = (logits.argmax(-1) if side == "host"
                       else res["host"]["toks"][j + 1].to(dev))
                toks.append(tok.cpu())
        params = named(model)
        p0 = {k: p.detach().clone() for k, p in params.items()}
        grads = dict(zip(params, torch.autograd.grad(
            loss_fn(model, batch), list(params.values()))))
        model, _, m = step_fn(model, adamw_init(model), batch, 0)
        res[side] = dict(fwd=fwd, outs=outs, toks=toks, m=m, p0=p0,
                         grads=grads, stepped=model.state_dict())
    h, c = res["host"], res["card"]
    lr = float(h["m"]["lr"])
    # AdamW on each side from the same weights on the host's gradients
    want, _ = adamw_update(h["p0"], h["grads"], adamw_init(h["p0"]), lr)
    got, _ = adamw_update(c["p0"], {k: g.to(device)
                                    for k, g in h["grads"].items()},
                          adamw_init(c["p0"]), lr)
    moved = {k: _max_err(want[k], h["p0"][k]) for k in want}
    # the card's step against its own AdamW on its own gradients
    own, _ = adamw_update(c["p0"], c["grads"], adamw_init(c["p0"]), lr)
    errs["forward"] = _max_err(c["fwd"], h["fwd"])
    errs["decode"] = max(_max_err(x, y) for x, y in zip(c["outs"], h["outs"]))
    errs["loss_rel"] = abs(float(c["m"]["loss"]) / float(h["m"]["loss"]) - 1)
    errs["grad_norm_rel"] = abs(float(c["m"]["grad_norm"])
                                / float(h["m"]["grad_norm"]) - 1)
    errs["grads_rel"] = _leafwise_rel(c["grads"], h["grads"],
                                      _absmax(h["grads"]))
    errs["update_rel"] = _leafwise_rel(got, want, moved)
    step_wired = all(torch.equal(c["stepped"][k], own[k]) for k in own)
    say("lm", part="family", family=name, params=sum(
        p.numel() for p in host.parameters()),
        **{k: f"{v:.3g}" for k, v in errs.items()}, step_wired=step_wired)
    if not (errs["forward"] <= LM_FAMILY_ATOL
            and errs["decode"] <= LM_FAMILY_ATOL
            and errs["loss_rel"] <= LM_FAMILY_ATOL
            and errs["grad_norm_rel"] <= LM_FAMILY_ATOL
            and errs["grads_rel"] <= LM_GRAD_RTOL
            and errs["update_rel"] <= LM_UPDATE_RTOL and step_wired):
        raise AssertionError(f"{name}: card and host differ: {errs} "
                             f"step_wired={step_wired}")
    return dict(errs, step_wired=step_wired)


def lm_microbatches(cfg, device):
    """``microbatches=4`` against 1 on the card: the same loss and, after
    one step, the same weights within the reference test's bound."""
    import torch
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.trainer import make_train_step
    api = get_model(cfg)
    batch = _lm_batch(cfg, 8, 16, 4, device)
    out = []
    for micro in (1, 4):
        model = api.init(torch.Generator().manual_seed(5), cfg,
                         torch.float32, device)
        step = make_train_step(cfg, api, microbatches=micro)
        model, _, m = step(model, adamw_init(model), batch, 0)
        out.append((model.state_dict(), float(m["loss"])))
    loss_rel = abs(out[1][1] / out[0][1] - 1)
    err = max(_max_err(out[0][0][k], out[1][0][k]) for k in out[0][0])
    say("lm", part="microbatches", micro=4, loss_rel=f"{loss_rel:.3g}",
        params_max_abs_diff=f"{err:.3g}")
    if not (loss_rel <= 1e-5 and err < 5e-5):
        raise AssertionError(f"microbatches=4 differs from 1: {loss_rel} "
                             f"{err}")
    return dict(loss_rel=loss_rel, params_max_abs_diff=err)


def lm_hybrid_sync(cfg, device):
    """Two pods: two inner steps on their own data, card against host (each
    pod's losses); then the host's pods and outer state on both sides
    through two rounds of ``global_sync(compress=True)``, the second with
    no inner steps, so that it exchanges the first round's residuals alone:
    the anchor, the momentum and the int8 residuals (see
    ``LM_SYNC_RTOL``)."""
    import copy
    import torch
    from repro_torch.core.hybrid_sync import (global_sync, inner_steps,
                                              outer_init, stack_pods)
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.trainer import make_train_step
    api = get_model(cfg)
    step_fn = make_train_step(cfg, api, peak_lr=LM_FAMILY_LR, warmup=1)
    res = {}
    for side, dev in (("host", "cpu"), ("card", device)):
        model = api.init(torch.Generator().manual_seed(6), cfg,
                         torch.float32, dev)
        pods, opts = stack_pods(model, 2), stack_pods(adamw_init(model), 2)
        losses = []
        for step in range(2):
            b = [_lm_batch(cfg, 4, 16, 10 * pod + step, dev)
                 for pod in range(2)]
            pods, opts, m = inner_steps(step_fn, pods, opts,
                                        {k: torch.stack([x[k] for x in b])
                                         for k in b[0]}, step)
            losses.append(m["loss"].cpu())
        res[side] = dict(losses=torch.stack(losses), pods=pods,
                         outer=outer_init(model, 2))
    h, c = res["host"], res["card"]
    loss_rel = float((c["losses"] / h["losses"] - 1).abs().max())

    def to(tree):
        return {k: v.to(device) for k, v in tree.items()}

    sides = {"host": (h["pods"], h["outer"]),
             "card": ([copy.deepcopy(p).to(device) for p in h["pods"]],
                      dataclasses.replace(
                          h["outer"], anchor=to(h["outer"].anchor),
                          momentum=to(h["outer"].momentum),
                          ef=dataclasses.replace(
                              h["outer"].ef,
                              residual=to(h["outer"].ef.residual))))}
    errs, scale = dict(loss_rel=loss_rel), None
    for rnd in (1, 2):
        for side, (pods, outer) in sides.items():
            sides[side] = global_sync(pods, outer, compress=True)
        ho, co = sides["host"][1], sides["card"][1]
        if scale is None:               # about half of each leaf's step
            scale = _absmax(ho.ef.residual)
        errs[f"anchor_{rnd}"] = _leafwise_rel(co.anchor, ho.anchor, scale)
        errs[f"momentum_{rnd}"] = _leafwise_rel(co.momentum, ho.momentum,
                                                scale)
        if rnd == 1:
            errs["residual_1"] = _leafwise_rel(co.ef.residual,
                                               ho.ef.residual, scale)
    say("lm", part="hybrid_sync", pods=2, inner_steps=2, compress=True,
        rounds=2, **{k: f"{v:.3g}" for k, v in errs.items()})
    if not (loss_rel <= LM_FAMILY_ATOL
            and max(v for k, v in errs.items() if k != "loss_rel")
            <= LM_SYNC_RTOL):
        raise AssertionError(f"hybrid sync: card and host differ: {errs}")
    return errs


def phase_lm():
    """The LM substrate on the card, float32 with TF32 off: demo-100m
    serving and training, then every family at smoke size, card against
    host."""
    import tempfile
    import torch
    from repro_torch.configs.lm_smoke import SMOKE_FAMILIES
    from repro_torch.models.registry import count_params, get_model
    t0 = time.perf_counter()
    device = torch.device(LM_DEVICE)
    cfg = LM_CFG
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = dict(model=cfg.name, params=count_params(cfg),
               active_params=count_params(cfg, active_only=True))
    say("lm", model=cfg.name, params=out["params"])
    try:
        model = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                    torch.float32, device)
        out["serve"] = lm_serve(cfg, model, device)
        del model
        torch.cuda.empty_cache()
        # embedding backward accumulates with atomics unless asked not to:
        # the resumed run and each family's step wiring are held bit for bit
        torch.use_deterministic_algorithms(True)
        try:
            with tempfile.TemporaryDirectory(
                    dir=os.path.join(ROOT, "build")) as wd:
                out["train"] = lm_train(cfg, device, wd)
            torch.cuda.empty_cache()
            out["families"] = {name: lm_family(name, fcfg, device)
                               for name, fcfg in SMOKE_FAMILIES.items()}
        finally:
            torch.use_deterministic_algorithms(False)
        out["microbatches"] = lm_microbatches(SMOKE_FAMILIES["dense_gqa"],
                                              device)
        out["hybrid_sync"] = lm_hybrid_sync(SMOKE_FAMILIES["dense_gqa"],
                                            device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    secs = time.perf_counter() - t0
    say("lm", phase_s=f"{secs:.1f}")
    out["phase_s"] = secs
    return out


# --------------------------------------------------------------------------
# mesh: the LM substrate's sharding on a DeviceMesh, four ranks on the card
# --------------------------------------------------------------------------

MESH_WORLD = 4
MESH_DEVICE = "cuda:0"    # every rank on the one card (gloo, staged)
MESH_DATA, MESH_MODEL = 2, 2
MESH_TRAIN_STEPS = 3
MESH_DEADLINE_S = 300.0
# the sharded steps against the single-device steps from the same weights
# and batches: the data ranks' gradient sum and the clipping norm over the
# shards reassociate float32 sums, so neither is bit for bit.  Each value
# is held against its own scale (PERF.md section 6 gives the prediction,
# written before the first run, and the readings of two broken steps): a
# leaf's weights against the leaf's largest move over the 3 steps (AdamW
# moves a weight by ~lr a step whatever its gradient's size, so the
# weights see a skipped update or a wrong gradient, not its scale), its
# first moment against the leaf's largest |mu| and each step's clipping
# norm (these see the gradient's scale: a norm summed over the wrong
# shards, or gradients not summed over data), and each step's loss
MESH_UPDATE_RTOL = 0.1
MESH_MU_RTOL = 1e-4
MESH_NORM_RTOL = 1e-5
MESH_LOSS_RTOL = 1e-5
MESH_SYNC_LR = 1e-4       # the pods' inner steps (LM_FAMILY_LR's)
DRYRUN_DEADLINE_S = 300.0
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def start_dryrun():
    """The dry run of ``LM_CFG`` (every shape on both production meshes,
    the graph cells, the sync cell) on the host on ``meta`` tensors, one
    process of one thread per (shape, mesh) and one for the graph and sync
    cells, all started together.  The phase starts them once its ranks are
    done, so no timed run shares the host with them."""
    import shutil
    out = os.path.join(ROOT, "build", "mesh_dryrun")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    code = ("import sys, torch\n"
            "torch.set_num_threads(1)\n"
            "from repro_torch.launch import dryrun as d\n"
            "out, arch, what = sys.argv[1], sys.argv[2], sys.argv[3:]\n"
            "if what == ['graph', 'sync']:\n"
            "    rc = d.main(['--graphhp', '--out', out])\n"
            "    r = d.run_sync_cell(arch, out)\n"
            "    sys.exit(rc or r['status'] != 'ok')\n"
            "sys.exit(d.main(['--arch', arch, '--out', out] + what))\n")
    jobs = [["--shape", sh, "--mesh", m] for sh in DRYRUN_SHAPES
            for m in ("single", "multi")] + [["graph", "sync"]]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs, logs = [], []
    for i, job in enumerate(jobs):
        logs.append(open(os.path.join(out, f"log_{i}.txt"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, out, LM_CFG.name, *job], cwd=ROOT,
            stdout=logs[-1], stderr=subprocess.STDOUT, env=env))
    return dict(procs=procs, out=out, logs=logs, t0=time.perf_counter())


def stop_dryrun(dry):
    if dry is None:
        return
    for proc in dry["procs"]:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    for log in dry["logs"]:
        log.close()


def _meta_model(cfg, state, device=None):
    """The model of ``state``'s weights with no init of its own: copies on
    ``device``, or ``state``'s own tensors (to be read, not trained)."""
    import torch
    from repro_torch.models.registry import get_model
    model = get_model(cfg).init(torch.Generator(), cfg, torch.float32,
                                "meta")
    if device is not None:
        state = {k: v.to(device, copy=True) for k, v in state.items()}
    model.load_state_dict(state, assign=True)
    return model


def _device_sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _allocated(device):
    """(bytes the caching allocator was asked for, bytes of the blocks it
    handed out) on ``device``: ``memory_allocated`` counts whole blocks,
    and a block whose remainder would be 1 MB or less is not split, so
    only the requested bytes add up to the tensors' own."""
    import torch
    if device.type != "cuda":
        return None, None
    return (torch.cuda.memory_stats(device)["requested_bytes.all.current"],
            torch.cuda.memory_allocated(device))


def mesh_serve(cfg, serve, model, tokens, start, device, mesh=None):
    """The lm phase's serving (``serve``: ``LM_SERVE``), on this rank's
    rows of the batch and its cut of the cache when a mesh is given:
    (logits of every step (b, 1 + steps, vocab), tokens, ms a step, the
    decode axis)."""
    import torch
    from repro_torch.models.registry import get_model
    from repro_torch.sharding.util import shard_cache
    api = get_model(cfg)
    b, s, max_len, n_dec = (serve[k] for k in ("batch", "prompt",
                                                "max_len", "decode"))
    cache = api.init_cache(cfg, b, max_len, torch.float32, device)
    axis = None
    if mesh is not None:
        rows, d = b // mesh.size(0), mesh.get_coordinate()[0]
        tokens = tokens[d * rows:(d + 1) * rows]
        start = start[d * rows:(d + 1) * rows]
        cache, axis = shard_cache(cache, mesh)
    with torch.no_grad():
        logits, cache = api.prefill(model, {"tokens": tokens, "start": start},
                                    cache, cfg, decode_axis=axis)
        out, toks = [logits[:, -1]], []
        _device_sync(device)
        t = time.perf_counter()
        for j in range(n_dec):
            tok = out[-1].argmax(-1)[:, None]
            toks.append(tok)
            logits, cache = api.decode_step(model, tok, cache, s + j, cfg,
                                            decode_axis=axis, kv_start=start)
            out.append(logits[:, -1])
        _device_sync(device)
    ms = (time.perf_counter() - t) * 1e3 / n_dec
    return (torch.stack(out, 1).cpu(), torch.cat(toks, 1).cpu(), ms, axis)


def _mesh_step(cfg, train):
    """The lm phase's train step (``train``: ``LM_TRAIN``)."""
    from repro_torch.models.registry import get_model
    from repro_torch.train.trainer import make_train_step
    return make_train_step(cfg, get_model(cfg), peak_lr=train["peak_lr"],
                           warmup=train["warmup"],
                           total_steps=train["steps"])


def _mesh_rank(rank, world, group, device, cfg, serve, train, state,
               serve_in, batches, train_want, pod_batches):
    """One rank of the mesh phase: (b) serving, (a) the sharded train
    step, (c) the cross-pod sync; what rank 0 (and the other data rank's
    model-0 rank, for serving) found."""
    import copy
    import torch
    import torch.distributed as dist
    from repro_torch.core.distributed import COMM, all_gather_rows, reset_comm
    from repro_torch.core.hybrid_sync import global_sync, outer_init
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.optim.adamw import adamw_init, named
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    mesh = make_host_mesh(MESH_DATA, MESH_MODEL, device_type=device.type)
    coord = tuple(mesh.get_coordinate())

    # (b) serving: the model whole on each rank, the batch over data, the
    # cache's sequence over model
    model = _meta_model(cfg, state, device)
    tokens, start = (t.to(device) for t in serve_in)
    t = time.perf_counter()
    with set_mesh(mesh):
        logits, toks, ms, axis = mesh_serve(cfg, serve, model, tokens,
                                            start, device, mesh)
    out["serve"] = dict(coord=coord, logits=logits if coord[1] == 0 else None,
                        tokens=toks, ms_per_step=ms, axis=axis,
                        seconds=time.perf_counter() - t)
    del model
    torch.cuda.empty_cache()

    # (a) the sharded train step: parameters and moments by the rules
    out["train"] = mesh_train_rank(mesh, device, cfg, train, state, batches,
                                   train_want)
    torch.cuda.empty_cache()

    # (c) two pods on ranks 0 and 1: inner steps on their own data, then
    # two compressed exchanges over the pod group, the second carrying the
    # first's residuals alone; each rank also runs the one-process sync on
    # both pods (gathered) and holds its own result to it bit for bit
    pods_group = dist.new_group([0, 1])
    if rank < 2:
        model = _meta_model(cfg, state, device)
        outer = outer_init(model, 1)
        opt = adamw_init(model)
        step_fn = _mesh_step_sync(cfg)
        for s, batch in enumerate(pod_batches[rank]):
            model, opt, _ = step_fn(model, opt, {
                k: v.to(device) for k, v in batch.items()}, s)
        del opt
        params = named(model)
        both = all_gather_rows([p.detach()[None] for p in params.values()],
                               group=pods_group)
        pods = []
        for i in range(2):
            pod = copy.deepcopy(model)
            with torch.no_grad():
                for (k, p), g in zip(named(pod).items(), both):
                    p.copy_(g[i])
            pods.append(pod)
        ref_outer = outer_init(model, 2)
        ref_outer.anchor = {k: v.clone() for k, v in outer.anchor.items()}
        same, round_comm = True, []
        for rnd in range(2):
            pods, ref_outer = global_sync(pods, ref_outer, compress=True)
            reset_comm()
            (model,), outer = global_sync([model], outer, compress=True,
                                          group=pods_group)
            round_comm.append(dict(COMM))
            same = same and all(
                torch.equal(outer.anchor[k], ref_outer.anchor[k])
                and torch.equal(outer.momentum[k], ref_outer.momentum[k])
                and torch.equal(outer.ef.residual[k][0],
                                ref_outer.ef.residual[k][rank])
                and torch.equal(p, outer.anchor[k])
                for k, p in named(model).items())
        n = sum(p.numel() for p in model.parameters())
        out["sync"] = dict(bit_identical=same, comm=round_comm,
                           f32_delta_bytes=2 * n * 4, params=n)
    dist.barrier()
    return out


def mesh_train_rank(mesh, device, cfg, train, state, batches, want):
    """(a) on this rank: the parameters and AdamW moments placed by the
    rules (their bytes read from the allocator), ``MESH_TRAIN_STEPS``
    sharded steps, then each leaf's largest error of its weights and of
    its first moment against the same cut of the single-device run's
    (``want``, from :func:`mesh_train_single`), the largest over the
    ranks."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.distributed import COMM, reset_comm
    from repro_torch.launch.specs import arg_bytes, build_cell, shard_module
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.sharding.fsdp import all_reduce, local_of, sharding_of
    from repro_torch.sharding.rules import batch_spec, param_specs
    from repro_torch.sharding.util import named as named_sh
    from repro_torch.sharding.util import (local_chunk, place_tree,
                                           sanitize_specs)
    shape = ShapeConfig("mesh_train", train["seq"], train["batch"], "train")
    want_bytes = arg_bytes(build_cell(cfg, shape, mesh, False,
                                      param_dtype=torch.float32))
    model = _meta_model(cfg, state)
    specs = sanitize_specs(param_specs(model), model, mesh)
    _device_sync(device)
    m0 = _allocated(device)
    model = shard_module(model, named_sh(specs, mesh), device)
    m1 = _allocated(device)
    opt = adamw_init(model)
    m2 = _allocated(device)
    probe = torch.zeros((), dtype=torch.int32, device=device)
    m3 = _allocated(device)         # the AdamW step scalar's block
    del probe
    got = ({"params": m1[0] - m0[0],
            "moments": (m2[0] - m1[0]) - (m3[0] - m2[0])}
           if m0[0] is not None else {})
    blocks = ({"params": m1[1] - m0[1],
               "moments": (m2[1] - m1[1]) - (m3[1] - m2[1])}
              if m0[0] is not None else {})
    step_fn = _mesh_step(cfg, train)
    reset_comm()
    losses, norms = [], []
    _device_sync(device)
    t = time.perf_counter()
    for s, batch in enumerate(batches):
        shard = named_sh(sanitize_specs(batch_spec(batch), batch, mesh),
                         mesh)
        model, opt, m = step_fn(model, opt, place_tree(batch, shard, device),
                                s)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    _device_sync(device)
    seconds = time.perf_counter() - t
    comm = dict(COMM)
    names = [k for k, _ in model.named_parameters()]
    errs = torch.tensor([[
        _max_err(p._local_tensor,
                 local_chunk(want["params"][k], sharding_of(p))),
        _max_err(local_of(opt.mu[k]),
                 local_chunk(want["mu"][k], sharding_of(opt.mu[k])))]
        for k, p in model.named_parameters()], dtype=torch.float64)
    errs = all_reduce(errs, None, dist.ReduceOp.MAX)
    del model, opt
    return dict(bytes=got, block_bytes=blocks,
                want_bytes={k: want_bytes[k] for k in ("params", "moments")},
                losses=losses, grad_norms=norms,
                weight_errs=dict(zip(names, errs[:, 0].tolist())),
                mu_errs=dict(zip(names, errs[:, 1].tolist())),
                seconds=seconds, comm=comm,
                peak_GiB=(torch.cuda.max_memory_allocated(device) / 2**30
                          if device.type == "cuda" else 0.0))


def mesh_train_readings(tr, want, state) -> dict:
    """One rank's (a) against the single-device run: each leaf's weight
    error over the leaf's largest move from ``state`` (the initial
    weights), its first-moment error over its largest |mu|, and each
    step's clipping norm and loss, relative.  The worst leaf of each."""
    def worst(errs, scale):
        rel = {k: _rel(e, scale[k]) for k, e in errs.items()}
        k = max(rel, key=rel.get)
        return rel[k], k

    moved = {k: _max_err(want["params"][k], state[k]) for k in tr["weight_errs"]}
    mu_max = {k: float(want["mu"][k].abs().max()) for k in tr["mu_errs"]}
    w_rel, w_leaf = worst(tr["weight_errs"], moved)
    mu_rel, mu_leaf = worst(tr["mu_errs"], mu_max)
    return dict(
        weights_rel=w_rel, weights_worst_leaf=w_leaf,
        mu_rel=mu_rel, mu_worst_leaf=mu_leaf,
        weights_max_abs_err=max(tr["weight_errs"].values()),
        largest_move=max(moved.values()), smallest_move=min(moved.values()),
        grad_norm_rel=max(abs(a / b - 1) for a, b in zip(
            tr["grad_norms"], want["grad_norms"])),
        loss_rel=max(abs(a / b - 1) for a, b in zip(tr["losses"],
                                                    want["losses"])))


def mesh_train_ok(r) -> bool:
    return (r["loss_rel"] <= MESH_LOSS_RTOL
            and r["grad_norm_rel"] <= MESH_NORM_RTOL
            and r["mu_rel"] <= MESH_MU_RTOL
            and r["weights_rel"] <= MESH_UPDATE_RTOL)


def mesh_inputs(cfg) -> dict:
    """The phase's host inputs: ``cfg``'s weights drawn once (a state dict
    handed to every rank), the train batches, each pod's batches and the
    serving prompts (``LM_SERVE``, left-padded)."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.registry import get_model
    host = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                               torch.float32, "cpu")
    state = {k: v.detach() for k, v in host.state_dict().items()}
    data = SyntheticTokens(DataConfig(
        vocab=cfg.vocab, seq_len=LM_TRAIN["seq"],
        global_batch=LM_TRAIN["batch"]))
    batches = [{k: torch.from_numpy(v) for k, v in data.batch(s).items()}
               for s in range(MESH_TRAIN_STEPS)]
    pod_batches = [[{k: torch.from_numpy(v) for k, v in SyntheticTokens(
        DataConfig(vocab=cfg.vocab, seq_len=LM_TRAIN["seq"],
                   global_batch=LM_TRAIN["batch"] // 2,
                   seed=1 + pod)).batch(s).items()} for s in range(2)]
        for pod in range(2)]
    b, s = LM_SERVE["batch"], LM_SERVE["prompt"]
    start = s - torch.tensor(LM_PROMPT_LENS)
    rng = np.random.RandomState(1)
    tokens = torch.from_numpy(rng.randint(1, cfg.vocab, (b, s)))
    tokens = torch.where(torch.arange(s)[None] >= start[:, None], tokens, 0)
    return dict(state=state, batches=batches, pod_batches=pod_batches,
                serve_in=(tokens, start))


def mesh_train_single(cfg, state, batches, device) -> dict:
    """The single-device steps on ``device`` from ``state``: weights and
    first moments after the last (on the host), each step's loss and
    clipping norm."""
    import torch
    from repro_torch.optim.adamw import adamw_init
    model = _meta_model(cfg, state, device)
    opt, step_fn = adamw_init(model), _mesh_step(cfg, LM_TRAIN)
    losses, norms = [], []
    for step, batch in enumerate(batches):
        model, opt, m = step_fn(model, opt, {
            k: v.to(device) for k, v in batch.items()}, step)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    want = dict(params={k: v.detach().cpu()
                        for k, v in model.named_parameters()},
                mu={k: v.cpu() for k, v in opt.mu.items()},
                losses=losses, grad_norms=norms)
    del model, opt
    torch.cuda.empty_cache()
    return want


def _mesh_step_sync(cfg):
    from repro_torch.models.registry import get_model
    from repro_torch.train.trainer import make_train_step
    return make_train_step(cfg, get_model(cfg), peak_lr=MESH_SYNC_LR,
                           warmup=1)


def _dryrun_checks(dry):
    """Wait for the dry run, print each cell, fail on a wrong status."""
    rc = [proc.wait(timeout=max(1.0, DRYRUN_DEADLINE_S
                                - (time.perf_counter() - dry["t0"])))
          for proc in dry["procs"]]
    waited = time.perf_counter() - dry["t0"]
    recs = {}
    for f in sorted(os.listdir(dry["out"])):
        if f.endswith(".json"):
            with open(os.path.join(dry["out"], f)) as fh:
                r = json.load(fh)
            recs[(r["shape"], r["mesh"])] = r
    for (shape, mesh), r in sorted(recs.items()):
        mem = r.get("memory", {})
        say("mesh", part="dryrun", arch=r["arch"], shape=shape, mesh=mesh,
            status=r["status"],
            argument_bytes_per_rank=mem.get("argument_bytes"),
            peak_bytes_per_rank=mem.get("peak_bytes"),
            flops_per_rank=r.get("flops"),
            collective_bytes_per_rank=r.get(
                "collective_bytes", r.get("exchange_bytes")),
            f32_delta_gather_bytes=r.get("f32_delta_gather_bytes"),
            reason=json.dumps(r.get("reason", r.get("error", ""))))
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.specs import runnable
    bad = [k for k, r in recs.items() if r["status"] == "fail"]
    want = {(s, m) for s in DRYRUN_SHAPES for m in ("single", "multi")} | {
        ("hybrid_iteration", "single"), ("hybrid_iteration", "multi"),
        ("global_sync", "multi")}
    missing = sorted(want - set(recs))
    skips = [s for s in DRYRUN_SHAPES
             if not runnable(LM_CFG, SHAPES[s])[0]]
    wrong = [k for k in want - set(missing)
             if (recs[k]["status"] == "skip") != (k[0] in skips)]
    if any(rc) or bad or missing or wrong:
        raise AssertionError(f"dry run: exits {rc}, failed {bad}, missing "
                             f"{missing}, wrong status {wrong} (see "
                             f"{dry['out']}/log_*.txt)")
    return dict(seconds_since_start=waited, cells={
        f"{k[0]}:{k[1]}": {x: r.get(x) for x in (
            "status", "memory", "flops", "collectives", "collective_bytes",
            "exchange_bytes", "f32_delta_gather_bytes", "reason",
            "elapsed_s")} for k, r in recs.items()})


def phase_mesh():
    """The LM substrate's sharding on a (data 2, model 2) DeviceMesh of
    four ranks on the card over gloo: demo-100m at full size, float32,
    TF32 off; then the dry run, started once the ranks are done."""
    import torch
    from repro_torch.core.distributed import spawn_ranks
    t0 = time.perf_counter()
    device = torch.device(LM_DEVICE)
    cfg = LM_CFG
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, dry = {}, None
    try:
        inp = mesh_inputs(cfg)
        state, (tokens, start) = inp["state"], inp["serve_in"]
        init_s = time.perf_counter() - t0

        # the single-device runs on the card, from the same weights
        model = _meta_model(cfg, state, device)
        want_logits, want_toks, want_ms, _ = mesh_serve(
            cfg, LM_SERVE, model, tokens.to(device), start.to(device), device)
        del model
        train_want = mesh_train_single(cfg, state, inp["batches"], device)
        ref_s = time.perf_counter() - t0 - init_s

        t = time.perf_counter()
        ranks = spawn_ranks(_mesh_rank, MESH_WORLD, "gloo", MESH_DEVICE,
                            args=(cfg, dict(LM_SERVE), dict(LM_TRAIN), state,
                                  (tokens, start), inp["batches"],
                                  train_want, inp["pod_batches"]),
                            deadline_s=MESH_DEADLINE_S)
        ranks_s = time.perf_counter() - t
        dry = start_dryrun()

        # (b) serving: the rows of each data rank, from its model-0 rank
        rows = sorted((r["serve"]["coord"], r["serve"]) for r in ranks
                      if r["serve"]["coord"][1] == 0)
        logits = torch.cat([x["logits"] for _, x in rows])
        toks = torch.cat([x["tokens"] for _, x in rows])
        serve_err = _max_err(logits, want_logits)
        serve_same = torch.equal(toks, want_toks)
        axes = {r["serve"]["axis"] for r in ranks}
        out["serve"] = dict(
            max_abs_err=serve_err, tokens_equal=serve_same,
            tolerance=LM_DECODE_ATOL, decode_axis=sorted(axes),
            ms_per_step=max(r["serve"]["ms_per_step"] for r in ranks),
            single_device_ms_per_step=want_ms)
        say("mesh", part="serve", mesh=f"{MESH_DATA}x{MESH_MODEL}",
            requests=LM_SERVE["batch"], max_len=LM_SERVE["max_len"],
            decode_steps=LM_SERVE["decode"],
            max_abs_err=f"{serve_err:.4g}", tolerance=LM_DECODE_ATOL,
            tokens_equal=serve_same,
            ms_per_step=f"{out['serve']['ms_per_step']:.2f}",
            single_device_ms_per_step=f"{want_ms:.2f}")

        # (a) training
        tr = ranks[0]["train"]
        got = mesh_train_readings(tr, train_want, state)
        train_ok = mesh_train_ok(got)
        bytes_ok = all(r["train"]["bytes"] == r["train"]["want_bytes"]
                       for r in ranks)
        out["train"] = dict(
            steps=MESH_TRAIN_STEPS, losses=tr["losses"],
            single_device_losses=train_want["losses"],
            grad_norms=tr["grad_norms"],
            single_device_grad_norms=train_want["grad_norms"], **got,
            tolerances=dict(loss=MESH_LOSS_RTOL, grad_norm=MESH_NORM_RTOL,
                            mu=MESH_MU_RTOL, weights=MESH_UPDATE_RTOL),
            bytes_per_rank=[r["train"]["bytes"] for r in ranks],
            block_bytes_per_rank=[r["train"]["block_bytes"] for r in ranks],
            dryrun_bytes_per_rank=tr["want_bytes"], bytes_equal=bytes_ok,
            seconds=max(r["train"]["seconds"] for r in ranks),
            comm=tr["comm"], peak_GiB=max(r["train"]["peak_GiB"]
                                          for r in ranks))
        say("mesh", part="train", mesh=f"{MESH_DATA}x{MESH_MODEL}",
            steps=MESH_TRAIN_STEPS, batch=LM_TRAIN["batch"],
            seq=LM_TRAIN["seq"],
            losses=json.dumps([round(x, 6) for x in tr["losses"]]),
            grad_norms=json.dumps([round(x, 6) for x in tr["grad_norms"]]),
            loss_rel=f"{got['loss_rel']:.3g}", loss_rtol=MESH_LOSS_RTOL,
            grad_norm_rel=f"{got['grad_norm_rel']:.3g}",
            grad_norm_rtol=MESH_NORM_RTOL,
            mu_rel=f"{got['mu_rel']:.3g}", mu_leaf=got["mu_worst_leaf"],
            mu_rtol=MESH_MU_RTOL,
            weights_rel=f"{got['weights_rel']:.3g}",
            weights_leaf=got["weights_worst_leaf"],
            weights_rtol=MESH_UPDATE_RTOL,
            weights_max_abs_err=f"{got['weights_max_abs_err']:.3g}",
            move_range=f"{got['smallest_move']:.3g}..{got['largest_move']:.3g}",
            param_bytes_per_rank=tr["bytes"].get("params"),
            moment_bytes_per_rank=tr["bytes"].get("moments"),
            allocated_block_bytes=json.dumps(tr["block_bytes"]).replace(
                " ", ""),
            dryrun_bytes=json.dumps(tr["want_bytes"]).replace(" ", ""),
            bytes_equal=bytes_ok,
            s_per_step=f"{out['train']['seconds'] / MESH_TRAIN_STEPS:.2f}",
            collectives=tr["comm"]["collectives"],
            wire_bytes=tr["comm"]["wire_bytes"],
            staged_bytes=tr["comm"]["staged_bytes"],
            peak_GiB=f"{out['train']['peak_GiB']:.2f}")

        # (c) the cross-pod sync
        syncs = [r["sync"] for r in ranks[:2]]
        sync_same = all(x["bit_identical"] for x in syncs)
        wire = [c["wire_bytes"] for c in syncs[0]["comm"]]
        out["sync"] = dict(bit_identical=sync_same, wire_bytes=wire,
                           f32_delta_bytes=syncs[0]["f32_delta_bytes"],
                           params=syncs[0]["params"])
        say("mesh", part="sync", pods=2, inner_steps=2, rounds=2,
            compress=True, bit_identical=sync_same,
            wire_bytes_per_round=json.dumps(wire),
            f32_delta_bytes_per_round=syncs[0]["f32_delta_bytes"])

        t = time.perf_counter()
        out["dryrun"] = _dryrun_checks(dry)
        dryrun_s = time.perf_counter() - t
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        stop_dryrun(dry)
    secs = time.perf_counter() - t0
    out.update(phase_s=secs, init_s=init_s, single_device_s=ref_s,
               ranks_s=ranks_s, dryrun_wait_s=dryrun_s)
    say("mesh", host_init_s=f"{init_s:.1f}", single_device_s=f"{ref_s:.1f}",
        ranks_s=f"{ranks_s:.1f}",
        dryrun_s=f"{out['dryrun']['seconds_since_start']:.1f}",
        phase_s=f"{secs:.1f}")
    if not (serve_err <= LM_DECODE_ATOL and serve_same
            and axes == {"model"}):
        raise AssertionError(f"mesh serve: err {serve_err}, tokens equal "
                             f"{serve_same}, axes {axes}")
    if not (train_ok and bytes_ok):
        raise AssertionError(f"mesh train: {got}, bytes {bytes_ok}")
    if not (sync_same and all(w < syncs[0]["f32_delta_bytes"] / 3.9
                              for w in wire)):
        raise AssertionError(f"mesh sync: bit identical {sync_same}, wire "
                             f"{wire}")
    return out


def main() -> int:
    t0 = time.perf_counter()
    phase_s, mark = {}, [t0]

    def lap(name):
        """Seconds since the previous lap, kept as ``name``'s."""
        now = time.perf_counter()
        phase_s[name] = round(now - mark[0], 1)
        mark[0] = now

    smi = phase_device()
    build_s = phase_build()
    lap("build")
    import torch
    from repro_torch import SSSP, IncrementalPageRank
    sweep_cases = phase_sweep()
    lap("sweep")
    sssp_graph, sssp_data, sssp_build_s = grid_sssp_graph()
    pr_graph, pr_data, pr_build_s, pr_part = rmat_pagerank_graph()
    lap("graphs")

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
    lap("main")

    sssp_err, sssp_dijkstra = check_sssp(sssp_graph, sssp_es, sssp_data)
    pr_err = check_pagerank(pr_graph, pr_es, pr_data)
    lap("oracle")

    dist = phase_dist(sssp_graph, sssp_data, sssp_es, sssp_dijkstra,
                      pr_data, pr_part)
    del sssp_dijkstra
    lap("dist")

    report, timed = kernel_checks(sssp_graph, sssp_prog, sssp_es,
                                  pr_graph, pr_prog, pr_es)
    lap("kernels")
    profiles = dict(
        sssp=phase_profile("sssp", sssp_graph, SSSP(source=0), 2),
        pagerank=phase_profile("pagerank", pr_graph,
                               IncrementalPageRank(tolerance=PR_TOL), 5))
    lap("profile")
    engines = phase_engines(sssp_graph, sssp_es, sssp_run, pr_graph, pr_run,
                            pr_data)
    lap("engines")
    from repro_torch.convert import to_numpy
    pr_want = to_numpy(pr_es)        # the ft phase's reference, on the host
    del pr_es
    apps = phase_apps(sssp_graph, sssp_data)
    lap("apps")
    io = phase_io(sssp_graph, sssp_data, sssp_es, sssp_run)
    lap("io")
    sssp_want = to_numpy(sssp_es)
    ft = phase_ft(sssp_graph, sssp_want, sssp_run["iterations"],
                  pr_graph, pr_want, pr_run["iterations"])
    lap("ft")
    serve = phase_serve(sssp_graph, sssp_data, sssp_es, pr_graph, pr_data)
    del sssp_es
    torch.cuda.empty_cache()
    lap("serve")
    obs = phase_obs(sssp_graph, sssp_want, pr_graph, pr_want)
    lap("obs")
    del sssp_graph, pr_graph
    torch.cuda.empty_cache()
    lm = phase_lm()
    lap("lm")
    mesh = phase_mesh()
    lap("mesh")

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
                       io=io, ft=ft, serve=serve, obs=obs, dist=dist,
                       lm=lm, mesh=mesh, phase_s=phase_s), f, indent=1)

    say("done", seconds=f"{time.perf_counter() - t0:.1f}",
        phase_s=json.dumps(phase_s).replace(" ", ""))
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
