"""The distributed hybrid step (``repro_torch.core.distributed``) against
the reference, on the CPU: ranks are spawned processes joined by gloo over
CPU tensors, on small graphs.

* ``runtime.slice_flat``'s block branch bit for bit against the
  reference's on the same block-sliced tiles, at one and two partitions
  per edge block and one and two edge blocks per rank.
* ``runtime.exchange(wire_dtype=)`` against the reference's quantized
  exchange on ``uint16`` / ``uint8`` / float leaves (bfloat16 and both
  float8 types), in one process and through a 4-rank gloo
  ``gather_table``.
* The distributed step at worlds 4 and 8, ``use_ell`` on and off, for
  SSSP (grid and hub-skewed digraph), WidestPath, RandomWalk (odds,
  logprob), a 4-lane ``MultiSourceMonotone`` and IncrementalPageRank
  against the reference's host ``run_hybrid``: state bit for bit (NaN by
  position), iterations, the three message counters and per-partition
  pseudo-supersteps exactly.  No tolerance anywhere: ``add_mul``
  (PageRank) folds each row's slots in the same order on a block as on
  the whole graph.
* The bfloat16-wire run, ``phased_run(wire_dtype=)``, ``traced_dist_step``
  spans, block-wise init, the dry-run shapes, the distributed
  kill-and-resume, and the failures (a world that does not divide the
  blocks, NCCL without a card per rank, a rank that dies, a deadline).

The reference (JAX) is imported inside the tests, not at the top of the
module: the spawned ranks import this module to find their functions and
stay on torch alone.  Each multi-rank spawn has its own deadline.
"""

import dataclasses
import functools
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import (SSSP, IncrementalPageRank, MultiSourceMonotone,
                         RandomWalk, WidestPath, build_partitioned_graph,
                         pagerank_edge_weights, random_walk_edge_weights,
                         run_hybrid)
from repro_torch.convert import to_numpy
from repro_torch.core import distributed as D
from repro_torch.core.runtime import (Counters, EngineState, block_flat,
                                      exchange, slice_flat)
from repro_torch.data.graphs import grid_graph, path_graph, rmat_graph
from repro_torch.exec.iteration import init_hybrid
from repro_torch.partition import bfs_partition, hash_partition

DEADLINE = 300.0            # seconds, per multi-rank spawn
CPU = dict(backend="gloo", device="cpu", threads=1)
WIRES = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


@functools.lru_cache(maxsize=None)
def jx():
    """The reference modules, loaded on first use."""
    import types

    import jax
    import jax.numpy as jnp

    from repro.core import build_partitioned_graph as build
    from repro.core import run_hybrid as run
    from repro.core import apps
    from repro.core import distributed as dist_mod
    from repro.core import runtime
    from repro.exec import iteration
    from repro.obs import trace
    return types.SimpleNamespace(jax=jax, jnp=jnp, build=build, run=run,
                                 apps=apps, dist=dist_mod, runtime=runtime,
                                 iteration=iteration, trace=trace)


# ---------------------------------------------------------------------------
# the cases of tests/test_distributed.py
# ---------------------------------------------------------------------------

def _hub_edges():
    rng = np.random.RandomState(13)
    n = 160
    edges = np.stack([rng.randint(0, n, size=1200),
                      rng.randint(0, 4, size=1200)], axis=1)
    edges = np.concatenate([edges, rng.randint(0, n, size=(600, 2))])
    edges = np.unique(edges, axis=0)
    edges = edges[edges[:, 0] != edges[:, 1]]
    w = rng.uniform(0.5, 3.0, size=len(edges)).astype(np.float32)
    return edges, n, w


@functools.lru_cache(maxsize=None)
def case_inputs(name):
    """(edges, n, part, weights, build kwargs, port program, reference
    program factory, state field) of each case, at P = 8, edge_blocks = 8."""
    if name in ("grid_sssp", "lanes"):
        edges, w, n = grid_graph(6, 40, seed=3)
        part = bfs_partition(edges, n, 8, seed=1)
        src = [0, 7, n - 1, 120]
        if name == "grid_sssp":
            return (edges, n, part, w, {}, SSSP(source=0),
                    lambda a: a.SSSP(source=0), "dist")
        return (edges, n, part, w, {},
                MultiSourceMonotone(src, semiring="min_add"),
                lambda a: a.MultiSourceMonotone(src, semiring="min_add"),
                "val")
    if name == "hub_sssp":
        edges, n, w = _hub_edges()
        return (edges, n, hash_partition(n, 8, seed=2), w,
                dict(ell_base_slices=8), SSSP(source=0),
                lambda a: a.SSSP(source=0), "dist")
    if name == "widest":
        edges, n = rmat_graph(240, avg_degree=5, seed=9)
        w = np.random.RandomState(7).uniform(0.5, 8.0, size=len(edges)) \
            .astype(np.float32)
        return (edges, n, hash_partition(n, 8, seed=1), w, {},
                WidestPath(source=0), lambda a: a.WidestPath(source=0),
                "cap")
    if name in ("rw_odds", "rw_logprob"):
        mode = name[3:]
        edges, n = rmat_graph(240, avg_degree=5, seed=9)
        return (edges, n, hash_partition(n, 8, seed=1),
                random_walk_edge_weights(edges, n, mode), {},
                RandomWalk(source=0, mode=mode),
                lambda a: a.RandomWalk(source=0, mode=mode), "mass")
    if name == "pagerank":
        edges, n = rmat_graph(240, avg_degree=6, seed=7)
        return (edges, n, hash_partition(n, 8, seed=2),
                pagerank_edge_weights(edges, n), {},
                IncrementalPageRank(tolerance=1e-4),
                lambda a: a.IncrementalPageRank(tolerance=1e-4), "rank")
    raise KeyError(name)


CASES = ("grid_sssp", "hub_sssp", "widest", "rw_odds", "rw_logprob",
         "lanes", "pagerank")


@functools.lru_cache(maxsize=None)
def port_graph(name, edge_blocks=8):
    edges, n, part, w, kw = case_inputs(name)[:5]
    return build_partitioned_graph(edges, n, part, weights=w,
                                   edge_blocks=edge_blocks, device="cpu",
                                   **kw)


@functools.lru_cache(maxsize=None)
def ref_graph(name):
    edges, n, part, w, kw = case_inputs(name)[:5]
    return jx().build(edges, n, part, weights=w, edge_blocks=8, **kw)


@functools.lru_cache(maxsize=None)
def ref_run(name, use_ell):
    """The reference's host ``run_hybrid``.  Min/max programs run its
    dense path for either ``use_ell`` (bit-identical to its kernel path,
    as its own distributed tests hold); PageRank runs the matching path,
    since a sum's fold order is the path's."""
    a = jx()
    make = case_inputs(name)[6]
    dense = name != "pagerank" or not use_ell
    es, iters = a.run(ref_graph(name), make(a.apps), use_ell=not dense)
    return to_numpy(es), iters


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def assert_bits(got, want, what=""):
    """Bit for bit, NaN by position (payloads not compared)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (what, got.shape, want.shape, got.dtype, want.dtype)
    if got.dtype.kind == "f":
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
        got, want = got[~nan], want[~nan]
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), what


def assert_run_equal(got_es, got_iters, want_es, want_iters, what=""):
    """State leaves bit for bit, iterations and every counter exactly
    (the port's counters are int64, the reference's int32: compared as
    integers)."""
    got, want = to_numpy(got_es), to_numpy(want_es)
    assert got_iters == want_iters, (what, got_iters, want_iters)
    assert sorted(got["state"]) == sorted(want["state"]), what
    for k in want["state"]:
        assert_bits(got["state"][k], want["state"][k], f"{what} state.{k}")
    c, w = got["counters"], want["counters"]
    for f in ("iterations", "net_messages", "net_local_messages",
              "mem_messages"):
        assert int(c[f]) == int(w[f]), (what, f, int(c[f]), int(w[f]))
    np.testing.assert_array_equal(np.asarray(c["pseudo_supersteps"]),
                                  np.asarray(w["pseudo_supersteps"]),
                                  err_msg=what)


# ---------------------------------------------------------------------------
# the ranks' functions (module level, so a spawned rank can import them)
# ---------------------------------------------------------------------------

def _wire_inputs():
    """A 4-partition path graph and a state whose exports carry a genuine
    uint16 and uint8 leaf beside float ones (those of
    ``tests/test_core_engines.py``), in-range for float8."""
    edges, n = path_graph(16)
    part = np.repeat(np.arange(4), 4).astype(np.int32)
    rng = np.random.RandomState(0)
    p, vp = 4, 8                                 # pad_multiple=8
    arrays = {"flag16": rng.randint(0, 2**16, (p, vp)).astype(np.uint16),
              "flag8": rng.randint(0, 2**8, (p, vp)).astype(np.uint8),
              "val": rng.randn(p, vp).astype(np.float32),
              "big": rng.uniform(-240.0, 240.0, (p, vp)).astype(np.float32)}
    return edges, n, part, arrays


def _wire_state(graph, arrays, mod):
    """The engine state of ``_wire_inputs`` for the port (``mod`` None) or
    the reference (``mod`` its runtime module)."""
    p, vp, h = graph.n_partitions, graph.vp, graph.hp
    if mod is None:
        out = {k: torch.from_numpy(v) for k, v in arrays.items()}
        ones = torch.ones((p, vp), dtype=torch.bool)
        return EngineState(
            state=out, out=out, send=ones, active=ones, export_out=out,
            export_send=ones, pending={},
            halo_out={k: torch.zeros((p, h), dtype=v.dtype)
                      for k, v in out.items()},
            halo_send=torch.zeros((p, h), dtype=torch.bool),
            counters=Counters.zeros(p, torch.device("cpu")))
    jnp = jx().jnp
    out = {k: jnp.asarray(v) for k, v in arrays.items()}
    ones = jnp.ones((p, vp), bool)
    return mod.EngineState(
        state=out, out=out, send=ones, active=ones, export_out=out,
        export_send=ones, pending={},
        halo_out={k: jnp.zeros((p, h), v.dtype) for k, v in out.items()},
        halo_send=jnp.zeros((p, h), bool), counters=mod.Counters.zeros(p))


def _exchange_job(rank, world, group, device, graph, es):
    """This rank's halo tables after the exchange through the gloo
    ``gather_table``, exact and under each wire dtype."""
    bg = D.block_view(graph, rank, world, device)
    bes = D.block_state(es, rank, world, device)
    table = functools.partial(D.all_gather_rows, group=group)
    out = {}
    for wd in (None,) + WIRES:
        got = exchange(bg, bes, gather_table=table,
                       wire_dtype=None if wd is None else getattr(torch, wd))
        out[wd] = to_numpy({"halo_out": got.halo_out,
                            "halo_send": got.halo_send})
    return out


def _init_job(rank, world, group, device, graph, prog):
    """This rank's block init beside its block of the global init."""
    step = D.make_dist_hybrid_step(prog, group)
    got = step.init(D.block_view(graph, rank, world, device))
    want = D.block_state(init_hybrid(graph, prog, None), rank, world, device)
    return to_numpy(got), to_numpy(want)


def _step_error_job(rank, world, group, device, graph, prog):
    """The step's refusal of a graph whose blocks the world does not
    divide (before any collective)."""
    step = D.make_dist_hybrid_step(prog, group)
    try:
        step(graph, init_hybrid(graph, prog, None))
    except ValueError as e:
        return str(e)
    return None


def _ft_job(rank, world, group, device, graph, prog, dirs):
    """The distributed kill-and-resume of ``tests/test_distributed.py``'s
    ``_dist_ft_body``: an uninterrupted run, a run stopped after 3
    iterations and its resume (``dirs[0]``), and one more stopped run
    (``dirs[1]``) for the host to resume."""
    from repro_torch.ft import run_hybrid_ft

    bg = D.block_view(graph, rank, world, device)
    place = D.BlockPlacement(rank, world, group, device, graph)
    step = D.make_dist_hybrid_step(prog, group, placement=place)
    run = functools.partial(run_hybrid_ft, bg, prog, step_fn=step,
                            device=device)
    ref = run()
    r1 = run(ckpt_dir=dirs[0], max_iters=3)
    r2 = run(ckpt_dir=dirs[0])
    run(ckpt_dir=dirs[1], max_iters=3)
    runs = (("ref", ref), ("r1", r1), ("r2", r2))
    states = {k: place.gather(r.es) for k, r in runs}   # onto rank 0 alone
    if rank:
        return {"gathered_elsewhere": [k for k, v in states.items()
                                       if v is not None],
                "flags": [f.partition for f in ref.straggler_flags]}
    return {k: (to_numpy(states[k]), r.iterations, r.resumed_from)
            for k, r in runs} | {"flags": [f.partition
                                           for f in ref.straggler_flags]}


def _metrics_off_job(rank, world, group, device, graph, prog):
    """The step with ``collect_metrics=False``, run to quiescence; the
    state gathered onto rank 0."""
    from repro_torch.exec.driver import run_engine

    step = D.make_dist_hybrid_step(prog, group, collect_metrics=False)
    ctx = run_engine(D.block_view(graph, rank, world, device), prog,
                     step.policy(), None, max_iters=500)
    es = D.gather_state(ctx.es, group)
    return None if es is None else (to_numpy(es), ctx.iteration)


def _jobs_rank(rank, world, group, device, jobs):
    """Every job of one spawn, in order, on every rank."""
    out = []
    for kind, args in jobs:
        if kind == "run":
            graph, prog, knobs, trace = args
            r = D._hybrid_rank(rank, world, group, device, graph, prog, None,
                               knobs, trace)
            out.append(dict(r, es=to_numpy(r["es"])))
        else:
            out.append({"exchange": _exchange_job, "init": _init_job,
                        "step_error": _step_error_job,
                        "metrics_off": _metrics_off_job,
                        "ft": _ft_job}[kind](rank, world, group, device,
                                             *args))
    return out


def _fail_rank(rank, world, group, device):
    if rank == 1:
        raise RuntimeError("rank 1 gives up")
    dist.barrier(group=group)        # rank 0 waits on a rank that died


def _sleep_rank(rank, world, group, device):
    time.sleep(600)


# ---------------------------------------------------------------------------
# the spawns, one per world
# ---------------------------------------------------------------------------

def _knobs(use_ell, **kw):
    return dict(dict(max_iters=500, max_local_steps=10_000, wire_dtype=None,
                     use_ell=use_ell), **kw)


def _run_jobs():
    return [(("run", c, ue), ("run", (port_graph(c), case_inputs(c)[5],
                                      _knobs(ue), c == "pagerank" and ue)))
            for c in CASES for ue in (True, False)]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """One spawn of 4 ranks: every case × delivery, the bfloat16-wire run,
    the exchange, the block init, the step's refusal, a run without the
    message counters and the kill-and-resume of SSSP and PageRank."""
    edges, n, part, arrays = _wire_inputs()
    wg = build_partitioned_graph(edges, n, part, edge_blocks=4,
                                 device="cpu")
    grid = port_graph("grid_sssp")
    g2 = port_graph("grid_sssp", edge_blocks=2)
    dirs = {app: [str(tmp_path_factory.mktemp(f"{app}{i}"))
                  for i in range(2)] for app in ("sssp", "pagerank")}
    jobs = _run_jobs() + [
        (("wire",), ("run", (grid, SSSP(source=0),
                             _knobs(True, wire_dtype=torch.bfloat16),
                             False))),
        (("exchange",), ("exchange", (wg, _wire_state(wg, arrays, None)))),
        (("init",), ("init", (port_graph("pagerank"),
                              IncrementalPageRank(tolerance=1e-4)))),
        (("step_error",), ("step_error", (g2, SSSP(source=0)))),
        (("metrics_off",), ("metrics_off", (grid, SSSP(source=0)))),
        (("ft", "sssp"), ("ft", (grid, SSSP(source=0), dirs["sssp"]))),
        (("ft", "pagerank"), ("ft", (port_graph("pagerank"),
                                     IncrementalPageRank(tolerance=1e-4),
                                     dirs["pagerank"]))),
    ]
    t0 = time.monotonic()
    res = D.spawn_ranks(_jobs_rank, 4, args=([j for _, j in jobs],),
                        deadline_s=DEADLINE, **CPU)
    seconds = time.monotonic() - t0
    keys = [k for k, _ in jobs]
    return dict(seconds=seconds, dirs=dirs,
                by_rank=[dict(zip(keys, r)) for r in res])


@pytest.fixture(scope="module")
def world8():
    """One spawn of 8 ranks: every case × delivery.  Only the world-8
    cases request it, so it starts once the world-4 cases are done, and a
    spawn that fails fails those cases alone."""
    jobs = _run_jobs()
    t0 = time.monotonic()
    res = D.spawn_ranks(_jobs_rank, 8, args=([j for _, j in jobs],),
                        deadline_s=DEADLINE, **CPU)
    seconds = time.monotonic() - t0
    keys = [k for k, _ in jobs]
    return dict(seconds=seconds, by_rank=[dict(zip(keys, r)) for r in res])


# ---------------------------------------------------------------------------
# slice_flat's block branch and the quantized exchange
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_parts,edge_blocks,world", [
    (8, 4, 4),      # 2 partitions per edge block, 1 edge block per rank
    (8, 8, 4),      # 1 partition per edge block, 2 edge blocks per rank
    (16, 8, 4),     # 2 and 2
    (8, 8, 8),      # 1 and 1
])
def test_slice_flat_block_branch_matches_reference(n_parts, edge_blocks,
                                                   world):
    a = jx()
    edges, n, _ = _hub_edges()
    part = hash_partition(n, n_parts, seed=2)
    w = np.random.RandomState(5).uniform(0.5, 3.0, len(edges)) \
        .astype(np.float32)
    kw = dict(weights=w, edge_blocks=edge_blocks, ell_base_slices=8)
    pg = build_partitioned_graph(edges, n, part, device="cpu", **kw)
    rg = a.build(edges, n, part, **kw)
    assert len(pg.local_ell) > 1 and len(pg.remote_ell) > 1  # spill bins
    pb, bb = n_parts // world, edge_blocks // world
    for rank in range(world):
        bg = D.block_view(pg, rank, world, "cpu")
        for side in ("local_ell", "remote_ell"):
            for i, (ps, rs) in enumerate(zip(getattr(bg, side),
                                             getattr(rg, side))):
                cut = slice(rank * bb, (rank + 1) * bb)
                rs_b = dataclasses.replace(
                    rs, rows=rs.rows[cut], idx=rs.idx[cut], msk=rs.msk[cut])
                want = a.runtime.slice_flat(rs_b, rg, pb)
                got = slice_flat(ps, bg, pb)
                for name, gv, wv in zip(("rows", "idx", "msk"), got, want):
                    assert_bits(gv.numpy(), np.asarray(wv),
                                f"rank {rank} {side}[{i}].{name}")


def test_block_view_keeps_static_fields_global():
    g = port_graph("hub_sssp")
    b = D.block_view(g, 1, 4, "cpu")
    for f in dataclasses.fields(g):
        if f.metadata.get("static"):
            assert getattr(b, f.name) == getattr(g, f.name), f.name
    assert b.vertex_gid.shape[0] == g.n_partitions // 4
    assert b.edge_src.shape[0] == g.n_blocks // 4
    s, bs = g.remote_ell[1], b.remote_ell[1]
    assert bs.rows.shape[0] == s.rows.shape[0] // 4
    assert bs.flat_idx.shape[0] == s.flat_idx.shape[0] // 4
    np.testing.assert_array_equal(
        bs.idx.numpy(), s.idx[s.idx.shape[0] // 4:s.idx.shape[0] // 2])
    with pytest.raises(ValueError, match="divisible by the device count"):
        D.block_view(g, 0, 3, "cpu")


def test_block_view_flat_views_are_the_blocks_own():
    """A block's flat ELL views are re-offset to the block (no copy of the
    global ones rides along), ``slice_flat`` hands them out as they are,
    and refuses a block that was not cut by ``block_view``."""
    g = port_graph("hub_sssp")
    p = g.n_partitions // 4
    for rank in range(4):
        b = D.block_view(g, rank, 4, "cpu")
        for s in b.local_ell + b.remote_ell:
            rows, idx = block_flat(s, g.vp, p)
            got = slice_flat(s, b, p)
            assert got[0] is s.flat_rows and got[1] is s.flat_idx
            assert torch.equal(s.flat_rows, rows)
            assert torch.equal(s.flat_idx, idx)
            assert int(s.flat_rows.max()) <= p * g.vp     # block sentinel
    raw = D._map_tree(D._cut(1, 4, torch.device("cpu")), g)
    with pytest.raises(ValueError, match="block_view"):
        slice_flat(raw.remote_ell[0], raw, p)


def _ref_exchange(wd):
    a = jx()
    edges, n, part, arrays = _wire_inputs()
    rg = a.build(edges, n, part, edge_blocks=4)
    es = _wire_state(rg, arrays, a.runtime)
    got = a.runtime.exchange(
        rg, es, wire_dtype=None if wd is None else getattr(a.jnp, wd))
    return to_numpy({"halo_out": got.halo_out,
                     "halo_send": got.halo_send}), np.asarray(rg.halo_mask)


def _assert_halo_equal(got, want, hm, what):
    np.testing.assert_array_equal(got["halo_send"], want["halo_send"])
    for k in want["halo_out"]:
        assert_bits(got["halo_out"][k][hm], want["halo_out"][k][hm],
                    f"{what} {k}")


@pytest.mark.parametrize("wd", (None,) + WIRES)
def test_exchange_wire_matches_reference(wd):
    """Bit-exact on the masked halo slots: integer leaves untouched,
    float leaves rounded to the wire type and back as JAX rounds them."""
    edges, n, part, arrays = _wire_inputs()
    g = build_partitioned_graph(edges, n, part, edge_blocks=4, device="cpu")
    es = _wire_state(g, arrays, None)
    got = exchange(g, es, wire_dtype=None if wd is None
                   else getattr(torch, wd))
    want, hm = _ref_exchange(wd)
    _assert_halo_equal(to_numpy({"halo_out": got.halo_out,
                                 "halo_send": got.halo_send}), want, hm, wd)
    if wd is not None:                 # the wire did quantize the floats
        exact, _ = _ref_exchange(None)
        assert not np.array_equal(want["halo_out"]["val"][hm],
                                  exact["halo_out"]["val"][hm])


def test_exchange_refuses_unknown_wire_dtype():
    edges, n, part, arrays = _wire_inputs()
    g = build_partitioned_graph(edges, n, part, device="cpu")
    with pytest.raises(ValueError, match="wire_dtype"):
        exchange(g, _wire_state(g, arrays, None), wire_dtype=torch.float16)


@pytest.mark.parametrize("wd", (None,) + WIRES)
def test_exchange_through_gloo_gather_matches_reference(world4, wd):
    want, hm = _ref_exchange(wd)
    parts = [r[("exchange",)][wd] for r in world4["by_rank"]]
    got = {"halo_send": np.concatenate([p["halo_send"] for p in parts]),
           "halo_out": {k: np.concatenate([p["halo_out"][k] for p in parts])
                        for k in parts[0]["halo_out"]}}
    _assert_halo_equal(got, want, hm, wd)


def test_all_gather_rows_round_trips_every_dtype():
    """One rank's group: the byte path rebuilds bool, uint16, bfloat16
    and float8 leaves unchanged, all-gathered and gathered to rank 0."""
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        tree = {"b": torch.tensor([[True, False]]),
                "u16": torch.tensor([[65535, 1, 2]], dtype=torch.uint16),
                "bf": torch.tensor([[1.5, -2.25]], dtype=torch.bfloat16),
                "f8": torch.tensor([[0.5]]).to(torch.float8_e5m2)}
        D.reset_comm()
        for got in (D.all_gather_rows(tree), D.gather_state(tree)):
            for k, v in tree.items():
                assert got[k].dtype == v.dtype and got[k].shape == v.shape
                assert torch.equal(got[k].view(torch.uint8),
                                   v.view(torch.uint8))
        assert D.COMM["collectives"] == 2
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the distributed step against the reference's host run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_ell", [True, False])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", [4, 8])
def test_dist_step_matches_reference_host_run(request, world, case, use_ell):
    runs = request.getfixturevalue(f"world{world}")["by_rank"]
    got = runs[0][("run", case, use_ell)]
    want_es, want_iters = ref_run(case, use_ell)
    assert_run_equal(got["es"], got["iterations"], want_es, want_iters,
                     f"{case} world={world} use_ell={use_ell}")
    # every rank counted the same global iterations; pseudo-supersteps of
    # each block are its own partitions'
    pseudo = np.concatenate([r[("run", case, use_ell)]["pseudo_supersteps"]
                             .numpy() for r in runs])
    np.testing.assert_array_equal(pseudo,
                                  want_es["counters"]["pseudo_supersteps"])
    assert {r[("run", case, use_ell)]["iterations"] for r in runs} == \
        {want_iters}
    launches = got["launches"]
    assert not any(launches.values())     # CPU: the plain versions ran


def test_collectives_per_iteration(world4):
    """Per global iteration: one all-gather (the exchange), one all-reduce
    of the counter deltas and one of the quiescence check; plus the init
    reduce and the final check.  Nothing in the local loop."""
    r = world4["by_rank"][2][("run", "grid_sssp", True)]
    assert r["comm"]["collectives"] == 3 * r["iterations"] + 2
    assert r["comm"]["staged_bytes"] == 0          # CPU tensors


def test_dist_wire_run_matches_reference_wire_loop(world4):
    """SSSP over a bfloat16 wire, against the reference's
    ``hybrid_iteration(wire_dtype=jnp.bfloat16)`` loop."""
    want_es, want_iters = _ref_wire_loop()
    got = world4["by_rank"][0][("wire",)]
    assert_run_equal(got["es"], got["iterations"], want_es, want_iters,
                     "bf16 wire")
    exact = world4["by_rank"][0][("run", "grid_sssp", True)]
    assert got["comm"]["wire_bytes"] / got["iterations"] < \
        exact["comm"]["wire_bytes"] / exact["iterations"]


@functools.lru_cache(maxsize=None)
def _ref_wire_loop():
    a = jx()
    rg = ref_graph("grid_sssp")
    prog = a.apps.SSSP(source=0)
    step = a.jax.jit(functools.partial(a.iteration.hybrid_iteration, rg,
                                       prog, vdata=None,
                                       wire_dtype=a.jnp.bfloat16))
    es = a.iteration.init_hybrid(rg, prog, None)
    iters = 0
    while not bool(a.runtime.quiescent(prog, es)) and iters < 500:
        es = step(es=es)
        iters += 1
    return to_numpy(es), iters


def test_phased_run_wire_matches_reference_wire_loop():
    from repro_torch.obs.trace import phased_run

    want_es, want_iters = _ref_wire_loop()
    res = phased_run(port_graph("grid_sssp"), SSSP(source=0), "hybrid",
                     None, wire_dtype=torch.bfloat16)
    assert_run_equal(res.es, res.iterations, want_es, want_iters,
                     "phased bf16")
    assert all(r.exchange_bytes % 2 == 0 for r in res.records)


def test_traced_dist_step_spans_match_reference_accounting(world4):
    """One ``dist_step`` span per global iteration on rank 0; its per-block
    args equal the reference's per-partition exchange bytes, halo slots
    and pseudo-supersteps summed per block of 2 partitions."""
    a = jx()
    rg = ref_graph("pagerank")
    prog = a.apps.IncrementalPageRank(tolerance=1e-4)
    step = a.jax.jit(functools.partial(a.iteration.hybrid_iteration, rg,
                                       prog, vdata=None))
    es = a.iteration.init_hybrid(rg, prog, None)
    blocked = lambda v: [int(b.sum()) for b in np.array_split(v, 4)]
    halo = blocked(np.asarray(a.trace.halo_slots_per_partition(rg)))
    want = []
    while not bool(a.runtime.quiescent(prog, es)):
        xb = np.asarray(a.trace.exchange_bytes_per_partition(rg, es))
        before = np.asarray(es.counters.pseudo_supersteps)
        es = step(es=es)
        want.append(dict(
            exchange_bytes_per_block=blocked(xb),
            halo_slots_per_block=halo,
            pseudo_supersteps_per_block=blocked(
                np.asarray(es.counters.pseudo_supersteps) - before)))
    r0 = world4["by_rank"][0][("run", "pagerank", True)]
    spans = r0["spans"]
    assert [s.name for s in spans] == ["dist_step"] * len(want)
    assert [s.args["iteration"] for s in spans] == \
        list(range(1, len(want) + 1))
    for s, w in zip(spans, want):
        for k, v in w.items():
            assert s.args[k] == v, (s.args["iteration"], k)
    assert all(r[("run", "pagerank", True)]["spans"] is None
               for r in world4["by_rank"][1:])


def test_block_init_equals_global_init_slice(world4):
    for rank, r in enumerate(world4["by_rank"]):
        got, want = r[("init",)]
        for k in ("state", "out", "send", "active", "export_out",
                  "export_send", "pending", "halo_out", "halo_send"):
            _assert_tree_bits(got[k], want[k], f"rank {rank} {k}")
        c, w = got["counters"], want["counters"]
        np.testing.assert_array_equal(c["pseudo_supersteps"],
                                      w["pseudo_supersteps"])
    # the replicated init counters are the global init's
    g = port_graph("pagerank")
    full = init_hybrid(g, IncrementalPageRank(tolerance=1e-4), None)
    c = world4["by_rank"][3][("init",)][0]["counters"]
    for f in ("net_messages", "net_local_messages", "mem_messages"):
        assert int(c[f]) == int(getattr(full.counters, f)), f


def _assert_tree_bits(got, want, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_tree_bits(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, list):
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_bits(g, w, f"{what}[{i}]")
    else:
        assert_bits(got, want, what)


# ---------------------------------------------------------------------------
# dry-run shapes
# ---------------------------------------------------------------------------

def test_dry_run_shapes_match_reference():
    a = jx()
    kw = dict(n_partitions=8, vp=16, ep=40, xp=4, hp=6, kl=8, n_blocks=4)
    want = a.dist.block_graph_shapes(**kw)
    got = D.block_graph_shapes(**kw)

    def leaves(g):
        out = {}
        for f in dataclasses.fields(g):
            v = getattr(g, f.name)
            if f.name in ("local_ell", "remote_ell"):
                for i, s in enumerate(v):
                    for sf in dataclasses.fields(s):
                        out[f"{f.name}{i}.{sf.name}"] = getattr(s, sf.name)
            else:
                out[f.name] = v
        return out

    lw, lg = leaves(want), leaves(got)
    assert sorted(lw) == sorted(lg)
    for k, w in lw.items():
        g = lg[k]
        if isinstance(g, torch.Tensor):
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape), k
            assert str(g.dtype).split(".")[1] == str(w.dtype), k
        else:
            assert g == w, k
    es_w = a.dist.engine_state_shapes(a.apps.SSSP(source=0), want)
    es_g = D.engine_state_shapes(SSSP(source=0), got)
    fw = dict(_named(es_w))
    fg = dict(_named(es_g))
    assert sorted(fw) == sorted(fg)
    for k, w in fw.items():
        assert tuple(fg[k].shape) == tuple(w.shape), k
        # the port's counters are int64 (its Counters docstring: a
        # full-size run counts past 2**31); every other leaf keeps its dtype
        want_dt = "int64" if k.startswith(".counters") else str(w.dtype)
        assert str(fg[k].dtype).split(".")[1] == want_dt, k


def _named(tree):
    from repro_torch.checkpoint.ckpt import _flatten_with_names
    return _flatten_with_names(tree)


# ---------------------------------------------------------------------------
# kill and resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_dist_ft_kill_resume(world4, app):
    """``run_hybrid_ft(step_fn=)`` with a placed distributed step, stopped
    after 3 iterations and resumed: bit-identical to the uninterrupted
    distributed run, state and every counter; the state is gathered onto
    rank 0 alone, and every rank flags the same stragglers; the rank-0
    checkpoint of another stopped run resumes in the host
    ``run_hybrid_ft`` to the same end."""
    from repro_torch.ft import run_hybrid_ft

    out = world4["by_rank"][0][("ft", app)]
    for r in world4["by_rank"][1:]:
        assert r[("ft", app)]["gathered_elsewhere"] == []
        assert r[("ft", app)]["flags"] == out["flags"]
    (ref, ref_it, _), (_, it1, from1), (r2, it2, from2) = \
        out["ref"], out["r1"], out["r2"]
    assert it1 == 3 < ref_it and from1 is None
    assert from2 is not None and from2.endswith("step_00000003")
    assert_run_equal(r2, it2, ref, ref_it, f"{app} resumed")
    # and the uninterrupted distributed run is the host run
    name = "grid_sssp" if app == "sssp" else "pagerank"
    assert_run_equal(ref, ref_it, *ref_run(name, True), f"{app} ft")
    graph = port_graph(name)
    prog = case_inputs(name)[5]
    host = run_hybrid_ft(graph, prog, ckpt_dir=world4["dirs"][app][1],
                         device="cpu")
    assert host.resumed_from.endswith("step_00000003")
    assert_run_equal(host.es, host.iterations, ref, ref_it, f"{app} host")
    assert [f.partition for f in host.straggler_flags] == out["flags"]


def test_run_hybrid_ft_refuses_a_step_without_placement():
    """A plain ``step_fn``, or the distributed step without a placement,
    is refused before any collective."""
    from repro_torch.ft import run_hybrid_ft

    g = port_graph("grid_sssp")
    prog = SSSP(source=0)
    for step in (lambda graph, es: es, D.make_dist_hybrid_step(prog)):
        with pytest.raises(TypeError, match="placement=BlockPlacement"):
            run_hybrid_ft(g, prog, step_fn=step, device="cpu")


def test_dist_step_without_metrics(world4):
    """``collect_metrics=False`` on the distributed step: the host run's
    state and iterations, the three message counters left at zero."""
    want_es, want_iters = ref_run("grid_sssp", True)
    got_es, got_iters = world4["by_rank"][0][("metrics_off",)]
    assert got_iters == want_iters
    for k in want_es["state"]:
        assert_bits(got_es["state"][k], want_es["state"][k], k)
    for f in ("net_messages", "net_local_messages", "mem_messages"):
        assert int(got_es["counters"][f]) == 0, f
    assert all(r[("metrics_off",)] is None for r in world4["by_rank"][1:])


# ---------------------------------------------------------------------------
# failures
# ---------------------------------------------------------------------------

def test_world_must_divide_blocks(world4):
    g2 = port_graph("grid_sssp", edge_blocks=2)
    with pytest.raises(ValueError, match="divisible by the device count"):
        D.run_dist_hybrid(g2, SSSP(source=0), 4, **CPU)
    for r in world4["by_rank"]:                    # the step itself
        assert "n_blocks (2) divisible by the device count (4)" in \
            r[("step_error",)]


def test_nccl_needs_a_card_per_rank():
    world = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="one card per rank"):
        D.spawn_ranks(_sleep_rank, world, "nccl", "cuda")
    with pytest.raises(ValueError, match="device='cuda'"):
        D.spawn_ranks(_sleep_rank, 2, "nccl", "cpu")
    with pytest.raises(ValueError, match="backend"):
        D.spawn_ranks(_sleep_rank, 2, "mpi", "cpu")


def test_dead_rank_fails_the_run():
    """Rank 1 raises while rank 0 waits in a collective: the run fails
    with rank 1's traceback, long before the deadline, and no rank is
    left running."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 gives up") as e:
        D.spawn_ranks(_fail_rank, 2, deadline_s=DEADLINE, **CPU)
    assert time.monotonic() - t0 < DEADLINE / 2
    # the root cause first, whether rank 0 failed in its barrier yet or not
    assert str(e.value).startswith("rank 1 failed")


def test_deadline_kills_every_rank():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running after 8"):
        D.spawn_ranks(_sleep_rank, 2, deadline_s=8.0, **CPU)
    assert time.monotonic() - t0 < 60


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", ["hub_sssp", "pagerank"])
def test_dist_on_the_card_matches_host_run(case):
    """4 ranks sharing the card over gloo (staged through host memory):
    state and every counter equal the single-process run on the card, and
    the kernels launched inside the ranks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    g = port_graph(case)
    prog = case_inputs(case)[5]
    got = D.run_dist_hybrid(g, prog, 4, backend="gloo", device="cuda",
                            deadline_s=DEADLINE)
    want = run_hybrid(D.block_view(g, 0, 1, "cuda"), prog)
    assert_run_equal(got.es, got.iterations, *want, case)
    assert all(r["comm"]["staged_bytes"] > 0 for r in got.ranks)
    kernel = "min_step" if case == "hub_sssp" else "pr_step"
    assert all(r["launches"][kernel] > 0 and r["launches"]["ell_spmv"] > 0
               for r in got.ranks)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["hub_sssp", "pagerank"])
def test_dist_nccl_card_per_rank_matches_host_run(case, tmp_path):
    """NCCL, rank r on ``cuda:r``, one rank per card of the host: the
    traced run equals the single-process run on the card (nothing staged
    through host memory, one ``dist_step`` span per iteration), and the
    kill-and-resume, whose checkpoints gather onto rank 0, equals the
    uninterrupted run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    world = torch.cuda.device_count()
    g = port_graph(case)
    if g.n_blocks % world:
        pytest.skip(f"{g.n_blocks} edge blocks on {world} cards")
    prog = case_inputs(case)[5]
    got = D.run_dist_hybrid(g, prog, world, backend="nccl", device="cuda",
                            trace=True, deadline_s=DEADLINE)
    want = run_hybrid(D.block_view(g, 0, 1, "cuda"), prog)
    assert_run_equal(got.es, got.iterations, *want, case)
    assert all(r["comm"]["staged_bytes"] == 0 for r in got.ranks)
    assert [s.name for s in got.spans] == ["dist_step"] * got.iterations
    kernel = "min_step" if case == "hub_sssp" else "pr_step"
    assert all(r["launches"][kernel] > 0 and r["launches"]["ell_spmv"] > 0
               for r in got.ranks)
    dirs = [str(tmp_path / "a"), str(tmp_path / "b")]
    out = D.spawn_ranks(_jobs_rank, world, "nccl", "cuda",
                        args=([("ft", (g, prog, dirs))],),
                        deadline_s=DEADLINE)[0][0]
    (ref, ref_it, _), (r2, it2, from2) = out["ref"], out["r2"]
    assert from2.endswith("step_00000003")
    assert_run_equal(r2, it2, ref, ref_it, f"{case} nccl resumed")
    assert_run_equal(ref, ref_it, *want, f"{case} nccl ft")
