"""The port's three engines and its dense delivery path against the
reference, on the CPU.

* All 36 rows of ``tests/data/golden_executor.json`` (6 apps × {bsp, am,
  hybrid} × {dense, ell}) through ``run_bsp`` / ``run_am`` /
  ``run_hybrid(device="cpu")``: digest, iterations and every counter
  exact, no tolerance.  The dense ``sum`` channel folds each destination's
  edges in flat edge order, as XLA's ``segment_sum`` does on the host, so
  the PageRank dense digests match too.
* ``combine_segments`` against the reference's on the same numpy inputs,
  bit for bit: signed zeros, ±inf ties and NaN (by position) for min/max,
  order-sensitive float sums, wrapping int32 sums, ``lexmin`` ties,
  ``(E, L)`` lane payloads.
* One dense ``deliver`` along all / local / remote edges on the hub
  fixture, and a program mixing an ELL channel with a dense one, against
  the reference's delivery and runs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import run_am as jax_run_am
from repro.core import run_bsp as jax_run_bsp
from repro.core import run_hybrid as jax_run_hybrid
from repro.core.apps import SSSP as JaxSSSP
from repro.core.apps import IncrementalPageRank as JaxPageRank
from repro.core.runtime import deliver as jax_deliver
from repro.core.runtime import exchange as jax_exchange
from repro.core.runtime import init_state as jax_init_state
from repro.core.vertex_program import Channel as JaxChannel
from repro.core.vertex_program import combine_segments as jax_combine

from repro_torch import (SSSP, WCC, BipartiteMatching, IncrementalPageRank,
                         RandomWalk, WidestPath, build_partitioned_graph,
                         pagerank_edge_weights, random_walk_edge_weights,
                         run_am, run_bsp, run_hybrid)
from repro_torch.convert import engine_state_from_numpy, to_numpy
from repro_torch.core.runtime import deliver
from repro_torch.core.vertex_program import Channel, combine_segments
from repro_torch.data.graphs import (bipartite_graph, grid_graph, rmat_graph,
                                     symmetrize)
from repro_torch.exec.policy import POLICIES, make_policy
from repro_torch.partition import bfs_partition, hash_partition

from test_executor_parity import _load_golden
from test_torch_engine import _graphs, _snapshot

RUNNERS = {"bsp": run_bsp, "am": run_am, "hybrid": run_hybrid}
JAX_RUNNERS = {"bsp": jax_run_bsp, "am": jax_run_am,
               "hybrid": jax_run_hybrid}
ENGINES = ("bsp", "am", "hybrid")
DELIVERY = (("dense", False), ("ell", True))
GOLDEN_APPS = ("sssp", "pagerank", "wcc", "widest", "random_walk",
               "bipartite")


def golden_workloads():
    """The golden suite's six workloads (``test_executor_parity``), built
    by the port's builder on the CPU: ``{app: (graph, make_prog, vdata)}``."""
    build = lambda *a, **k: build_partitioned_graph(*a, device="cpu", **k)
    out = {}
    edges, w, n = grid_graph(6, 30, seed=3)
    out["sssp"] = (build(edges, n, bfs_partition(edges, n, 4, seed=1),
                         weights=w), lambda: SSSP(source=0), None)

    edges, n = rmat_graph(200, avg_degree=5, seed=7)
    out["pagerank"] = (build(edges, n, hash_partition(n, 4, seed=2),
                             weights=pagerank_edge_weights(edges, n)),
                       lambda: IncrementalPageRank(tolerance=1e-4), None)

    rng = np.random.RandomState(0)
    blocks, off = [], 0
    for size in (30, 25):
        e = rng.randint(0, size, size=(size * 3, 2)) + off
        p = np.stack([np.arange(size - 1), np.arange(1, size)], axis=1) + off
        blocks.append(np.concatenate([e, p], axis=0))
        off += size
    edges = symmetrize(np.concatenate(blocks, axis=0))
    edges = edges[edges[:, 0] != edges[:, 1]]
    out["wcc"] = (build(edges, off, hash_partition(off, 4, seed=3)),
                  lambda: WCC(), None)

    edges, n = rmat_graph(150, avg_degree=5, seed=9)
    w = (np.random.RandomState(19).uniform(0.5, 8.0, size=len(edges))
         .astype(np.float32))
    out["widest"] = (build(edges, n, hash_partition(n, 4, seed=1),
                           weights=w), lambda: WidestPath(source=0), None)

    edges, n = rmat_graph(150, avg_degree=5, seed=15)
    out["random_walk"] = (
        build(edges, n, bfs_partition(edges, n, 4, seed=2),
              weights=random_walk_edge_weights(edges, n, "odds")),
        lambda: RandomWalk(source=0, mode="odds"), None)

    edges, n_left, n = bipartite_graph(30, 25, avg_degree=3, seed=11)
    g = build(edges, n, hash_partition(n, 4, seed=4))
    vdata = {"is_left": g.vertex_gid < n_left, "degree": g.out_degree}
    out["bipartite"] = (g, lambda: BipartiteMatching(seed=1), vdata)
    return out


@pytest.fixture(scope="module")
def workloads():
    return golden_workloads()


@pytest.mark.parametrize("delivery,use_ell", DELIVERY)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("app", GOLDEN_APPS)
def test_golden_rows(workloads, app, engine, delivery, use_ell):
    graph, make_prog, vdata = workloads[app]
    got = _snapshot(*RUNNERS[engine](graph, make_prog(), vdata=vdata,
                                     max_iters=500, use_ell=use_ell,
                                     device="cpu"))
    assert got == _load_golden()[app][engine][delivery]


# ---------------------------------------------------------------------------
# combine_segments
# ---------------------------------------------------------------------------

PALETTE = np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, 2.5, np.nan],
                   dtype=np.float32)
E, N_SEG = 600, 64          # segments 56..63 receive no edge


def _assert_bits(got, want):
    """Bit for bit; float NaN by position only."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype.kind == "f":
        gn, wn = np.isnan(got), np.isnan(want)
        np.testing.assert_array_equal(gn, wn)
        got, want = got[~gn], want[~wn]
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want)


def _combine_both(combiner, components, payloads, valid, dst, lanes=0):
    jch = JaxChannel("c", combiner, tuple((jnp.dtype(dt), i)
                                          for dt, i in components),
                     lanes=lanes)
    ch = Channel("c", combiner, tuple(
        (getattr(torch, np.dtype(dt).name), i) for dt, i in components),
        lanes=lanes)
    want_pl, want_has = jax_combine(
        jch, tuple(jnp.asarray(p) for p in payloads), jnp.asarray(valid),
        jnp.asarray(dst), N_SEG)
    got_pl, got_has = combine_segments(
        ch, tuple(torch.from_numpy(p) for p in payloads),
        torch.from_numpy(valid), torch.from_numpy(dst), N_SEG)
    np.testing.assert_array_equal(got_has.numpy(), np.asarray(want_has))
    for g, w in zip(got_pl, want_pl):
        _assert_bits(g.numpy(), w)


def _edges(rng):
    dst = rng.integers(0, N_SEG - 8, E).astype(np.int32)
    return dst, rng.random(E) < 0.7


@pytest.mark.parametrize("lanes", [0, 3])
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("combiner", ["min", "max"])
def test_combine_min_max_special_values(combiner, nan, lanes):
    rng = np.random.default_rng(5)
    dst, valid = _edges(rng)
    shape = (E, lanes) if lanes else (E,)
    pal = PALETTE if nan else PALETTE[:-1]
    p = rng.choice(pal, shape).astype(np.float32)
    ident = np.inf if combiner == "min" else -np.inf
    _combine_both(combiner, ((np.float32, ident),), (p,), valid, dst, lanes)


@pytest.mark.parametrize("lanes", [0, 3])
@pytest.mark.parametrize("special", [False, True])
def test_combine_sum_keeps_the_fold_order(special, lanes):
    """Mixed magnitudes make every reordering of a segment's sum visible
    in its last bits; ``special`` mixes in signed zeros, ±inf and NaN."""
    rng = np.random.default_rng(6)
    dst, valid = _edges(rng)
    shape = (E, lanes) if lanes else (E,)
    mag = rng.choice(np.array([1e-3, 1.0, 3e3, 1e7], np.float32), shape)
    p = (rng.standard_normal(shape) * mag).astype(np.float32)
    if special:
        pick = rng.random(shape) < 0.2
        p = np.where(pick, rng.choice(PALETTE, shape), p).astype(np.float32)
    _combine_both("sum", ((np.float32, 0.0),), (p,), valid, dst, lanes)


@pytest.mark.parametrize("combiner,ident", [("sum", 0), ("min", 2**31 - 1),
                                            ("max", 0),
                                            ("max", -(2**31))])
def test_combine_int32(combiner, ident):
    """int32 payloads; the sums wrap past 2**31 as XLA's do, and a max
    channel whose identity is 0 leaves int32's minimum in empty segments."""
    rng = np.random.default_rng(8)
    dst, valid = _edges(rng)
    p = rng.integers(-(2**31), 2**31 - 1, E).astype(np.int32)
    _combine_both(combiner, ((np.int32, ident),), (p,), valid, dst)


@pytest.mark.parametrize("n_comp", [2, 3])
def test_combine_lexmin_ties(n_comp):
    """Small component ranges give ties on the leading components, so the
    cascade's later components decide."""
    rng = np.random.default_rng(9)
    dst, valid = _edges(rng)
    imax = 2**31 - 1
    payloads = tuple(rng.integers(0, r, E).astype(np.int32)
                     for r in (3, 4, 50)[:n_comp])
    _combine_both("lexmin", ((np.int32, imax),) * n_comp, payloads, valid,
                  dst)


# ---------------------------------------------------------------------------
# dense deliver on the hub fixture, and a mixed ELL + dense program
# ---------------------------------------------------------------------------

PROGRAMS = {
    "sssp": (lambda: JaxSSSP(source=0), lambda: SSSP(source=0)),
    "pagerank": (lambda: JaxPageRank(tolerance=1e-4),
                 lambda: IncrementalPageRank(tolerance=1e-4)),
}


def _random_state(jax_graph, jax_prog, seed):
    """A reference engine state after init and one exchange, with random
    out-states and send flags (about half the edges valid; PageRank
    deltas of mixed magnitude, so the sum order shows)."""
    rng = np.random.default_rng(seed)
    es = jax_exchange(jax_graph, jax_init_state(jax_graph, jax_prog, None))
    vmask = np.asarray(jax_graph.vertex_mask)
    mag = lambda s: rng.choice(np.array([1e-4, 1.0, 1e4], np.float32), s)
    rand = lambda a: jnp.asarray((rng.random(a.shape) * mag(a.shape))
                                 .astype(np.float32))
    return dataclasses.replace(
        es, out={k: rand(v) for k, v in es.out.items()},
        halo_out={k: rand(v) for k, v in es.halo_out.items()},
        send=jnp.asarray((rng.random(vmask.shape) < 0.5) & vmask),
        halo_send=jnp.asarray(np.asarray(es.halo_send)
                              | (rng.random(es.halo_send.shape) < 0.5)))


def _state_equal(got_es, want_es):
    got, want = to_numpy(got_es), to_numpy(want_es)
    for k, v in want.pop("counters").items():
        np.testing.assert_array_equal(got["counters"][k],
                                      np.asarray(v, np.int64), err_msg=k)
    got.pop("counters")
    for ch, ((gp, gh), (wp, wh)) in ((ch, (got["pending"][ch],
                                           want["pending"][ch]))
                                     for ch in want["pending"]):
        np.testing.assert_array_equal(gh, wh, err_msg=ch)
        for g, w in zip(gp, wp):
            _assert_bits(g, w)


@pytest.mark.parametrize("metrics", [True, False])
@pytest.mark.parametrize("edges", ["all", "local", "remote"])
@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_dense_deliver_matches_reference(app, edges, metrics):
    jax_graph, graph = _graphs("hub")
    make_jax, make_port = PROGRAMS[app]
    jes = _random_state(jax_graph, make_jax(), seed=len(edges))
    es = engine_state_from_numpy(to_numpy(jes), device="cpu")
    want, want_any = jax_deliver(jax_graph, make_jax(), jes, edges,
                                 use_ell=False, collect_metrics=metrics)
    got, got_any = deliver(graph, make_port(), es, edges, use_ell=False,
                           collect_metrics=metrics)
    np.testing.assert_array_equal(got_any.numpy(), np.asarray(want_any))
    _state_equal(got, want)


def _mixed_program(xp, base, channel, int32, boolean):
    """``base`` (SSSP) plus a dense int32 ``sum`` channel counting the
    in-edges a vertex heard from: its distance rides the ELL kernels, the
    count the dense path, in one ``deliver``."""

    class Mixed(base):
        channels = base.channels + (channel("heard", "sum", ((int32, 0),)),)
        fused_kernel = None

        def init(self, gid, vmask, vdata):
            state, out, send, active = super().init(gid, vmask, vdata)
            return dict(state, heard=xp.zeros_like(gid)), out, send, active

        def emit(self, ch, out_src, w, src_gid, dst_gid):
            if ch.name == "heard":
                return (xp.ones_like(src_gid),), \
                    xp.ones_like(w, dtype=boolean)
            return super().emit(ch, out_src, w, src_gid, dst_gid)

        def apply(self, state, inbox, gid, vmask, vdata, info):
            new, out, send, active = super().apply(state, inbox, gid, vmask,
                                                   vdata, info)
            (cnt,), has = inbox["heard"]
            heard = state["heard"] + xp.where(has, cnt, 0)
            return dict(new, heard=heard), out, send, active

    return Mixed(source=0)


def _mixed_pair():
    return (_mixed_program(jnp, JaxSSSP, JaxChannel, jnp.int32, bool),
            _mixed_program(torch, SSSP, Channel, torch.int32, torch.bool))


@pytest.mark.parametrize("edges", ["local", "remote"])
def test_mixed_program_deliver_matches_reference(edges):
    jax_graph, graph = _graphs("hub")
    jax_prog, prog = _mixed_pair()
    jes = _random_state(jax_graph, jax_prog, seed=11)
    es = engine_state_from_numpy(to_numpy(jes), device="cpu")
    want, _ = jax_deliver(jax_graph, jax_prog, jes, edges, use_ell=True)
    got, _ = deliver(graph, prog, es, edges, use_ell=True)
    _state_equal(got, want)


@pytest.mark.parametrize("engine", ENGINES)
def test_mixed_program_runs_match_reference(engine):
    jax_graph, graph = _graphs("hub")
    jax_prog, prog = _mixed_pair()
    want = _snapshot(*JAX_RUNNERS[engine](jax_graph, jax_prog,
                                          max_iters=500, use_ell=True))
    got = _snapshot(*RUNNERS[engine](graph, prog, max_iters=500,
                                     use_ell=True, device="cpu"))
    assert got == want


@pytest.mark.parametrize("use_ell", [True, False])
@pytest.mark.parametrize("engine", ["bsp", "am"])
@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_hub_runs_match_reference(app, engine, use_ell):
    """BSP and AM on the hub graph, whose spill bins ride both halves of
    the split delivery, against live reference runs."""
    jax_graph, graph = _graphs("hub")
    make_jax, make_port = PROGRAMS[app]
    want = _snapshot(*JAX_RUNNERS[engine](jax_graph, make_jax(),
                                          max_iters=500, use_ell=use_ell))
    got = _snapshot(*RUNNERS[engine](graph, make_port(), max_iters=500,
                                     use_ell=use_ell, device="cpu"))
    assert got == want


def test_policies():
    assert sorted(POLICIES) == ["am", "bsp", "hybrid"]
    for name in POLICIES:
        assert make_policy(name, use_ell=False).name == name
    with pytest.raises(KeyError, match="unknown engine"):
        make_policy("pregel")


@pytest.mark.parametrize("runner", ["bsp", "am"])
def test_engines_check_the_device(runner):
    _, graph = _graphs("sssp")
    with pytest.raises(ValueError, match="graph lives on"):
        RUNNERS[runner](graph, SSSP(source=0), device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RUNNERS[runner](graph, SSSP(source=0))


@pytest.mark.gpu
@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_cuda_dense_and_engines_match_cpu(app):
    """On the card: one dense ``deliver(edges="all")`` and every engine ×
    delivery on the hub fixture equal the CPU run bit for bit — the
    ordered segment fold included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    jax_graph, _ = _graphs("hub")
    make_jax, make_port = PROGRAMS[app]
    fields = to_numpy(_random_state(jax_graph, make_jax(), seed=4))
    from test_torch_graph import fixture
    edges, n, part, w, kw = fixture("hub")
    results = []
    for device in ("cpu", "cuda"):
        graph = build_partitioned_graph(edges, n, part, weights=w,
                                        device=device, **kw)
        es, _ = deliver(graph, make_port(),
                        engine_state_from_numpy(fields, device=device),
                        "all", use_ell=False)
        runs = [_snapshot(*RUNNERS[e](graph, make_port(), use_ell=u,
                                      device=device))
                for e in ENGINES for _, u in DELIVERY]
        results.append((to_numpy(es.pending), to_numpy(es.counters), runs))
    (cpu_pending, cpu_counters, cpu_runs), (pending, counters, runs) = results
    assert runs == cpu_runs
    for k, v in cpu_counters.items():
        np.testing.assert_array_equal(counters[k], v)
    for ch, ((gp, gh), (wp, wh)) in ((c, (pending[c], cpu_pending[c]))
                                     for c in cpu_pending):
        np.testing.assert_array_equal(gh, wh)
        for g, w_ in zip(gp, wp):
            _assert_bits(g, w_)
