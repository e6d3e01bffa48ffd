"""The port's graph-query serving layer against the reference's.

Mirrors ``test_serve.py`` case by case on the port (``device="cpu"``),
and holds it against the live reference ``repro.serve.ServeEngine`` on
the same graphs (built by the reference, carried to the port through
``repro_torch.convert``):

  * ``trace_counts`` equal: one dispatch-cache entry per (program, K);
  * sssp / widest / reach results bit-identical to the reference's K-lane
    dispatch; ppr lanes bit-identical to the reference's *single-lane*
    dispatch (with an (N, L) frontier the reference contracts into FMAs on
    XLA:CPU for some L, the port never does);
  * ``stream`` yield order and iterations equal;
  * kill-and-resume ``ResumeEvent``s equal;
  * the persisted statistics registry equal under fake clocks, and
    loadable in either package;
  * every state leaf untouched in place across a hybrid K-lane step (the
    lane-convergence check compares a step's state with the one before).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointError as JaxCheckpointError
from repro.core import build_partitioned_graph as jax_build
from repro.obs import clock as jax_clock
from repro.obs import metrics as jax_metrics
from repro.serve import ServeEngine as JaxServeEngine

from repro_torch.checkpoint.ckpt import CheckpointError
from repro_torch.convert import graph_from_numpy, to_numpy
from repro_torch.core import run_hybrid
from repro_torch.core.apps import (SSSP, MultiSourceMonotone,
                                   PersonalizedPageRank,
                                   pagerank_edge_weights)
from repro_torch.core.graph import unpack_vertex
from repro_torch.data.graphs import rmat_graph
from repro_torch.exec.policy import hybrid_policy
from repro_torch.exec.syncs import host_reads, reset_host_reads
from repro_torch.ft.straggler import StragglerMitigator
from repro_torch.io.format import save_graph
from repro_torch.obs import clock as obs_clock
from repro_torch.obs.metrics import load_registry
from repro_torch.partition import hash_partition
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import STATS_FILENAME

CPU = dict(device="cpu")


def _inputs():
    """``test_serve.py``'s graph: R-MAT 128, sin weights, hash at P = 4."""
    edges, n = rmat_graph(128, avg_degree=5, seed=3)
    w = (np.abs(np.sin(np.arange(len(edges)))) * 0.9 + 0.05).astype(
        np.float32)
    return edges, n, w


@pytest.fixture(scope="module")
def jax_graph():
    edges, n, w = _inputs()
    return jax_build(edges, n, "hash", weights=w, n_partitions=4), n


@pytest.fixture(scope="module")
def graph(jax_graph):
    g, n = jax_graph
    return graph_from_numpy(to_numpy(g), **CPU), n


@pytest.fixture(scope="module")
def web():
    """PageRank weights for ppr (the sin weights sum past 1 per vertex, so
    an unnormalized PageRank on them would not converge)."""
    edges, n = rmat_graph(200, avg_degree=5, seed=7)
    jg = jax_build(edges, n, hash_partition(n, 4, seed=2),
                   weights=pagerank_edge_weights(edges, n))
    return jg, graph_from_numpy(to_numpy(jg), **CPU), n


@pytest.fixture(scope="module")
def engine(graph):
    # single lane width: every batch pads to 4 lanes, so the whole module
    # shares ONE (sssp, 4) cache entry
    return ServeEngine(graph[0], lane_widths=(4,), **CPU)


def test_request_ids_monotonic_across_rounds(engine, graph):
    """Two submit/run rounds hand out strictly increasing ids and both
    rounds answer correctly."""
    g, n = graph
    r1 = [engine.submit("sssp", s) for s in (0, 17, 99)]
    done1 = engine.run()
    r2 = [engine.submit("sssp", s) for s in (5, 0)]
    done2 = engine.run()
    ids = [q.request_id for q in r1 + r2]
    assert ids == sorted(ids) and len(set(ids)) == len(ids)
    assert all(q.done for q in done1 + done2)
    # both rounds produce the single-source fixed points
    es, _ = run_hybrid(g, SSSP(source=0), **CPU)
    ref0 = unpack_vertex(g, es.state["dist"])
    np.testing.assert_array_equal(r1[0].result, ref0)
    np.testing.assert_array_equal(r2[1].result, ref0)


def test_one_compile_per_program_width(engine):
    """Batches of 1..4 queries all pad to the fixed lane width, so every
    dispatch so far reused one (program, K) cache entry."""
    q = engine.submit("sssp", 42)
    engine.run()
    assert q.done
    assert sum(engine.trace_counts.values()) == 1, engine.trace_counts
    assert list(engine.trace_counts) == [(("sssp", ()), 4)]


def test_padded_solo_query_matches_batched(engine):
    """A solo query (padded 1 -> 4 lanes) returns the same answer as the
    same source served inside a full batch."""
    a = engine.submit("sssp", 17)
    engine.run()
    batch = [engine.submit("sssp", s) for s in (3, 17, 60, 2)]
    engine.run()
    np.testing.assert_array_equal(a.result, batch[1].result)


def test_mixed_programs_split_batches(engine):
    """sssp and reach queries never share a lane dispatch; reach is the
    boolean view of the sssp fixed point."""
    d = engine.submit("sssp", 0)
    r = engine.submit("reach", 0)
    engine.run()
    assert r.result.dtype == bool
    np.testing.assert_array_equal(r.result, np.isfinite(d.result))


def test_stream_yields_lanes_as_they_converge(engine, graph):
    """Host-stepped mode: queries complete at their own lane's convergence
    iteration, not the batch's; results match single-source runs."""
    g, n = graph
    qs = [engine.submit("sssp", s) for s in (0, n - 1, 17)]
    got = list(engine.stream())
    assert {q.request_id for q in got} == {q.request_id for q in qs}
    iters = [q.iterations for q in got]
    assert iters == sorted(iters)            # yielded in convergence order
    for q in got:
        es, _ = run_hybrid(g, SSSP(source=q.source), **CPU)
        np.testing.assert_array_equal(q.result,
                                      unpack_vertex(g, es.state["dist"]))


def test_unknown_program_rejected(engine):
    with pytest.raises(KeyError):
        engine.submit("pagerankk", 0)


def test_straggler_redispatch_and_duplicate_suppression(graph):
    """Deadline re-dispatch state machine with a fake clock: attempt 0
    straggles past the deadline, attempt 1's result wins, and a late
    completion of the same work id is suppressed."""
    g, _ = graph
    t = [0.0]
    sentinel = object()
    attempts = []

    def dispatch(eng, key, k, sources, attempt):
        attempts.append(attempt)
        if attempt == 0:
            t[0] = 10.0                      # blow through the deadline
            return None
        return sentinel

    mit = StragglerMitigator(clock=lambda: t[0], min_deadline=1.0)
    eng = ServeEngine(g, straggler=mit, dispatch_fn=dispatch, **CPU)
    out = eng._dispatch_mitigated(("sssp", ()), 4, None)
    assert out is sentinel and attempts == [0, 1]
    assert mit.redispatches == 1
    assert mit.complete(0) is False          # first result already won
    assert mit.duplicates_suppressed == 1


def test_straggler_no_result_before_deadline_raises(graph):
    g, _ = graph
    mit = StragglerMitigator(clock=lambda: 0.0, min_deadline=100.0)
    eng = ServeEngine(g, straggler=mit, dispatch_fn=lambda *a: None, **CPU)
    with pytest.raises(RuntimeError, match="deadline"):
        eng._dispatch_mitigated(("sssp", ()), 4, None)


def test_device_default_is_cuda(graph):
    """Without a GPU the default device raises: no fallback to the
    host."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(graph[0])


def test_ghp_path_builds_onto_the_device(graph, tmp_path):
    """A ``.ghp`` path is built once onto the engine's device and answers
    as the in-memory graph does."""
    edges, n, w = _inputs()
    part = hash_partition(n, 4, seed=0)
    path = str(tmp_path / "g.ghp")
    save_graph(path, edges, n, part, weights=w)
    eng = ServeEngine(path, lane_widths=(4,), **CPU)
    assert eng.graph.device == torch.device("cpu")
    q = eng.submit("sssp", 17)
    eng.run()
    es, _ = run_hybrid(eng.graph, SSSP(source=17), **CPU)
    np.testing.assert_array_equal(q.result,
                                  unpack_vertex(eng.graph, es.state["dist"]))


# ---------------------------------------------------------------------------
# against the reference engine
# ---------------------------------------------------------------------------

# (program, source) of a mixed queue: 3 sssp -> K = 4, 1 reach -> K = 1,
# 5 widest -> K = 4 + K = 1
MIXED = ([("sssp", s) for s in (0, 17, 99)] + [("reach", 60)]
           + [("widest", s) for s in (3, 0, 127, 64, 9)])


def test_mixed_queue_matches_reference(graph, jax_graph):
    """A mixed queue: equal ``trace_counts``, and every sssp / widest /
    reach answer and iteration count bit for bit the reference's."""
    port = ServeEngine(graph[0], lane_widths=(1, 4), **CPU)
    ref = JaxServeEngine(jax_graph[0], lane_widths=(1, 4))
    got = [port.submit(p, s) for p, s in MIXED]
    want = [ref.submit(p, s) for p, s in MIXED]
    port.run()
    ref.run()
    assert port.trace_counts == ref.trace_counts
    assert sorted(port.trace_counts.values()) == [1, 1, 1, 1]
    for q, r in zip(got, want):
        assert q.done and q.iterations == r.iterations, q
        assert q.result.dtype == r.result.dtype
        np.testing.assert_array_equal(q.result, r.result)


def test_ppr_lanes_match_reference_single_lane(web):
    """ppr: each lane of one K = 4 dispatch bit for bit the reference's
    K = 1 dispatch of its seed (see the module docstring)."""
    jg, g, n = web
    seeds = (0, 11, 150, 199)
    port = ServeEngine(g, lane_widths=(4,), **CPU)
    got = [port.submit("ppr", s, tolerance=1e-4) for s in seeds]
    port.run()
    ref = JaxServeEngine(jg, lane_widths=(1,))
    want = [ref.submit("ppr", s, tolerance=1e-4) for s in seeds]
    ref.run()
    for q, r in zip(got, want):
        assert q.result.dtype == np.float32
        np.testing.assert_array_equal(q.result, r.result)
    assert port.trace_counts == {(("ppr", (("tolerance", 1e-4),)), 4): 1}


def test_stream_matches_reference(graph, jax_graph):
    """``stream`` yields in the reference's order, at its iterations, with
    its results; and its lane masks are counted host reads."""
    g, n = graph
    srcs = (0, n - 1, 17, 99)
    port = ServeEngine(g, lane_widths=(4,), **CPU)
    ref = JaxServeEngine(jax_graph[0], lane_widths=(4,))
    for s in srcs:
        port.submit("sssp", s)
        ref.submit("sssp", s)
    reset_host_reads()
    got = list(port.stream())
    assert host_reads() > 0
    want = list(ref.stream())
    assert [(q.source, q.iterations) for q in got] == \
        [(q.source, q.iterations) for q in want]
    for q, r in zip(got, want):
        np.testing.assert_array_equal(q.result, r.result)


@pytest.mark.parametrize("prog", [
    lambda: MultiSourceMonotone(lanes=4, semiring="min_add"),
    lambda: MultiSourceMonotone(lanes=4, semiring="max_min"),
    lambda: PersonalizedPageRank(lanes=4, tolerance=1e-4),
], ids=["min_add", "max_min", "ppr"])
def test_klane_step_writes_no_state_in_place(web, prog):
    """Every state leaf keeps its version (and its values) across hybrid
    K-lane steps: ``stream`` and the lane hook keep ``prev = es.state`` and
    compare it after the step, so an in-place write would make every lane
    look converged."""
    _, g, _ = web
    p = prog()
    vdata = {"sources": torch.tensor([0, 11, 150, 199], dtype=torch.int32)}
    policy = hybrid_policy(collect_metrics=False)
    es = policy.init(g, p, vdata)
    for _ in range(3):
        versions = {k: v._version for k, v in es.state.items()}
        values = {k: v.clone() for k, v in es.state.items()}
        nxt = policy.step(g, p, es, vdata)
        for k, v in es.state.items():
            assert v._version == versions[k], k
            assert torch.equal(v, values[k]), k
        es = nxt


# ---------------------------------------------------------------------------
# K-lane kill-and-resume (executor checkpoint hook)
# ---------------------------------------------------------------------------

class _Killed(RuntimeError):
    pass


def _killer(kill_at):
    def killer(eng, prog, K, iteration):
        if iteration == kill_at:
            raise _Killed(f"injected kill at iteration {iteration}")
    return killer


def test_klane_kill_and_resume_bit_identical(graph, jax_graph, tmp_path):
    """Kill a checkpointed K-lane batch mid-flight, resume it from the
    (program, K, sources-digest) checkpoint family in a fresh engine:
    per-lane results are bit-identical to the uninterrupted run, the
    already-converged lane is recorded as dropped from the restored
    frontier, and the resume event is the reference's."""
    g, n = graph
    srcs = (0, 17, 99, n - 1)       # lane n-1 converges at iteration 1,
    kill_at = 4                     # lanes 0/17 at 5, lane 99 at 7

    ref_eng = ServeEngine(g, lane_widths=(4,), **CPU)
    refs = [ref_eng.submit("sssp", s) for s in srcs]
    ref_eng.run()

    events = {}
    for pkg, make, killed_exc in (
            ("port", lambda **kw: ServeEngine(g, lane_widths=(4,), **CPU,
                                              **kw), _Killed),
            ("ref", lambda **kw: JaxServeEngine(jax_graph[0],
                                                lane_widths=(4,), **kw),
             _Killed)):
        ckdir = str(tmp_path / pkg)
        eng = make(ckpt_dir=ckdir, on_iteration=_killer(kill_at))
        qs = [eng.submit("sssp", s) for s in srcs]
        with pytest.raises(killed_exc):
            eng.run()
        assert not any(q.done for q in qs)
        fams = [f for f in os.listdir(ckdir) if f != STATS_FILENAME]
        assert len(fams) == 1 and fams[0].startswith("sssp_K4_")
        # the kill raised before iteration 4's save: latest durable is 3
        assert any(d.endswith("step_00000003")
                   for d in os.listdir(os.path.join(ckdir, fams[0])))

        eng2 = make(ckpt_dir=ckdir)
        qs2 = [eng2.submit("sssp", s) for s in srcs]
        done = eng2.run()
        assert all(q.done for q in done)
        [ev] = eng2.resume_events
        events[pkg] = dataclasses.replace(
            ev, path=os.path.relpath(ev.path, ckdir))
        for q_ref, q2 in zip(refs, qs2):
            np.testing.assert_array_equal(q_ref.result, q2.result)
        # completed -> its checkpoint family is deleted
        assert [f for f in os.listdir(ckdir) if f != STATS_FILENAME] == []

    ev = events["port"]
    assert ev.program == "sssp" and ev.lanes == 4
    assert ev.iteration == kill_at - 1       # resumed past iteration 0
    assert ev.path.endswith("step_00000003")
    # lane n-1 had converged before the checkpoint -> dropped; others not
    assert ev.lanes_done == (False, False, False, True)
    assert dataclasses.asdict(ev) == dataclasses.asdict(events["ref"])


def test_serving_stats_histograms_persisted(graph, jax_graph, tmp_path):
    """The engine records per-program inter-arrival and batch-size
    histograms and persists the registry beside its checkpoint/cache
    state; the file reads back through ``repro_torch.obs.metrics``, equals
    the reference's under the same fake clock, and loads in either
    package."""
    g, _ = graph
    paths = {}
    for pkg, clock, make in (
            ("port", obs_clock, lambda d: ServeEngine(
                g, lane_widths=(4,), stats_dir=d, **CPU)),
            ("ref", jax_clock, lambda d: JaxServeEngine(
                jax_graph[0], lane_widths=(4,), stats_dir=d))):
        sdir = str(tmp_path / pkg)
        with clock.fake() as fc:
            eng = make(sdir)
            for i, s in enumerate((0, 17, 99)):
                fc.advance(0.25 * (i + 1))
                eng.submit("sssp", s)
            eng.run()
        assert eng.stats_path == os.path.join(sdir, STATS_FILENAME)
        paths[pkg] = eng.stats_path

    reg = load_registry(paths["port"])
    h = reg.histogram("serve.arrival_seconds.sssp")
    assert h.count == 2                      # 3 submits -> 2 gaps
    assert abs(h.sum - 1.25) < 1e-9 and abs(h.max - 0.75) < 1e-9
    b = reg.histogram("serve.batch_size.sssp")
    assert b.count == 1 and b.max == 3.0     # one dispatched batch of 3
    assert reg.value("serve.compiles.sssp.K4") == 1.0

    ref = jax_metrics.load_registry(paths["ref"])
    assert reg.to_dict() == ref.to_dict()
    assert jax_metrics.load_registry(paths["port"]).to_dict() == \
        load_registry(paths["ref"]).to_dict()


def test_klane_resume_requires_monotone(web, tmp_path):
    """Non-monotone (sum-combiner) programs are refused by the shared
    executor gate before any checkpointed dispatch starts, as in the
    reference."""
    jg, g, _ = web
    for eng, exc in ((ServeEngine(g, lane_widths=(4,), **CPU,
                                  ckpt_dir=str(tmp_path / "p")),
                      CheckpointError),
                     (JaxServeEngine(jg, lane_widths=(4,),
                                     ckpt_dir=str(tmp_path / "r")),
                      JaxCheckpointError)):
        eng.submit("ppr", 0)
        with pytest.raises(exc, match="min/max-combiner"):
            eng.run()
