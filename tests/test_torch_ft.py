"""The port's checkpointing and fault tolerance against the reference's.

Mirrors ``test_ft.py`` on the port (``device="cpu"``), and holds the port
against the live reference on the same numpy inputs:

  * checkpoint leaf names, order and dtypes are the reference's
    ``_leaf_path_names`` for SSSP, PageRank and a K-lane program, and a
    checkpoint either package wrote reads in the other;
  * kill-and-resume and injected-kill recovery are bit-identical to the
    uninterrupted run and to the reference's ``run_hybrid_ft`` state
    (counters compared as ints, NaN by position);
  * a checkpoint the reference wrote resumes in the port to the
    reference's final state;
  * the checkpointer, replan / resize / reshard / elastic resume, the
    resize CLI and straggler flags, as in ``test_ft.py``.
"""

import os
import threading

import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint_arrays as jax_load_arrays
from repro.checkpoint.ckpt import _leaf_path_names as jax_leaf_names
from repro.core import build_partitioned_graph as jax_build
from repro.core.apps import SSSP as JaxSSSP
from repro.core.apps import IncrementalPageRank as JaxPageRank
from repro.core.apps import MultiSourceMonotone as JaxMulti
from repro.exec.checkpoint import checkpoint_key as jax_checkpoint_key
from repro.exec.checkpoint import drop_converged_lanes as jax_drop_lanes
from repro.exec.iteration import init_hybrid as jax_init_hybrid
from repro.ft import FaultInjector as JaxFaultInjector
from repro.ft import FaultPlan as JaxFaultPlan
from repro.ft import run_hybrid_ft as jax_run_hybrid_ft
from repro.io.format import load_graph as jax_load_graph
from repro.io.resize import resize_ghp as jax_resize_ghp

from repro_torch.checkpoint import (AsyncCheckpointer, CheckpointError,
                                    latest_checkpoint, load_checkpoint,
                                    load_checkpoint_arrays, save_checkpoint)
from repro_torch.checkpoint import ckpt as ckpt_module
from repro_torch.checkpoint.ckpt import _leaf_path_names
from repro_torch.convert import engine_state_from_checkpoint, to_numpy
from repro_torch.core import run_hybrid
from repro_torch.core.apps import (SSSP, IncrementalPageRank,
                                   MultiSourceMonotone, WidestPath,
                                   pagerank_edge_weights)
from repro_torch.core.graph import _vertex_slots, build_partitioned_graph
from repro_torch.core.graph import unpack_vertex
from repro_torch.data.graphs import grid_graph, rmat_graph
from repro_torch.exec.checkpoint import (checkpoint_key,
                                         drop_converged_lanes, validate_key)
from repro_torch.exec.driver import run_engine
from repro_torch.exec.iteration import init_hybrid
from repro_torch.exec.policy import hybrid_policy
from repro_torch.ft import (FaultInjector, FaultPlan, HeartbeatMonitor,
                            WorkerState, elastic_restore, flag_slow_shards,
                            partition_owners, replan_partitions,
                            reshard_vertex_tree, resize_labels,
                            run_hybrid_ft)
from repro_torch.io import graph_digest
from repro_torch.io.format import load_graph, save_graph
from repro_torch.io.pipeline import build_from_sharded
from repro_torch.io.resize import resize_checkpoint, resize_ghp
from repro_torch.obs import clock as obs_clock
from repro_torch.partition import bfs_partition, hash_partition

from test_torch_io import _assert_same_files

CPU = dict(device="cpu")
PR_TOL = 1e-4


@pytest.fixture(scope="module")
def road():
    edges, w, n = grid_graph(6, 60, seed=3)
    part = bfs_partition(edges, n, 6, seed=1)
    return (build_partitioned_graph(edges, n, part, weights=w, **CPU),
            edges, w, n, part)


@pytest.fixture(scope="module")
def web():
    edges, n = rmat_graph(300, avg_degree=6, seed=7)
    part = hash_partition(n, 6, seed=2)
    w = pagerank_edge_weights(edges, n)
    return build_partitioned_graph(edges, n, part, weights=w, **CPU), \
        edges, w, n, part


@pytest.fixture(scope="module")
def jax_graphs(road, web):
    """The reference's graphs from the same inputs."""
    return {name: jax_build(e, n, p, weights=w)
            for name, (_, e, w, n, p) in (("road", road), ("web", web))}


APPS = {
    # name: (graph fixture, port program, reference program, state field)
    "sssp": ("road", lambda: SSSP(source=0), lambda: JaxSSSP(source=0),
             "dist"),
    "pagerank": ("web", lambda: IncrementalPageRank(tolerance=PR_TOL),
                 lambda: JaxPageRank(tolerance=PR_TOL), "rank"),
}


@pytest.fixture(scope="module")
def reference_runs(jax_graphs):
    """The reference's uninterrupted ``run_hybrid_ft`` of each app."""
    return {app: jax_run_hybrid_ft(jax_graphs[g], make())
            for app, (g, _, make, _) in APPS.items()}


def _port_graph(app, road, web):
    return (road if APPS[app][0] == "road" else web)[0]


def _assert_leaf_equal(got, want, where):
    """Same dtype, shape and bits; floats compare NaN by position only."""
    got, want = np.asarray(got), np.asarray(want)
    assert (got.dtype, got.shape) == (want.dtype, want.shape), where
    if got.dtype.kind == "f":
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan, err_msg=where)
        got, want = got[~nan], want[~nan]
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), where


def assert_counters_equal(a, b):
    """Counters as ints: the port's are int64, the reference's int32."""
    ca, cb = to_numpy(a.counters), to_numpy(b.counters)
    for f in ("iterations", "net_messages", "net_local_messages",
              "mem_messages", "pseudo_supersteps"):
        np.testing.assert_array_equal(np.asarray(ca[f], np.int64),
                                      np.asarray(cb[f], np.int64),
                                      err_msg=f)


def assert_state_equal(got, want):
    """Every leaf but the counters bit for bit (NaN by position), the
    counters as ints — ``want`` may be the reference's state."""
    g, w = to_numpy(got), to_numpy(want)

    def walk(a, b, path):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), path
            for k in b:
                walk(a[k], b[k], f"{path}.{k}")
        elif isinstance(b, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        else:
            _assert_leaf_equal(a, b, path)

    for f in w:
        if f != "counters":
            walk(g[f], w[f], f)
    assert_counters_equal(got, want)


def run_to_fixed_point(graph, prog, es):
    return run_engine(graph, prog, hybrid_policy(), es=es).es


# ---------------------------------------------------------------------------
# leaf names, keys and the on-disk format, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("app", ["sssp", "pagerank", "multi"])
def test_leaf_names_match_reference(app, road, web, jax_graphs):
    if app == "multi":
        graph, jgraph = road[0], jax_graphs["road"]
        prog, vdata = MultiSourceMonotone(lanes=3, semiring="min_add"), \
            {"sources": torch.tensor([0, 7, 19])}
        jprog, jvdata = JaxMulti(lanes=3, semiring="min_add"), \
            {"sources": np.array([0, 7, 19])}
    else:
        gname, make, make_jax, _ = APPS[app]
        graph, jgraph = _port_graph(app, road, web), jax_graphs[gname]
        prog, jprog, vdata, jvdata = make(), make_jax(), None, None
    es = init_hybrid(graph, prog, vdata)
    jes = jax_init_hybrid(jgraph, jprog, jvdata)
    names = _leaf_path_names(es)
    assert names == jax_leaf_names(jes)
    assert ".pending/" + prog.channels[0].name + "/0/0" in names
    assert checkpoint_key(graph, prog, vdata) == \
        jax_checkpoint_key(jgraph, jprog, jvdata)


def test_checkpoints_read_across_packages(tmp_path, road, jax_graphs):
    """A port checkpoint reads in the reference with the reference's names
    and dtypes (counters int64 for int32), and a reference checkpoint
    reads here."""
    graph = road[0]
    run_hybrid_ft(graph, SSSP(source=0), ckpt_dir=str(tmp_path / "port"),
                  max_iters=2, **CPU)
    jax_run_hybrid_ft(jax_graphs["road"], JaxSSSP(source=0),
                      ckpt_dir=str(tmp_path / "ref"), max_iters=2)
    port = latest_checkpoint(str(tmp_path / "port"))
    ref = latest_checkpoint(str(tmp_path / "ref"))
    a, ma = jax_load_arrays(port)
    b, mb = load_checkpoint_arrays(ref)
    assert list(a) == list(b) and ma["step"] == mb["step"] == 2
    assert {k: ma["meta"][k] for k in ("graph_digest", "program")} == \
        {k: mb["meta"][k] for k in ("graph_digest", "program")}
    for name in a:
        if name.startswith(".counters/"):
            assert (a[name].dtype, b[name].dtype) == (np.int64, np.int32)
            np.testing.assert_array_equal(a[name], b[name])
        else:
            _assert_leaf_equal(a[name], b[name], name)


@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_reference_checkpoint_resumes_in_port(tmp_path, app, road, web,
                                              jax_graphs, reference_runs):
    """The reference runs k iterations and checkpoints; the port picks the
    checkpoint up (counters widened to int64) and runs on to the
    reference's uninterrupted final state."""
    gname, make, make_jax, _ = APPS[app]
    graph = _port_graph(app, road, web)
    d = str(tmp_path / "ck")
    k = 2 if app == "sssp" else 3
    jax_run_hybrid_ft(jax_graphs[gname], make_jax(), ckpt_dir=d,
                      max_iters=k)
    es, step = engine_state_from_checkpoint(
        d, init_hybrid(graph, make(), None), **CPU)
    assert step == k and es.counters.iterations.dtype == torch.int64
    validate_key(load_checkpoint_arrays(latest_checkpoint(d))[1]["meta"],
                 checkpoint_key(graph, make()), d)
    es = run_to_fixed_point(graph, make(), es)
    assert_state_equal(es, reference_runs[app].es)


def test_engine_state_from_checkpoint_refuses_other_trees(tmp_path, road,
                                                         web):
    like = init_hybrid(road[0], SSSP(source=0), None)
    save_checkpoint(str(tmp_path / "c"), {"w": torch.ones(3)}, step=1,
                    codec="raw")
    with pytest.raises(CheckpointError, match="EngineState"):
        engine_state_from_checkpoint(str(tmp_path / "c"), like, **CPU)
    with pytest.raises(CheckpointError, match="no complete checkpoint"):
        engine_state_from_checkpoint(str(tmp_path / "none"), like, **CPU)
    # the same leaf names at another graph's shapes
    save_checkpoint(str(tmp_path / "w"), like, step=1, codec="raw")
    with pytest.raises(CheckpointError, match="EngineState template wants"):
        engine_state_from_checkpoint(
            str(tmp_path / "w"),
            init_hybrid(web[0], SSSP(source=0), None), **CPU)


def test_drop_converged_lanes_matches_reference(road, jax_graphs):
    graph = road[0]
    prog = MultiSourceMonotone(lanes=3, semiring="min_add")
    jprog = JaxMulti(lanes=3, semiring="min_add")
    src = np.array([0, 7, 19])
    es = init_hybrid(graph, prog, {"sources": torch.from_numpy(src)})
    jes = jax_init_hybrid(jax_graphs["road"], jprog, {"sources": src})
    done = np.array([True, False, True])
    assert_state_equal(drop_converged_lanes(prog, es, torch.from_numpy(done)),
                       jax_drop_lanes(jprog, jes, done))


# ---------------------------------------------------------------------------
# exact resume
# ---------------------------------------------------------------------------

def test_ft_driver_matches_run_hybrid(road, reference_runs):
    graph = road[0]
    res = run_hybrid_ft(graph, SSSP(source=0), **CPU)
    es_ref, it_ref = run_hybrid(graph, SSSP(source=0), **CPU)
    assert res.iterations == it_ref == reference_runs["sssp"].iterations
    assert_state_equal(res.es, es_ref)
    assert_state_equal(res.es, reference_runs["sssp"].es)
    assert res.recoveries == [] and res.resumed_from is None


@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_kill_and_resume_bit_identical(tmp_path, app, road, web,
                                       reference_runs):
    """Interrupt after iteration k, restart: final state AND every paper
    counter bit-identical to the uninterrupted run — the port's own and
    the reference's."""
    _, make, _, _ = APPS[app]
    graph = _port_graph(app, road, web)
    kill_after = 2 if app == "sssp" else 3
    ref = run_hybrid_ft(graph, make(), **CPU)
    d = str(tmp_path / "ck")
    r1 = run_hybrid_ft(graph, make(), ckpt_dir=d, max_iters=kill_after,
                       **CPU)
    assert r1.iterations == kill_after < ref.iterations
    r2 = run_hybrid_ft(graph, make(), ckpt_dir=d, **CPU)
    assert r2.resumed_from is not None and \
        r2.resumed_from.endswith(f"step_{kill_after:08d}")
    assert r2.iterations == ref.iterations == \
        reference_runs[app].iterations
    assert_state_equal(r2.es, ref.es)
    assert_state_equal(r2.es, reference_runs[app].es)


def test_resume_refuses_other_graph_or_program(tmp_path, road, web):
    d = str(tmp_path / "ck")
    run_hybrid_ft(road[0], SSSP(source=0), ckpt_dir=d, max_iters=2, **CPU)
    with pytest.raises(CheckpointError, match="program"):
        run_hybrid_ft(road[0], IncrementalPageRank(tolerance=PR_TOL),
                      ckpt_dir=d, **CPU)
    with pytest.raises(CheckpointError, match="graph_digest"):
        run_hybrid_ft(web[0], SSSP(source=0), ckpt_dir=d, **CPU)


def test_checkpoint_every_spaces_snapshots(tmp_path, road):
    d = str(tmp_path / "ck")
    run_hybrid_ft(road[0], SSSP(source=0), ckpt_dir=d, max_iters=5,
                  checkpoint_every=2, keep=10, **CPU)
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000004"]


def test_ft_device_checks(road):
    graph = road[0]
    with pytest.raises(ValueError, match="graph lives on"):
        run_hybrid_ft(graph, SSSP(source=0), device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_hybrid_ft(graph, SSSP(source=0))


# ---------------------------------------------------------------------------
# fault injection -> recovery loop
# ---------------------------------------------------------------------------

def test_injected_kill_triggers_recovery(tmp_path, road, jax_graphs,
                                         reference_runs):
    graph = road[0]
    inj = FaultInjector(FaultPlan.kill_at(3, worker=1), n_workers=4)
    res = run_hybrid_ft(graph, SSSP(source=0), ckpt_dir=str(tmp_path / "c"),
                        n_workers=4, injector=inj, **CPU)
    assert len(res.recoveries) == 1
    ev = res.recoveries[0]
    assert ev.failed_workers == (1,)
    assert ev.bytes_read > 0 and ev.restore_seconds > 0
    assert ev.iterations_lost == 0            # checkpoint_every=1
    assert ev.moved                           # partitions were reassigned
    assert res.epoch == 1                     # one reassignment event
    assert_state_equal(res.es, reference_runs["sssp"].es)
    # the reference's recovery under the same plan: same events and state
    jres = jax_run_hybrid_ft(
        jax_graphs["road"], JaxSSSP(source=0), ckpt_dir=str(tmp_path / "j"),
        n_workers=4,
        injector=JaxFaultInjector(JaxFaultPlan.kill_at(3, worker=1), 4))
    (jev,) = jres.recoveries
    assert (ev.tick, ev.failed_workers, ev.moved, ev.restored_iteration,
            ev.iterations_lost) == (jev.tick, jev.failed_workers, jev.moved,
                                    jev.restored_iteration,
                                    jev.iterations_lost)
    assert_state_equal(res.es, jres.es)


def test_injected_kill_is_deterministic(tmp_path, road):
    graph = road[0]
    runs = []
    for i in range(2):
        inj = FaultInjector(FaultPlan.kill_at(4, worker=0), n_workers=3)
        runs.append(run_hybrid_ft(graph, SSSP(source=0),
                                  ckpt_dir=str(tmp_path / f"c{i}"),
                                  n_workers=3, injector=inj, **CPU))
    a, b = runs
    assert [e.tick for e in a.recoveries] == [e.tick for e in b.recoveries]
    assert [e.restored_iteration for e in a.recoveries] == \
        [e.restored_iteration for e in b.recoveries]
    assert a.iterations == b.iterations
    assert_state_equal(a.es, b.es)


@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_recovery_iterations_lost_with_sparse_checkpoints(tmp_path, app,
                                                          road, web,
                                                          reference_runs):
    """checkpoint_every=3 and a kill past the snapshot roll back to it:
    the recovery event owns the lost work, and the rerun work lands on
    the uninterrupted state exactly (a sum channel included)."""
    _, make, _, _ = APPS[app]
    graph = _port_graph(app, road, web)
    inj = FaultInjector(FaultPlan.kill_at(2, worker=0), n_workers=2)
    res = run_hybrid_ft(graph, make(), ckpt_dir=str(tmp_path / "c"),
                        checkpoint_every=3, n_workers=2, injector=inj, **CPU)
    (ev,) = res.recoveries
    assert ev.restored_iteration % 3 == 0
    assert ev.iterations_lost == ev.tick - 1 - ev.restored_iteration
    assert_state_equal(res.es, reference_runs[app].es)


def test_delay_recovers_without_failover(road):
    graph = road[0]
    inj = FaultInjector(FaultPlan(delay={2: (1, 1)}), n_workers=3)
    res = run_hybrid_ft(graph, SSSP(source=0), n_workers=3, injector=inj,
                        **CPU)
    assert res.recoveries == [] and res.epoch == 0


def test_injector_requires_monotonic_ticks():
    inj = FaultInjector(FaultPlan(), n_workers=2)
    assert list(inj.beating(1)) == [0, 1]
    with pytest.raises(ValueError):
        inj.beating(1)


# ---------------------------------------------------------------------------
# heartbeat state machine (injected clock)
# ---------------------------------------------------------------------------

def test_heartbeat_suspect_heals_on_beat():
    t = [0.0]
    mon = HeartbeatMonitor(2, suspect_after=1.0, fail_after=3.0,
                           clock=lambda: t[0])
    t[0] = 2.0
    mon.beat(0)
    assert mon.sweep() == []
    assert mon.workers[1].state is WorkerState.SUSPECT
    mon.beat(1)
    assert mon.workers[1].state is WorkerState.HEALTHY
    t[0] = 2.5
    assert mon.sweep() == []
    assert mon.workers[1].state is WorkerState.HEALTHY


def test_heartbeat_epoch_bumps_once_per_event():
    t = [0.0]
    mon = HeartbeatMonitor(4, suspect_after=1.0, fail_after=2.0,
                           clock=lambda: t[0])
    for p in range(8):
        mon.assign(p % 4, p)
    t[0] = 3.0
    mon.beat(3)
    assert sorted(mon.sweep()) == [0, 1, 2]
    moved = mon.reassign_failed()
    assert mon.epoch == 1
    assert sorted(i for items in moved.values() for i in items) == \
        [0, 1, 2, 4, 5, 6]
    assert mon.reassign_failed() == {}
    assert mon.epoch == 1


def test_heartbeat_no_healthy_workers_raises():
    t = [0.0]
    mon = HeartbeatMonitor(2, suspect_after=1.0, fail_after=2.0,
                           clock=lambda: t[0])
    mon.assign(0, "a")
    t[0] = 5.0
    assert sorted(mon.sweep()) == [0, 1]
    with pytest.raises(RuntimeError, match="no healthy workers"):
        mon.reassign_failed()


def test_heartbeat_reads_the_installed_clock():
    with obs_clock.fake() as fc:
        mon = HeartbeatMonitor(4)
        fc.advance(30.0)
        assert mon.sweep() == [0, 1, 2, 3]
    assert obs_clock.monotonic() != fc.t


# ---------------------------------------------------------------------------
# checkpoint layer (raw codec — runs without zstandard)
# ---------------------------------------------------------------------------

def test_checkpoint_raw_codec_roundtrip(tmp_path):
    # keys out of order: leaves are named and stored in sorted key order
    state = {"c": (np.arange(3, dtype=np.int32), torch.zeros(2)),
             "a": torch.arange(12.0).reshape(3, 4),
             "b": torch.ones((5,), dtype=torch.bool)}
    save_checkpoint(str(tmp_path / "c"), state, step=4, codec="raw")
    restored, step = load_checkpoint(str(tmp_path / "c"), state)
    assert step == 4
    assert torch.equal(restored["a"], state["a"])
    assert torch.equal(restored["b"], state["b"])
    assert isinstance(restored["c"], tuple) and list(restored) == list(state)
    np.testing.assert_array_equal(restored["c"][0], state["c"][0])
    assert torch.equal(restored["c"][1], state["c"][1])
    restored["a"].add_(1.0)                   # owns its memory
    arrs, manifest = load_checkpoint_arrays(str(tmp_path / "c"))
    assert manifest["codec"] == "raw"
    assert list(arrs) == ["a", "b", "c/0", "c/1"]
    assert [r["dtype"] for r in manifest["leaves"]] == \
        ["float32", "bool", "int32", "float32"]


def test_load_checkpoint_validates_tree(tmp_path):
    state = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}
    save_checkpoint(str(tmp_path / "c"), state, step=0, codec="raw")
    with pytest.raises(CheckpointError, match="leaves"):
        load_checkpoint(str(tmp_path / "c"), {"w": torch.ones((4, 4))})
    with pytest.raises(CheckpointError, match="manifest"):
        load_checkpoint(str(tmp_path / "c"),
                        {"w": torch.ones((4, 4)), "x": torch.zeros((4,))})
    with pytest.raises(CheckpointError, match="on disk"):
        load_checkpoint(str(tmp_path / "c"),
                        {"w": torch.ones((4, 4)), "b": torch.zeros((5,))})
    with pytest.raises(CheckpointError, match="on disk"):
        load_checkpoint(str(tmp_path / "c"),
                        {"w": torch.ones((4, 4)),
                         "b": torch.zeros((4,), dtype=torch.int32)})


def test_checkpoint_detects_corrupt_blob(tmp_path):
    save_checkpoint(str(tmp_path / "c"), {"x": torch.ones(3)}, step=1,
                    codec="raw")
    with open(str(tmp_path / "c" / "leaf_00000.npy"), "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(b"\xff\xff\xff\xff")
    with pytest.raises(CheckpointError, match="corruption"):
        load_checkpoint_arrays(str(tmp_path / "c"))
    with pytest.raises(CheckpointError, match="unknown checkpoint codec"):
        AsyncCheckpointer(str(tmp_path / "d"), codec="lz9")


def test_latest_checkpoint_skips_torn_directory(tmp_path):
    base = tmp_path / "ck"
    for s in (1, 2):
        save_checkpoint(str(base / f"step_{s:08d}"), {"x": torch.ones(3)},
                        step=s, codec="raw")
    (base / "step_00000003").mkdir()
    (base / "step_00000003" / "leaf_00000.npy").write_bytes(b"junk")
    got = latest_checkpoint(str(base))
    assert got is not None and got.endswith("step_00000002")


def test_async_checkpointer_surfaces_worker_error(tmp_path):
    target = tmp_path / "ck"
    target.write_text("not a directory")
    ck = AsyncCheckpointer(str(target), codec="raw")
    ck.save(1, {"x": torch.ones(3)})
    with pytest.raises(OSError):
        ck.wait()
    ck.close()
    assert not ck.t.is_alive()


def test_async_checkpointer_gc_and_flush(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path / "ck"), keep=2, codec="raw")
    for s in range(1, 6):
        ck.save(s, {"x": torch.full((4,), float(s))})
    ck.wait()
    assert ck.bytes_written > 0 and ck.save_seconds > 0
    assert ck.write_seconds > 0 and ck.written == 5
    dirs = sorted(os.listdir(tmp_path / "ck"))
    assert dirs == ["step_00000004", "step_00000005"]
    arrs, _ = load_checkpoint_arrays(str(tmp_path / "ck" / dirs[-1]))
    np.testing.assert_array_equal(arrs["x"], np.full((4,), 5.0, np.float32))
    ck.close()
    assert not ck.t.is_alive()


def test_async_checkpointer_snapshots_cpu_leaves(tmp_path, monkeypatch):
    """``save`` copies a CPU tensor (or numpy array) before it returns: an
    in-place update after the call, made while the writer is held back,
    does not reach the written bytes."""
    go, write = threading.Event(), ckpt_module._write
    monkeypatch.setattr(ckpt_module, "_write",
                        lambda *a: (go.wait(10), write(*a)))
    t, a = torch.zeros(1 << 16), np.zeros(8, np.int32)
    ck = AsyncCheckpointer(str(tmp_path / "ck"), codec="raw")
    ck.save(1, {"t": t, "a": a})
    t.fill_(7.0)
    a.fill(7)
    go.set()
    ck.wait()
    ck.close()
    arrs, _ = load_checkpoint_arrays(str(tmp_path / "ck" / "step_00000001"))
    assert not arrs["t"].any() and not arrs["a"].any()


# ---------------------------------------------------------------------------
# elastic replan / relabel / reshard
# ---------------------------------------------------------------------------

def test_replan_grow_shrink_noop():
    grow = replan_partitions(256, 6, 8)
    shrink = replan_partitions(256, 8, 6)
    noop = replan_partitions(256, 8, 8)
    for plan, w in ((grow, 8), (shrink, 6)):
        assert plan.owner.max() == w - 1
        counts = np.bincount(plan.owner)
        assert counts.max() - counts.min() <= 1
    assert noop.moved == 0
    assert grow.moved == int(np.sum(partition_owners(256, 6)
                                    != partition_owners(256, 8)))
    assert shrink.moved == grow.moved > 0


def test_resize_labels_grow_splits_shrink_merges():
    part = np.repeat(np.arange(4), 10).astype(np.int32)
    up = resize_labels(part, 8)
    assert sorted(np.unique(up)) == list(range(8))
    assert len(np.unique(np.stack([part, up], 1), axis=0)) == 8
    down = resize_labels(part, 2)
    np.testing.assert_array_equal(down, part * 2 // 4)
    np.testing.assert_array_equal(resize_labels(part, 4), part)
    with pytest.raises(ValueError):
        resize_labels(part, 0)


def test_reshard_vertex_tree_roundtrip():
    rng = np.random.RandomState(0)
    n = 100
    old = np.repeat(np.arange(4), 25).astype(np.int32)
    new = resize_labels(old, 7)
    _, _, slot_o, Vp_o = _vertex_slots(old, n, 8)
    val = np.full((4, Vp_o), -1.0, np.float64)
    val[old, slot_o] = rng.rand(n)
    leaves = {"v": val, "scalar": np.float64(3.0),
              "other": np.ones((4, 3))}
    out = reshard_vertex_tree(leaves, old, new, pad_multiple=8)
    _, _, slot_n, Vp_n = _vertex_slots(new, n, 8)
    np.testing.assert_array_equal(out["v"][new, slot_n], val[old, slot_o])
    assert out["scalar"] == 3.0
    np.testing.assert_array_equal(out["other"], leaves["other"])
    back = reshard_vertex_tree({"v": out["v"]}, new, old, pad_multiple=8)
    np.testing.assert_array_equal(back["v"][old, slot_o], val[old, slot_o])


# ---------------------------------------------------------------------------
# .ghp resize + elastic resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kp", [12, 3])
def test_resize_ghp_builds_bit_identical(tmp_path, road, kp):
    _, edges, w, n, part = road
    src = str(tmp_path / "g.ghp")
    save_graph(src, edges, n, part, weights=w, positions=True)
    sg = resize_ghp(src, str(tmp_path / "g2.ghp"), kp)
    newpart = resize_labels(part, kp)
    np.testing.assert_array_equal(sg.part, newpart)
    assert graph_digest(build_from_sharded(sg, **CPU)) == graph_digest(
        build_partitioned_graph(edges, n, newpart, weights=w, **CPU))
    # the reference's resize of the same directory writes the same bytes
    jax_resize_ghp(src, str(tmp_path / "j2.ghp"), kp)
    _assert_same_files(str(tmp_path / "g2.ghp"), str(tmp_path / "j2.ghp"))
    assert jax_load_graph(str(tmp_path / "g2.ghp")).n_partitions == kp


@pytest.mark.parametrize("kp", [9, 4])
def test_elastic_resume_reaches_same_fixed_point(tmp_path, road, kp):
    graph, edges, w, n, part = road
    ref = run_hybrid_ft(graph, SSSP(source=0), **CPU)
    d = str(tmp_path / "ck")
    run_hybrid_ft(graph, SSSP(source=0), ckpt_dir=d, max_iters=3, **CPU)
    newpart = resize_labels(part, kp)
    g2 = build_partitioned_graph(edges, n, newpart, weights=w, **CPU)
    es, it = elastic_restore(os.path.join(d, "step_00000003"), g2,
                             SSSP(source=0), None, part, newpart, **CPU)
    assert it == 3
    es = run_to_fixed_point(g2, SSSP(source=0), es)
    np.testing.assert_array_equal(unpack_vertex(g2, es.state["dist"]),
                                  unpack_vertex(graph, ref.es.state["dist"]))


def test_elastic_resume_rejects_sum_channels(tmp_path, road):
    graph, edges, w, n, part = road
    d = str(tmp_path / "ck")
    run_hybrid_ft(graph, SSSP(source=0), ckpt_dir=d, max_iters=2, **CPU)
    newpart = resize_labels(part, 4)
    g2 = build_partitioned_graph(edges, n, newpart, weights=w, **CPU)
    with pytest.raises(CheckpointError, match="monotone"):
        elastic_restore(os.path.join(d, "step_00000002"), g2,
                        IncrementalPageRank(tolerance=PR_TOL), None, part,
                        newpart, **CPU)


def test_elastic_resume_widest_path_on_a_resized_ghp(tmp_path, web):
    """The path the card's ft phase drives: WidestPath (max_min) on a
    weighted R-MAT, ``resize_ghp`` + ``resize_checkpoint`` from 6 to 4
    partitions, elastic restore, the uninterrupted fixed point."""
    _, edges, _, n, part = web
    w = np.random.default_rng(3).uniform(0.5, 8.0, len(edges)) \
        .astype(np.float32)
    graph = build_partitioned_graph(edges, n, part, weights=w,
                                    ell_base_slices=8, **CPU)
    prog = lambda: WidestPath(source=int(edges[0, 0]))     # noqa: E731
    ref = run_hybrid_ft(graph, prog(), **CPU)
    d = str(tmp_path / "ck")
    run_hybrid_ft(graph, prog(), ckpt_dir=d, max_iters=2, **CPU)
    src, dst = str(tmp_path / "g.ghp"), str(tmp_path / "g4.ghp")
    save_graph(src, edges, n, part, weights=w, positions=True)
    sg = resize_ghp(src, dst, 4)
    g4 = build_from_sharded(sg, ell_base_slices=8, **CPU)
    ck = resize_checkpoint(d, str(tmp_path / "ck4"), part, sg.part,
                           graph_digest(g4))
    es, it = elastic_restore(ck, g4, prog(), None, part, sg.part,
                             expect_digest=graph_digest(g4), **CPU)
    assert it == 2
    es = run_to_fixed_point(g4, prog(), es)
    np.testing.assert_array_equal(unpack_vertex(g4, es.state["cap"]),
                                  unpack_vertex(graph, ref.es.state["cap"]))


def test_resize_cli_reshards_and_rekeys_checkpoint(tmp_path, road):
    from repro_torch.io.resize import main as resize_main
    graph, edges, w, n, part = road
    src, dst = str(tmp_path / "g.ghp"), str(tmp_path / "g12.ghp")
    save_graph(src, edges, n, part, weights=w, positions=True)
    ckd, ck2 = str(tmp_path / "ck"), str(tmp_path / "ck12")
    run_hybrid_ft(graph, SSSP(source=0), ckpt_dir=ckd, max_iters=3, **CPU)
    assert resize_main([src, dst, "-k", "12", "--checkpoint", ckd,
                        "--checkpoint-out", ck2, "--device", "cpu"]) == 0
    g12 = build_from_sharded(load_graph(dst), **CPU)
    es, it = elastic_restore(os.path.join(ck2, "step_00000003"), g12,
                             SSSP(source=0), None, part,
                             load_graph(dst).part,
                             expect_digest=graph_digest(g12), **CPU)
    assert it == 3
    es = run_to_fixed_point(g12, SSSP(source=0), es)
    ref = run_hybrid_ft(graph, SSSP(source=0), **CPU)
    np.testing.assert_array_equal(unpack_vertex(g12, es.state["dist"]),
                                  unpack_vertex(graph, ref.es.state["dist"]))
    with pytest.raises(CheckpointError, match="already elastic"):
        resize_checkpoint(ck2, str(tmp_path / "ck3"), part,
                          load_graph(dst).part, "x")
    with pytest.raises(CheckpointError, match="graph_digest"):
        elastic_restore(os.path.join(ck2, "step_00000003"), g12,
                        SSSP(source=0), None, part, load_graph(dst).part,
                        expect_digest="x", **CPU)


# ---------------------------------------------------------------------------
# stragglers
# ---------------------------------------------------------------------------

def test_flag_slow_shards():
    counts = np.array([4, 5, 4, 16, 5, 4])
    flags = flag_slow_shards(counts, factor=1.5)
    assert [f.partition for f in flags] == [3]
    assert flags[0].cause == "straggler" and flags[0].ratio > 3
    skew = flag_slow_shards(counts, balance=2.0, factor=1.5)
    assert skew[0].cause == "skew"
    assert flag_slow_shards(np.array([3, 3, 3])) == []
    assert flag_slow_shards(np.zeros(0)) == []


def test_driver_surfaces_straggler_flags(road):
    res = run_hybrid_ft(road[0], SSSP(source=0), straggler_factor=0.01,
                        **CPU)
    assert res.straggler_flags
    assert all(f.pseudo_supersteps > 0 for f in res.straggler_flags)


@pytest.mark.gpu
@pytest.mark.parametrize("app", ["sssp", "pagerank"])
def test_cuda_kill_and_resume_equals_cpu(tmp_path, app, road, web):
    """On the card: a killed and resumed run equals the host's
    uninterrupted run bit for bit, counters included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    _, make, _, _ = APPS[app]
    cpu_graph = _port_graph(app, road, web)
    _, edges, w, n, part = road if APPS[app][0] == "road" else web
    graph = build_partitioned_graph(edges, n, part, weights=w)
    d = str(tmp_path / "ck")
    run_hybrid_ft(graph, make(), ckpt_dir=d, max_iters=2)
    res = run_hybrid_ft(graph, make(), ckpt_dir=d)
    assert res.resumed_from is not None
    assert_state_equal(res.es, run_hybrid_ft(cpu_graph, make(), **CPU).es)

