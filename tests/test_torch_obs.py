"""The port's observability against the reference's.

Mirrors ``test_obs.py`` case by case on the port (``device="cpu"``), and
holds it against the live reference on the same graphs (built by the
reference, carried to the port through ``repro_torch.convert``):

  * ``TraceHook`` spans: the same iterations, exchange bytes and counter
    deltas per superstep, and run state and counters untouched;
  * ``phased_run`` records equal to the reference's apart from the
    seconds, the final state and counters equal to ``run_bsp`` /
    ``run_hybrid``;
  * the registry JSON equal, and loadable in either package;
  * ``run_report`` barriers and exchange bytes equal to
    ``repro.obs.report.run_report``'s;
  * ``run_hybrid_ft``'s recovery span and registry as the reference's;
  * the disabled tracer adds zero hooks and zero counted host reads, and
    the engines never import the tracing module.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.core import build_partitioned_graph as jax_build
from repro.core.apps import SSSP as JaxSSSP
from repro.core.apps import IncrementalPageRank as JaxPageRank
from repro.exec.driver import run_engine as jax_run_engine
from repro.exec.policy import make_policy as jax_make_policy
from repro.ft import FaultInjector as JaxFaultInjector
from repro.ft import FaultPlan as JaxFaultPlan
from repro.ft import run_hybrid_ft as jax_run_hybrid_ft
from repro.obs import metrics as jax_metrics
from repro.obs import report as jax_report
from repro.obs import trace as jax_trace

from repro_torch.convert import graph_from_numpy, to_numpy
from repro_torch.core import run_bsp, run_hybrid
from repro_torch.core.apps import (SSSP, IncrementalPageRank,
                                   pagerank_edge_weights)
from repro_torch.data.graphs import grid_graph, rmat_graph
from repro_torch.exec.driver import run_engine
from repro_torch.exec.policy import make_policy
from repro_torch.exec.syncs import host_reads, reset_host_reads
from repro_torch.ft import (FaultInjector, FaultPlan, HeartbeatMonitor,
                            StragglerMitigator, flag_slow_shards,
                            run_hybrid_ft)
from repro_torch.obs import clock as obs_clock
from repro_torch.obs import report
from repro_torch.obs.export import (chrome_trace, profile_blob,
                                    write_chrome_trace)
from repro_torch.obs.metrics import (MetricsRegistry, load_registry,
                                     record_engine_counters, save_registry)
from repro_torch.obs.trace import (RunTraceHook, TraceHook, Tracer,
                                   exchange_bytes,
                                   exchange_bytes_per_partition,
                                   phased_run, trace_hooks, wrap_hooks)
from repro_torch.partition import bfs_partition, hash_partition

CPU = dict(device="cpu")
DELTAS = ("net_messages", "net_local_messages", "mem_messages",
          "pseudo_supersteps")


@pytest.fixture(scope="module")
def jax_graphs():
    """The reference's graphs of ``test_obs.py``: a road grid (SSSP) and an
    R-MAT web graph with PageRank weights."""
    edges, w, n = grid_graph(6, 40, seed=3)
    road = jax_build(edges, n, bfs_partition(edges, n, 4, seed=1), weights=w)
    edges, n = rmat_graph(200, avg_degree=5, seed=7)
    web = jax_build(edges, n, hash_partition(n, 4, seed=2),
                    weights=pagerank_edge_weights(edges, n))
    return {"road": road, "web": web}


@pytest.fixture(scope="module")
def road(jax_graphs):
    return graph_from_numpy(to_numpy(jax_graphs["road"]), **CPU)


@pytest.fixture(scope="module")
def web(jax_graphs):
    return graph_from_numpy(to_numpy(jax_graphs["web"]), **CPU)


def assert_counters_equal(a, b):
    for f in ("iterations", "net_messages", "net_local_messages",
              "mem_messages"):
        assert int(getattr(a.counters, f)) == int(getattr(b.counters, f)), f
    np.testing.assert_array_equal(np.asarray(a.counters.pseudo_supersteps),
                                  np.asarray(b.counters.pseudo_supersteps))


def _span_args(tracer, cat="superstep"):
    return [{k: s.args[k] for k in ("iteration", "exchange_bytes",
                                    "barriers", *DELTAS)}
            for s in tracer.spans if s.cat == cat]


# ---------------------------------------------------------------------------
# clock
# ---------------------------------------------------------------------------

def test_fake_clock_drives_heartbeat_without_explicit_param():
    with obs_clock.fake() as fc:
        mon = HeartbeatMonitor(3, suspect_after=5.0, fail_after=15.0)
        fc.advance(6.0)
        mon.beat(0)
        assert mon.sweep() == []          # suspect only, nobody failed
        fc.advance(10.0)
        assert sorted(mon.sweep()) == [1, 2]
    assert obs_clock._monotonic is not fc    # backend restored on exit


def test_fake_clock_drives_straggler_deadline():
    with obs_clock.fake() as fc:
        mit = StragglerMitigator(min_deadline=1.0)
        mit.issue(7, replica=0)
        fc.advance(10.0)
        assert [w.work_id for w in mit.overdue()] == [7]
        assert mit.redispatches == 1


def test_fake_clock_drives_checkpoint_save_billing(road, tmp_path):
    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.exec.iteration import init_hybrid

    es = init_hybrid(road, SSSP(source=0), None)
    with obs_clock.fake() as fc:
        ck = AsyncCheckpointer(str(tmp_path / "c"), keep=2)
        assert obs_clock._perf_counter is fc
        ck.save(1, es)
        ck.wait()
        ck.close()
        # the fake clock never advanced, so the billed snapshot time is 0
        assert ck.save_seconds == 0.0


def test_clock_install_returns_previous():
    prev = obs_clock.install(lambda: 42.0)
    try:
        assert obs_clock.monotonic() == 42.0
    finally:
        obs_clock.install(*prev)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def _filled_registry(pkg):
    reg = pkg.MetricsRegistry()
    reg.inc("a.count", 3, unit="msgs")
    reg.set_gauge("a.vec", [1, 2, 3])
    reg.set_gauge("a.scalar", 2.5, unit="s")
    for v in (0.001, 0.5, 10.0, 2000.0):
        reg.observe("a.hist", v, unit="s")
    return reg


def test_registry_round_trip(tmp_path):
    import repro_torch.obs.metrics as port_metrics

    reg = _filled_registry(port_metrics)
    path = str(tmp_path / "m.json")
    save_registry(reg, path)
    back = load_registry(path)
    assert back.names() == reg.names()
    assert back.value("a.count") == 3.0
    assert back.value("a.vec") == [1.0, 2.0, 3.0]
    h = back.histogram("a.hist")
    assert h.count == 4 and h.min == 0.001 and h.max == 2000.0
    assert abs(h.mean - (0.001 + 0.5 + 10.0 + 2000.0) / 4) < 1e-9
    assert sum(h.counts) == 4


def test_registry_json_cross_loads(tmp_path):
    """The same writes give the same JSON in both packages, and a file
    either one saved loads in the other."""
    import repro_torch.obs.metrics as port_metrics

    port, ref = (_filled_registry(m) for m in (port_metrics, jax_metrics))
    pp, rp = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    save_registry(port, pp)
    jax_metrics.save_registry(ref, rp)
    with open(pp) as f, open(rp) as g:
        assert f.read() == g.read()
    assert jax_metrics.load_registry(pp).to_dict() == port.to_dict()
    assert load_registry(rp).to_dict() == ref.to_dict()


def test_registry_kind_collision_and_negative_inc():
    reg = MetricsRegistry()
    reg.inc("x")
    with pytest.raises(ValueError, match="counter"):
        reg.set_gauge("x", 1.0)
    with pytest.raises(ValueError, match="negative"):
        reg.inc("x", -1)


def test_record_engine_counters(road, jax_graphs):
    """The port's device counters land in the registry as the reference's
    do: the same JSON for the same run."""
    es, _ = run_hybrid(road, SSSP(source=0), **CPU)
    reg = MetricsRegistry()
    record_engine_counters(reg, es.counters)
    assert reg.value("engine.iterations") == float(es.counters.iterations)
    vec = reg.value("engine.pseudo_supersteps")
    assert len(vec) == road.n_partitions
    np.testing.assert_array_equal(
        np.asarray(vec), es.counters.pseudo_supersteps.numpy().astype(float))

    from repro.core import run_hybrid as jax_run_hybrid
    ref_es, _ = jax_run_hybrid(jax_graphs["road"], JaxSSSP(source=0),
                               device_loop=False)
    ref = jax_metrics.MetricsRegistry()
    jax_metrics.record_engine_counters(ref, ref_es.counters)
    assert reg.to_dict() == ref.to_dict()


# ---------------------------------------------------------------------------
# tracing through the executor
# ---------------------------------------------------------------------------

def test_trace_hook_counters_bit_identical(road, jax_graphs):
    """The stepwise TraceHook observes; it must not perturb: final state
    and every paper counter match the untraced run bit-for-bit, and its
    spans carry the reference's exchange bytes and counter deltas."""
    prog = SSSP(source=0)
    policy = make_policy("hybrid")
    ref = run_engine(road, prog, policy, None)

    tracer = Tracer()
    ctx = run_engine(road, prog, policy, None, hooks=trace_hooks(tracer))
    np.testing.assert_array_equal(ctx.es.state["dist"].numpy(),
                                  ref.es.state["dist"].numpy())
    assert_counters_equal(ctx.es, ref.es)

    steps = [s for s in tracer.spans if s.cat == "superstep"]
    assert len(steps) == ctx.iteration
    assert all(s.dur >= 0 and s.args["exchange_bytes"] >= 0 for s in steps)
    assert sum(s.args["barriers"] for s in steps) == ctx.iteration
    # the span deltas add up to the run's counters past its init
    init = policy.init(road, prog, None).counters
    for f in ("net_messages", "net_local_messages", "mem_messages"):
        assert sum(s.args[f] for s in steps) == \
            int(getattr(ctx.es.counters, f)) - int(getattr(init, f))
    assert sum(s.args["pseudo_supersteps"] for s in steps) == \
        int(ctx.es.counters.pseudo_supersteps.sum())

    jt = jax_trace.Tracer()
    jax_run_engine(jax_graphs["road"], JaxSSSP(source=0),
                   jax_make_policy("hybrid"), None,
                   hooks=jax_trace.trace_hooks(jt))
    assert _span_args(tracer) == _span_args(jt)


def test_exchange_bytes_match_reference(road, web, jax_graphs):
    """Per-partition wire bytes of the state after init and after one
    iteration, plain and under a bf16 wire encoding, equal the
    reference's accounting."""
    import jax.numpy as jnp
    from repro.exec.iteration import init_hybrid as jax_init
    from repro.exec.policy import hybrid_policy as jax_hybrid_policy
    from repro_torch.exec.iteration import init_hybrid
    from repro_torch.exec.policy import hybrid_policy

    for name, graph, make, jmake in (
            ("road", road, lambda: SSSP(source=0), lambda: JaxSSSP(source=0)),
            ("web", web, lambda: IncrementalPageRank(tolerance=1e-4),
             lambda: JaxPageRank(tolerance=1e-4))):
        jg = jax_graphs[name]
        es, jes = init_hybrid(graph, make(), None), jax_init(jg, jmake(),
                                                             None)
        for _ in range(2):
            for port_wd, ref_wd in ((None, None), ("bfloat16",
                                                   jnp.bfloat16)):
                np.testing.assert_array_equal(
                    exchange_bytes_per_partition(graph, es, port_wd),
                    jax_trace.exchange_bytes_per_partition(jg, jes, ref_wd))
            es = hybrid_policy().step(graph, make(), es, None)
            jes = jax_hybrid_policy().step(jg, jmake(), jes, None)


def test_device_loop_degrades_to_run_span(road):
    """``trace_hooks(device_loop=True)`` hands out the run-level hook, as
    the reference does; in the port's host loop it still records one run
    span with the run's iterations."""
    prog = SSSP(source=0)
    tracer = Tracer()
    hooks = trace_hooks(tracer, device_loop=True)
    assert isinstance(hooks[0], RunTraceHook)
    ctx = run_engine(road, prog, make_policy("hybrid"), None, hooks=hooks)
    [span] = [s for s in tracer.spans if s.name == "run"]
    assert span.args["iterations"] == ctx.iteration
    assert span.args["net_messages"] == int(ctx.es.counters.net_messages)


def test_disabled_tracer_contributes_nothing(road):
    assert trace_hooks(None) == ()
    assert trace_hooks(Tracer(enabled=False)) == ()
    t = Tracer(enabled=False)
    with t.span("x"):
        t.instant("y")
    assert t.spans == []
    # wrap_hooks is identity when tracing is off
    h = TraceHook(Tracer())
    assert wrap_hooks(None, (h,)) == (h,)
    # a run with the disabled tracer's hooks makes exactly the untraced
    # run's counted host reads
    counts = []
    for hooks in ((), trace_hooks(Tracer(enabled=False))):
        reset_host_reads()
        run_engine(road, SSSP(source=0), make_policy("hybrid"), None,
                   hooks=hooks)
        counts.append(host_reads())
    assert counts[0] == counts[1] > 0


def test_hot_path_never_imports_tracing():
    """Zero-cost disabled path: importing the engines, the executor, the FT
    driver and the serving layer must not pull in the tracing or export
    modules."""
    code = (
        "import sys\n"
        "import repro_torch.core.runtime, repro_torch.core.engine_hybrid\n"
        "import repro_torch.exec.driver, repro_torch.exec.iteration\n"
        "import repro_torch.ft.driver, repro_torch.serve.engine\n"
        "bad = [m for m in sys.modules if m.startswith('repro_torch.obs.')\n"
        "       and m not in ('repro_torch.obs.clock',\n"
        "                     'repro_torch.obs.metrics')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_exchange_bytes_zero_when_nothing_to_send(road):
    """After quiescence no vertex is exporting: the accounted wire bytes
    for a further exchange are exactly zero."""
    es, _ = run_hybrid(road, SSSP(source=0), **CPU)
    assert exchange_bytes(road, es) == 0


# ---------------------------------------------------------------------------
# phased profiler
# ---------------------------------------------------------------------------

def _records(res):
    return [(r.superstep, r.barriers, r.exchange_bytes, sorted(
        r.phase_seconds), r.pseudo_supersteps, r.net_messages,
        r.net_local_messages, r.mem_messages) for r in res.records]


@pytest.mark.parametrize("engine", ["bsp", "hybrid"])
def test_phased_run_bit_identical(road, jax_graphs, engine):
    """The phase decomposition is the step body: final state, iteration
    count, and every counter are bit-identical to the fused engines, and
    the records are the reference's apart from the seconds."""
    runner = {"bsp": run_bsp, "hybrid": run_hybrid}[engine]
    es_ref, it_ref = runner(road, SSSP(source=0), **CPU)

    res = phased_run(road, SSSP(source=0), engine, None)
    assert res.iterations == it_ref
    np.testing.assert_array_equal(res.es.state["dist"].numpy(),
                                  es_ref.state["dist"].numpy())
    assert_counters_equal(res.es, es_ref)
    assert len(res.records) == it_ref
    assert all(0.0 <= r.local_compute_fraction <= 1.0 for r in res.records)

    ref = jax_trace.phased_run(jax_graphs["road"], JaxSSSP(source=0),
                               engine, None)
    assert _records(res) == _records(ref)


def test_phased_hybrid_fewer_barriers_than_bsp(web, jax_graphs):
    """The paper's claim on one shared graph: hybrid converges in fewer
    global barriers (and fewer exchanged bytes) than BSP — with the
    reference's records, superstep by superstep."""
    b = phased_run(web, IncrementalPageRank(tolerance=1e-4), "bsp", None)
    h = phased_run(web, IncrementalPageRank(tolerance=1e-4), "hybrid", None)
    assert h.total_barriers < b.total_barriers
    assert h.total_exchange_bytes < b.total_exchange_bytes
    for res in (b, h):
        ref = jax_trace.phased_run(jax_graphs["web"],
                                   JaxPageRank(tolerance=1e-4), res.engine,
                                   None)
        assert _records(res) == _records(ref)


def test_phased_run_refuses_wire_dtype(road, jax_graphs):
    """A wire dtype outside ``runtime.WIRE_DTYPES`` is refused; a bfloat16
    wire runs, with the reference's records superstep by superstep."""
    import jax.numpy as jnp
    import torch

    with pytest.raises(ValueError, match="wire_dtype"):
        phased_run(road, SSSP(source=0), "hybrid", None,
                   wire_dtype="bfloat16")
    res = phased_run(road, SSSP(source=0), "hybrid", None,
                     wire_dtype=torch.bfloat16)
    ref = jax_trace.phased_run(jax_graphs["road"], JaxSSSP(source=0),
                               "hybrid", None, wire_dtype=jnp.bfloat16)
    assert _records(res) == _records(ref)
    np.testing.assert_array_equal(res.es.state["dist"].numpy(),
                                  np.asarray(ref.es.state["dist"]))


def test_report_matches_reference(capsys):
    """``run_report`` prints the reference's barriers and exchange bytes on
    the same arguments, and its cross-checks pass."""
    kw = dict(n_vertices=300, tolerance=1e-5, max_iters=100)
    port = report.run_report(["bsp", "hybrid"], device="cpu", **kw)
    ref = jax_report.run_report(["bsp", "hybrid"], **kw)
    for engine in ("bsp", "hybrid"):
        assert _records(port[engine]) == _records(ref[engine])
    assert port["checks"] == ref["checks"]
    assert all(port["checks"].values())
    out = capsys.readouterr().out
    assert "global barriers: hybrid" in out


def test_report_cli_writes_trace_and_profile(tmp_path):
    trace, prof = str(tmp_path / "t.json"), str(tmp_path / "p.json")
    rc = report.main(["--device", "cpu", "--vertices", "200",
                      "--tolerance", "1e-4", "--trace", trace,
                      "--profile", prof])
    assert rc == 0
    with open(trace) as f:
        _schema_check(json.load(f))
    with open(prof) as f:
        blob = json.load(f)
    assert set(blob["engines"]) == {"bsp", "hybrid"}


# ---------------------------------------------------------------------------
# Chrome trace export
# ---------------------------------------------------------------------------

def _schema_check(doc):
    evs = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    assert evs, "no events"
    for e in evs:
        assert e["ph"] in ("X", "i")
        for field in ("name", "cat", "ts", "pid", "tid"):
            assert field in e, f"missing {field}"
        assert isinstance(e["ts"], (int, float))
        if e["ph"] == "X":
            assert e["dur"] >= 0
    # timestamps monotone within every (pid, tid) track
    by_track = {}
    for e in evs:
        by_track.setdefault((e["pid"], e["tid"]), []).append(e["ts"])
    for ts in by_track.values():
        assert ts == sorted(ts)
    return evs


def test_chrome_trace_schema(road, tmp_path):
    tracer = Tracer()
    tracer.name_track(0, "hybrid")
    run_engine(road, SSSP(source=0), make_policy("hybrid"), None,
               hooks=trace_hooks(tracer))
    path = str(tmp_path / "trace.json")
    write_chrome_trace(tracer, path)
    with open(path) as f:
        doc = json.load(f)
    evs = _schema_check(doc)
    assert any(e["cat"] == "superstep" for e in evs)
    names = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert names and names[0]["args"]["name"] == "hybrid"


def test_ft_recovery_span_in_trace(road, jax_graphs, tmp_path):
    """A kill-and-recover FT run leaves the recovery annotated in the
    trace, with the reference's rollback accounting, bracketed by
    superstep spans, all schema-valid."""
    tracer = Tracer()
    inj = FaultInjector(FaultPlan.kill_at(3, worker=1), n_workers=4)
    res = run_hybrid_ft(road, SSSP(source=0), ckpt_dir=str(tmp_path / "c"),
                        n_workers=4, injector=inj, tracer=tracer, **CPU)
    assert len(res.recoveries) == 1

    [rec] = [s for s in tracer.spans if s.cat == "ft"]
    assert rec.name == "recovery"
    assert rec.args["failed_workers"] == [1]
    assert rec.args["iterations_lost"] >= 0
    assert rec.args["bytes_read"] > 0
    # the hooks' own work is visible too (checkpoint saves, fault sweeps)
    assert any(s.cat == "hook" and "CheckpointHook" in s.name
               for s in tracer.spans)
    assert any(s.cat == "superstep" for s in tracer.spans)
    _schema_check(chrome_trace(tracer))

    jt = jax_trace.Tracer()
    jax_run_hybrid_ft(jax_graphs["road"], JaxSSSP(source=0),
                      ckpt_dir=str(tmp_path / "j"), n_workers=4,
                      injector=JaxFaultInjector(
                          JaxFaultPlan.kill_at(3, worker=1), n_workers=4),
                      tracer=jt)
    [jrec] = [s for s in jt.spans if s.cat == "ft"]
    keys = ("tick", "failed_workers", "restored_iteration",
            "iterations_lost")
    assert {k: rec.args[k] for k in keys} == {k: jrec.args[k] for k in keys}
    assert _span_args(tracer) == _span_args(jt)
    assert [s.name for s in tracer.spans if s.cat == "hook"] == \
        [s.name for s in jt.spans if s.cat == "hook"]


def test_ft_registry_populated_and_flags_from_registry(road, jax_graphs):
    """run_hybrid_ft fills the registry, and the straggler flags read off
    its gauges are the run's; an absurdly low factor flags every
    partition.  Engine and FT metrics and the flags equal the
    reference's."""
    reg = MetricsRegistry()
    res = run_hybrid_ft(road, SSSP(source=0), registry=reg,
                        straggler_factor=0.01, balance=1.2, **CPU)
    assert res.registry is reg
    assert reg.value("engine.iterations") == float(res.iterations)
    assert reg.value("ft.recoveries") == 0.0
    assert len(res.straggler_flags) > 0
    flagged = {f.partition for f in res.straggler_flags}
    counts = np.asarray(reg.value("engine.pseudo_supersteps"))
    med = max(float(np.median(counts)), 1.0)
    assert flagged == set(np.flatnonzero(counts > 0.01 * med).tolist())
    assert flag_slow_shards(registry=reg, factor=0.01) == \
        res.straggler_flags

    ref_reg = jax_metrics.MetricsRegistry()
    ref = jax_run_hybrid_ft(jax_graphs["road"], JaxSSSP(source=0),
                            registry=ref_reg, straggler_factor=0.01,
                            balance=1.2)
    assert reg.to_dict() == ref_reg.to_dict()
    assert [dataclasses.astuple(f) for f in res.straggler_flags] == \
        [dataclasses.astuple(f) for f in ref.straggler_flags]


def test_profile_blob_shape(road):
    tracer = Tracer()
    res = phased_run(road, SSSP(source=0), "hybrid", None, tracer=tracer)
    reg = MetricsRegistry()
    record_engine_counters(reg, res.es.counters)
    blob = profile_blob(tracer=tracer, registry=reg, runs=[res],
                        meta={"fixture": "road"})
    assert blob["schema"] == "repro.obs.profile/1"
    eng = blob["engines"]["hybrid"]
    assert eng["iterations"] == res.iterations
    assert len(eng["supersteps"]) == res.iterations
    assert eng["total_barriers"] == res.total_barriers
    json.dumps(blob)          # fully JSON-serializable
    _schema_check(blob["trace"])
