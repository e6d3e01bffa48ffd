"""The harness: BENCHMARK.json's shape, finding things by name, the look
for a card, whole runs of each cell on the CPU at a tiny size, and the
check coming out false when the timed path is broken underneath."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hpbench import spec as S
from hpbench.control import control_reading
from hpbench.drivers import DRIVERS
from hpbench.harness import Run, run_cell

HOME = Path(__file__).resolve().parent
ROOT = HOME.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# the sizes the CPU runs shrink each configuration to
TINY = {"rgg-n-2-22": {"graph": {"log2_vertices": 10},
                       "partition": {"tiles": 2, "n_partitions": 4}}}
SEED = 2**31 + 4099


def test_benchmark_json_keys_names_and_units():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["hpbench"]
    assert SPEC["command"] == ["python3", "hpbench/run.py"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 10 <= SPEC["run_seconds"] <= 51
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"hpbench/configs/{c['name']}.json"
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in names and NAME.match(w["traffic"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(cell in CELLS for cell in m.get("workloads", []))
    everything = [c["name"] for c in SPEC["configs"]] + CELLS + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(everything) == len(set(everything))
    assert all(NAME.match(n) for n in everything)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_every_cell_reports_setup_another_metric_and_a_layer():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for cell in CELLS:
        mine = {m["name"] for m in S.cell_metrics(SPEC, cell, False)}
        assert "setup_s" in mine and len(mine) >= 2
        assert S.cell_metrics(SPEC, cell, True)


def test_layer_metrics_move_what_their_cells_report():
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        for cell in m["workloads"]:
            reported = {e["name"] for e in S.cell_metrics(SPEC, cell, False)}
            assert m["moves"] in reported, (m["name"], cell)


def test_every_name_has_its_files():
    for c in SPEC["configs"]:
        cfg = S.config(c["name"])
        for key in c["reduced"]:
            assert key in cfg                  # the cut is written down
        assert S.app(cfg["jobs"]["app"]).CHECKS
    for w in SPEC["workloads"]:
        assert S.traffic(w["traffic"])["driver"] in DRIVERS
        app = S.app(S.config(w["config"])["jobs"]["app"])
        assert set(app.CHECKS) == set(S.limits(w["name"]))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(S.metric_reader(m["name"]))


def _tiny_home(tmp: Path, extra_cells=(), sizes=TINY) -> Path:
    """A copy of the benchmark's data files under ``tmp`` with every
    configuration shrunk to ``sizes``."""
    for sub in ("traffic", "limits", "metrics"):
        shutil.copytree(HOME / sub, tmp / sub)
    (tmp / "configs").mkdir()
    for name, size in sizes.items():
        cfg = S.config(name)
        for k, v in size.items():
            cfg[k].update(v)
        (tmp / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"] += list(extra_cells)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _tiny_home(tmp_path_factory.mktemp("tiny"))


def test_new_config_mix_and_metric_found_by_name(tmp_path):
    """A configuration, a traffic mix, a limit file and two metrics added
    as files, with entries in BENCHMARK.json, run without an edit to any
    existing file."""
    home = _tiny_home(tmp_path, [{"name": "rgg-small.quick",
                                  "config": "rgg-small", "traffic": "quick",
                                  "chips": 1, "why": "test"}])
    cfg = S.config("rgg-n-2-22", home)
    cfg["name"] = "rgg-small"
    cfg["graph"].update(log2_vertices=9)
    (home / "configs" / "rgg-small.json").write_text(json.dumps(cfg))
    (home / "traffic" / "quick.json").write_text(json.dumps(
        {"driver": "jobs"}))
    (home / "limits" / "rgg-small.quick.json").write_text(
        json.dumps(S.limits("rgg-n-2-22.jobs")))
    (home / "metrics" / "jobs_done.py").write_text(
        "def read(run):\n    return len(run.window['jobs'])\n")
    (home / "metrics" / "most_iterations.layer.py").write_text(
        "def read(run):\n    return max(j['iterations'] for j in "
        "run.window['jobs'])\n")
    spec = json.loads((home / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "jobs_done", "unit": "count",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["rgg-small.quick"]})
    spec["per_layer"].append({"name": "most_iterations.layer",
                              "unit": "count", "better": "lower",
                              "source": "program_counter",
                              "layer": "engine", "moves": "jobs_done",
                              "workloads": ["rgg-small.quick"]})
    (home / "BENCHMARK.json").write_text(json.dumps(spec))
    r = run_cell("rgg-small.quick", SEED, 0.5, False, device="cpu",
                 root=home, home=home)
    assert r["correct"] and r["metrics"]["jobs_done"]["value"] >= 1
    assert set(r["metrics"]) == {"setup_s", "jobs_done"}
    layer = S.cell_metrics(spec, "rgg-small.quick", True)
    assert [m["name"] for m in layer] == ["most_iterations.layer"]
    run = Run(None, None, None, 0, 0, True, None, 0, home)
    run.window = {"jobs": [{"iterations": 3}, {"iterations": 5}]}
    assert S.metric_reader("most_iterations.layer", home)(run) == 5


def _run_py(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "hpbench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_run_py_without_a_card_prints_no_result():
    out = _run_py(ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout and "setup_s" not in out.stdout


def test_run_py_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HOME, tmp_path / "hpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path, {"PYTHONPATH": ""})
    assert out.returncode != 0 and "{" not in out.stdout


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_runs_correct_on_cpu(tiny, cell):
    r = run_cell(cell, SEED, 0.5, False, device="cpu", root=tiny, home=tiny)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    spec = S.load_spec(tiny)
    names = {m["name"] for m in S.cell_metrics(spec, cell, False)}
    assert names - {"peak_device_gib"} == set(r["metrics"])
    assert list(r)[-1] == "checks"
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


def _state_unchanged(mp):
    """Every run returns its initial state."""
    import repro_torch
    from repro_torch.exec.iteration import init_hybrid
    mp.setattr(repro_torch, "run_hybrid",
               lambda g, p, vdata=None, device=None, **k:
               (init_hybrid(g, p, vdata), 0))


def _exchange_left_out(mp):
    """The exchange between partitions does nothing."""
    import repro_torch.exec.iteration as it
    mp.setattr(it, "exchange", lambda graph, es, *a, **k: es)


def _answer_altered(mp):
    """One vertex's value of each answer changed where it is produced."""
    import repro_torch
    run = repro_torch.run_hybrid

    def altered(graph, prog, *a, **k):
        es, it = run(graph, prog, *a, **k)
        real = int(torch.nonzero(graph.vertex_gid.reshape(-1) >= 0)[-1])
        for key, v in es.state.items():
            v = v.clone()
            v.reshape(-1)[real] += 1
            es.state[key] = v
        return es, it
    mp.setattr(repro_torch, "run_hybrid", altered)


FAULTS = {"state_unchanged": _state_unchanged,
          "exchange_left_out": _exchange_left_out,
          "answer_altered": _answer_altered}
CASES = [(c, f) for c in CELLS for f in FAULTS]


@pytest.mark.parametrize("cell,fault", CASES)
def test_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    r = run_cell(cell, SEED + 1, 0.5, False, device="cpu", root=tiny,
                 home=tiny)
    assert not r["correct"] and r["failed"] >= 1, r["checks"]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    sizes = {"rgg-n-2-22": {"graph": {"log2_vertices": 12},
                            "partition": {"tiles": 2, "n_partitions": 4}}}
    return _tiny_home(tmp_path_factory.mktemp("small"), sizes=sizes)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit(small, cell):
    """The reference in bfloat16 in the port's place, on two seeds."""
    for seed in (SEED, SEED + 7):
        c = control_reading(cell, seed, torch.device("cpu"), root=small,
                            home=small)
        assert c["fails"], c


@pytest.mark.gpu
def test_tiny_cells_traced_on_the_card(tmp_path):
    """Each cell at a tiny size on the card with tracing on: correct, every
    per-layer metric read, busy and window seconds from the profiler."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    home = _tiny_home(tmp_path)
    spec = S.load_spec(home)
    for cell in CELLS:
        r = run_cell(cell, SEED, 1.0, True, device="cuda", root=home,
                     home=home)
        assert r["correct"], r["checks"]
        want = {m["name"] for m in S.cell_metrics(spec, cell, True)}
        assert set(r["metrics"]) == want
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
