"""Finding things by name: ``BENCHMARK.json`` and the files each name owns.

``root`` is the repository root (where ``BENCHMARK.json`` lies) and
``home`` the benchmark's folder; both default to this checkout's, and the
tests point them at a temporary tree.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

__all__ = ["HOME", "ROOT", "load_spec", "workload", "config", "traffic",
           "limits", "app", "metric_reader", "cell_metrics"]

HOME = Path(__file__).resolve().parent
ROOT = HOME.parent


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def load_spec(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in spec['workloads']]}")


def config(name: str, home: Path = HOME) -> dict:
    return _json(Path(home) / "configs" / f"{name}.json")


def traffic(name: str, home: Path = HOME) -> dict:
    return _json(Path(home) / "traffic" / f"{name}.json")


def limits(cell: str, home: Path = HOME) -> dict:
    """The cell's limit on each number compared."""
    return _json(Path(home) / "limits" / f"{cell}.json")


def app(name: str, home: Path = HOME):
    """The module ``apps/<name>.py`` of ``home``, else of this package."""
    path = Path(home) / "apps" / f"{name}.py"
    if Path(home) != HOME and path.is_file():
        return _load(path, f"hpbench_app_{name}")
    return importlib.import_module(f"hpbench.apps.{name}")


def _load(path: Path, modname: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    sp = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def metric_reader(name: str, home: Path = HOME):
    """``read(run)`` of ``metrics/<name>.py``: the metric's value from what
    the run recorded, or None where the run has nothing to read."""
    mod = _load(Path(home) / "metrics" / f"{name}.py",
                "hpbench_metric_" + name.replace(".", "_").replace("-", "_"))
    return mod.read


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end ones with ``trace`` off,
    its per-layer ones with it on.  A metric with ``workloads`` belongs to
    those cells; an end-to-end one without belongs to every cell, a
    per-layer one without to every cell that reports what it moves."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]
