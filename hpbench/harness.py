"""One run of one cell: set-up, the measured window, the traced probes, the
check against the plain reference, and the result line.

``run_cell`` does all but the look for a card, which ``main`` makes first;
the tests call ``run_cell`` on the CPU with ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

from hpbench import spec as S
from hpbench.graphs import generator, make_inputs, sub_seed

__all__ = ["Run", "run_cell", "main", "FORBIDDEN"]

#: top-level module names that may not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


class Run:
    """What one run knows and records; the metric readers read it."""

    def __init__(self, cell, cfg, mix, seed, seconds, trace, device, t0,
                 home):
        self.cell, self.cfg, self.mix = cell, cfg, mix
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t0, self.home = device, t0, Path(home)
        self.setup_s = None
        self.peak_bytes = None
        self.inputs = self.graph = None
        self.window: dict = {}
        self.traced: dict = {}

    def app(self, name):
        return S.app(name, self.home)

    def mark_setup(self):
        self.setup_s = time.perf_counter() - self.t0


def _say(*parts):
    print("[hpbench]", *parts, file=sys.stderr, flush=True)


def _build(run):
    """The configuration's graph on the run's device, by the port's
    builder."""
    import repro_torch
    inp = run.inputs
    return repro_torch.build_partitioned_graph(
        inp["edges"], inp["n"], inp["part"], device=run.device,
        **run.cfg.get("build", {}))


def _traced_jobs(run):
    """Per-layer probes of a jobs window: one job profiled, one job run as
    phase functions, the kernels' rows."""
    import repro_torch
    from repro_torch.obs.trace import phased_run
    from hpbench.kernels import kernel_rows
    from hpbench.profiling import profile_window

    w = run.window
    app = run.app(w["app"])
    rng = np.random.default_rng(sub_seed(run.seed, 5))
    prog = app.program(w["params"], rng)

    def one():
        es, _ = repro_torch.run_hybrid(run.graph, prog, device=run.device)
        return es.state[app.STATE].to("cpu")

    state, prof = profile_window(one, "hpbench.job")
    w["jobs"].append({"program": prog, "state": state, "traced": True})
    ph = phased_run(run.graph, app.program(w["params"], rng))
    secs = {}
    for r in ph.records:
        for k, v in r.phase_seconds.items():
            secs[k] = secs.get(k, 0.0) + v
    n = sum(1 for j in w["jobs"] if not j.get("traced"))
    per_job = lambda d: {k: v / n for k, v in d.items()}   # noqa: E731
    gen = generator(run.seed, 3, run.device)
    rows = kernel_rows(run.graph, prog, w["jobs"][0]["state"],
                       per_job(w["launches"]), per_job(w["bin_launches"]),
                       gen)
    run.traced.update(profile=prof, phases=secs, kernels=rows)


def _answers(run):
    """Every job's answer, the traced one too, as ``(program, values)`` in
    host arrays of vertex order."""
    from repro_torch import unpack_vertex
    return [(j["program"], unpack_vertex(run.graph, j["state"]))
            for j in run.window["jobs"]]


def _free(run):
    """Drop the program's state before the reference runs."""
    import torch
    run.graph = None
    for j in run.window["jobs"]:
        j.pop("state", None)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device=None, t0: float | None = None, root=S.ROOT,
             home=S.HOME) -> dict:
    """One run of cell ``name``; returns the result line as a dict, with the
    numbers compared under ``checks``."""
    import torch
    t0 = time.perf_counter() if t0 is None else t0
    spec = S.load_spec(root)
    cell = S.workload(spec, name)
    cfg = S.config(cell["config"], home)
    mix = S.traffic(cell["traffic"], home)
    limits = S.limits(name, home)
    dev = torch.device(device or "cuda")
    run = Run(cell, cfg, mix, int(seed), float(seconds), bool(trace), dev,
              t0, home)

    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build()
    run.inputs = make_inputs(cfg, run.seed, dev)
    run.graph = _build(run)
    _say(f"graph V={run.inputs['n']} E={len(run.inputs['edges'])} "
         f"P={run.graph.n_partitions} built at "
         f"{time.perf_counter() - t0:.1f} s")
    from hpbench.drivers import DRIVERS
    run.window = DRIVERS[mix["driver"]](run, mix)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
    if run.trace:
        _traced_jobs(run)

    metrics = {}
    for m in S.cell_metrics(spec, name, run.trace):
        v = S.metric_reader(m["name"], home)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    answers = _answers(run)
    app_name, params = run.window["app"], run.window["params"]
    _free(run)
    app = run.app(app_name)
    readings = app.reading(run.inputs, answers, params, device=dev)
    checks = {k: {"value": max((r[k] for r in readings), default=math.inf),
                  "limit": limits[k]} for k in app.CHECKS}
    bad = sum(1 for r in readings
              if not all(r[k] <= limits[k] for k in app.CHECKS))
    result = {
        "correct": bool(readings) and bad == 0,
        "attempted": len(readings),
        "failed": bad,
        "metrics": metrics,
        "device": _device(run),
    }
    if run.trace:
        prof = run.traced["profile"]
        result["device"].update(busy_s=prof["busy_s"],
                                window_s=prof["window_s"])
        result["breakdown"] = {"device_ops": prof["ops"],
                               "idle_gaps": prof["gaps"]}
    result["checks"] = checks
    return result


def _device(run) -> dict:
    import torch
    if run.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": run.peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": run.cell["chips"], "memory_peak_bytes": run.peak_bytes}


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    cell = S.workload(S.load_spec(), args.workload)
    if not torch.cuda.is_available():
        _say("no CUDA device: torch.cuda.is_available() is False")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        _say(f"the cell needs {cell['chips']} cards, "
             f"{torch.cuda.device_count()} present")
        return 2
    from hpbench.profiling import power_limit
    _say(f"card: {power_limit()}, torch {torch.__version__}")
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t0=t0)
    found = forbidden_modules()
    if found:
        _say(f"loaded in this process: {found}")
        return 3
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0
