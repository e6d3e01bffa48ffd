"""The general traffic generator: a traffic mix is a data file whose
``driver`` names one of these, with its parameters beside it.

* ``jobs`` — whole jobs back to back, as an analyst runs them:
  ``run_hybrid(graph, program)`` with the configuration's job program, a
  fresh program a job, each built by the app from the job stream of
  ``--seed``.

A driver warms up (set-up), then runs its window of ``seconds``: whole
jobs start while the window is open, and the last one runs to its end.  It
returns what it recorded; the harness reads the metrics and the answers
from it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hpbench.graphs import sub_seed

__all__ = ["DRIVERS"]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def jobs(run, mix: dict) -> dict:
    """Whole ``run_hybrid`` jobs back to back; one warm job first."""
    import repro_torch
    from repro_torch.kernels.common import (BIN_LAUNCHES, LAUNCHES,
                                            reset_launches)
    from torch.profiler import record_function

    params = run.cfg["jobs"]
    app = run.app(params["app"])
    dev = run.device
    warm = np.random.default_rng(sub_seed(run.seed, 2))
    repro_torch.run_hybrid(run.graph, app.program(params, warm), device=dev)
    _sync(dev)
    run.mark_setup()

    rng = np.random.default_rng(sub_seed(run.seed, 1))
    reset_launches()
    out = []
    end = time.perf_counter() + run.seconds
    while not out or time.perf_counter() < end:
        prog = app.program(params, rng)
        t = time.perf_counter()
        with record_function("hpbench.job"):
            es, _ = repro_torch.run_hybrid(run.graph, prog, device=dev)
            # the answer leaves the card, as the user takes it
            state = es.state[app.STATE].to("cpu")
            c = es.counters
            counts = (int(c.iterations), int(c.pseudo_supersteps.sum()))
            _sync(dev)
        out.append({"program": prog, "start": t, "end": time.perf_counter(),
                    "iterations": counts[0],
                    "pseudo_supersteps": counts[1], "state": state})
        del es
    return {"kind": "jobs", "app": params["app"], "params": params,
            "jobs": out, "launches": dict(LAUNCHES),
            "bin_launches": dict(BIN_LAUNCHES)}


DRIVERS = {"jobs": jobs}
