"""Observability: superstep tracing, phase metrics, exporters, the
BSP-vs-hybrid report CLI, and the one injectable clock.

Layout (each submodule is importable on its own; nothing on the engines'
hot path imports this package's tracing — hooks and wrappers are opt-in):

* :mod:`repro_torch.obs.clock`   — the injectable monotonic / perf clock
  every time-consuming subsystem (ft, checkpoint, serve) routes through.
* :mod:`repro_torch.obs.trace`   — span tracer, the executor
  ``TraceHook``, the phased per-phase profiler, and exchange-bytes
  accounting.
* :mod:`repro_torch.obs.metrics` — the typed metrics registry unifying the
  engine ``Counters``, straggler / checkpoint / serving statistics.
* :mod:`repro_torch.obs.export`  — Chrome trace-event JSON
  (Perfetto-loadable) and the machine-readable profile blob.
* :mod:`repro_torch.obs.report`  — ``python -m repro_torch.obs.report``:
  the paper's headline exchange-vs-compute comparison, measured.

``from repro_torch.obs import clock`` is the only import light enough for
leaf modules (it pulls nothing but stdlib ``time``); everything else is
loaded lazily through ``__getattr__``, so wiring ``obs`` into a module
costs nothing until a tracer or registry is actually constructed.

The port of ``repro.obs``.
"""

from __future__ import annotations

import importlib

from repro_torch.obs import clock  # noqa: F401  (stdlib-only; safe everywhere)

_SUBMODULES = ("trace", "metrics", "export", "report")

__all__ = ["clock", *_SUBMODULES]


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.obs.{name}")
    raise AttributeError(f"module 'repro_torch.obs' has no attribute "
                         f"{name!r}")
