"""Exporters: Chrome trace-event JSON and the machine-readable profile blob.

``chrome_trace`` serializes a :class:`~repro_torch.obs.trace.Tracer` into
the Chrome trace-event format (the JSON array flavour wrapped in a
``traceEvents`` object), loadable directly in Perfetto / ``chrome://tracing``:
spans become complete events (``ph="X"`` with ``ts``/``dur`` in
microseconds), instants become ``ph="i"``, and named tracks get
``thread_name`` metadata events.  Events are emitted sorted by
``(pid, tid, ts)`` so timestamps are monotone within every track.

``profile_blob`` bundles the same spans with a metrics-registry snapshot
and per-superstep records into one JSON document for scripted analysis —
the report CLI writes this shape.

A copy of ``repro.obs.export`` (stdlib only): the same JSON documents.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterable

__all__ = ["chrome_trace", "write_chrome_trace", "profile_blob",
           "write_profile"]

_PID = 0  # single-process reproduction: one Chrome "process" track group


def _event(span, pid: int = _PID) -> dict:
    ev = {
        "name": span.name,
        "cat": span.cat or "default",
        "ph": span.ph,
        "ts": span.ts * 1e6,          # trace-event timestamps are in us
        "pid": pid,
        "tid": span.tid,
        "args": dict(span.args),
    }
    if span.ph == "X":
        ev["dur"] = span.dur * 1e6
    elif span.ph == "i":
        ev["s"] = "t"                 # instant scoped to its thread/track
    return ev


def chrome_trace(tracer, pid: int = _PID) -> dict:
    """The tracer's spans as a Chrome trace-event JSON object."""
    events = [_event(s, pid) for s in tracer.spans]
    # Monotone per track: chrome://tracing tolerates disorder, the schema
    # test (and some Perfetto importers) do not.
    events.sort(key=lambda e: (e["pid"], e["tid"], e["ts"]))
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": name}}
            for tid, name in sorted(tracer.track_names.items())]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(tracer, path: str, pid: int = _PID) -> None:
    """Atomically write :func:`chrome_trace` JSON to ``path``."""
    _dump(chrome_trace(tracer, pid), path)


def _record_dict(rec) -> dict:
    """A :class:`~repro_torch.obs.trace.SuperstepRecord` as plain JSON."""
    return {
        "superstep": rec.superstep,
        "barriers": rec.barriers,
        "exchange_bytes": rec.exchange_bytes,
        "phase_seconds": dict(rec.phase_seconds),
        "total_seconds": rec.total_seconds,
        "local_compute_fraction": rec.local_compute_fraction,
        "pseudo_supersteps": rec.pseudo_supersteps,
        "net_messages": rec.net_messages,
        "net_local_messages": rec.net_local_messages,
        "mem_messages": rec.mem_messages,
    }


def profile_blob(tracer=None, registry=None,
                 runs: Iterable[Any] = (), meta: dict | None = None) -> dict:
    """One machine-readable JSON document: trace events + registry snapshot
    + per-engine superstep records
    (:class:`~repro_torch.obs.trace.PhasedRunResult` instances in
    ``runs``)."""
    blob: dict[str, Any] = {"schema": "repro.obs.profile/1",
                            "meta": dict(meta or {})}
    if tracer is not None:
        blob["trace"] = chrome_trace(tracer)
    if registry is not None:
        blob["metrics"] = registry.to_dict()
    engines = {}
    for run in runs:
        engines[run.engine] = {
            "iterations": run.iterations,
            "total_barriers": run.total_barriers,
            "total_exchange_bytes": run.total_exchange_bytes,
            "mean_local_compute_fraction": run.mean_local_compute_fraction,
            "supersteps": [_record_dict(r) for r in run.records],
        }
    if engines:
        blob["engines"] = engines
    return blob


def write_profile(blob: dict, path: str) -> None:
    """Atomically write a :func:`profile_blob` document to ``path``."""
    _dump(blob, path)


def _dump(obj: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=False)
    os.replace(tmp, path)
