"""The typed metrics registry.

Every subsystem keeps its own cheap native counters: the engines' paper
:class:`~repro_torch.core.runtime.Counters` (device tensors), the
straggler mitigator's ``redispatches`` / ``duplicates_suppressed`` ints,
the async checkpointer's ``bytes_written`` / ``save_seconds``, the serving
layer's ``trace_counts`` dict.  A :class:`MetricsRegistry` is the one
named, typed, JSON-round-trippable surface they all land on:

* **counter** — cumulative, monotonically non-decreasing float
  (:meth:`MetricsRegistry.inc`);
* **gauge** — a point-in-time scalar or vector
  (:meth:`MetricsRegistry.set_gauge`; vectors keep per-partition signals
  like ``pseudo_supersteps`` addressable by one name);
* **histogram** — bucketed distribution with count / sum / min / max
  (:meth:`MetricsRegistry.observe`; the serving layer's arrival-gap and
  batch-size distributions that lane-width autotuning needs).

``record_engine_counters`` / ``record_straggler`` / ``record_checkpointer``
/ ``record_serve`` snapshot the legacy carriers into a registry without
touching their hot paths; :func:`save_registry` / :func:`load_registry`
round-trip everything through JSON.

A copy of ``repro.obs.metrics`` (stdlib only), except that
:func:`record_engine_counters` reads the port's device counters through
one host copy.  The JSON is the reference's: a registry either package
saved loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Iterable

__all__ = ["Metric", "Histogram", "MetricsRegistry", "save_registry",
           "load_registry", "record_engine_counters", "record_straggler",
           "record_checkpointer", "record_serve"]

#: default histogram bucket upper bounds: log-spaced, wide enough for both
#: sub-millisecond inter-arrival gaps and thousand-lane batch sizes.
DEFAULT_BOUNDS = tuple(10.0 ** (e / 2) for e in range(-8, 9))  # 1e-4 .. 1e4


@dataclasses.dataclass
class Histogram:
    """Fixed-bound bucketed distribution.  ``counts[i]`` tallies values
    ``<= bounds[i]`` (first matching bucket); the last bucket is the
    +inf overflow.  Sum/min/max ride along so means and extremes survive
    the bucketing."""

    bounds: tuple[float, ...] = DEFAULT_BOUNDS
    counts: list[int] = None  # type: ignore[assignment]
    count: int = 0
    sum: float = 0.0
    min: float = math.inf
    max: float = -math.inf

    def __post_init__(self):
        if self.counts is None:
            self.counts = [0] * (len(self.bounds) + 1)

    def observe(self, v: float) -> None:
        v = float(v)
        i = next((i for i, b in enumerate(self.bounds) if v <= b),
                 len(self.bounds))
        self.counts[i] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_value(self) -> dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "count": self.count, "sum": self.sum,
                "min": None if self.count == 0 else self.min,
                "max": None if self.count == 0 else self.max}

    @staticmethod
    def from_value(v: dict) -> "Histogram":
        return Histogram(bounds=tuple(v["bounds"]),
                         counts=list(v["counts"]), count=int(v["count"]),
                         sum=float(v["sum"]),
                         min=math.inf if v["min"] is None else v["min"],
                         max=-math.inf if v["max"] is None else v["max"])


@dataclasses.dataclass
class Metric:
    """One named metric.  ``value`` is a float (counter / scalar gauge), a
    list of floats (vector gauge), or a :class:`Histogram`."""

    name: str
    kind: str                   # 'counter' | 'gauge' | 'histogram'
    value: Any
    unit: str = ""


class MetricsRegistry:
    """Name -> :class:`Metric`, with kind enforcement: a name registered as
    a counter stays a counter (re-registering it as a gauge raises, which
    catches two subsystems colliding on a name)."""

    def __init__(self):
        self._metrics: dict[str, Metric] = {}

    # -- write -------------------------------------------------------------

    def _slot(self, name: str, kind: str, unit: str) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            init = Histogram() if kind == "histogram" else 0.0
            m = Metric(name, kind, init, unit)
            self._metrics[name] = m
        elif m.kind != kind:
            raise ValueError(f"metric {name!r} is a {m.kind}, not a {kind}")
        return m

    def inc(self, name: str, v: float = 1.0, unit: str = "") -> None:
        """Add to a cumulative counter (negative increments are a bug)."""
        if v < 0:
            raise ValueError(f"counter {name!r}: negative increment {v}")
        self._slot(name, "counter", unit).value += float(v)

    def set_counter(self, name: str, v: float, unit: str = "") -> None:
        """Set a counter to an absolute cumulative value (snapshotting a
        legacy carrier that already accumulated it)."""
        self._slot(name, "counter", unit).value = float(v)

    def set_gauge(self, name: str, v, unit: str = "") -> None:
        """Set a gauge; scalars stay floats, iterables become list gauges
        (per-partition vectors keep one name)."""
        m = self._slot(name, "gauge", unit)
        if isinstance(v, (int, float)):
            m.value = float(v)
        else:
            m.value = [float(x) for x in v]

    def observe(self, name: str, v: float, unit: str = "",
                bounds: Iterable[float] | None = None) -> None:
        """Record one observation into a histogram (created on first use
        with ``bounds`` or the defaults)."""
        m = self._metrics.get(name)
        if m is None and bounds is not None:
            m = Metric(name, "histogram", Histogram(tuple(bounds)), unit)
            self._metrics[name] = m
        self._slot(name, "histogram", unit)
        self._metrics[name].value.observe(v)

    # -- read --------------------------------------------------------------

    def value(self, name: str, default=None):
        m = self._metrics.get(name)
        return default if m is None else m.value

    def histogram(self, name: str) -> Histogram | None:
        m = self._metrics.get(name)
        if m is not None and m.kind != "histogram":
            raise ValueError(f"metric {name!r} is a {m.kind}")
        return None if m is None else m.value

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict[str, Metric]:
        return dict(self._metrics)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __len__(self) -> int:
        return len(self._metrics)

    # -- round trip --------------------------------------------------------

    def to_dict(self) -> dict:
        out = {}
        for name, m in sorted(self._metrics.items()):
            v = m.value.to_value() if m.kind == "histogram" else m.value
            out[name] = {"kind": m.kind, "value": v, "unit": m.unit}
        return out

    @staticmethod
    def from_dict(d: dict) -> "MetricsRegistry":
        reg = MetricsRegistry()
        for name, rec in d.items():
            v = (Histogram.from_value(rec["value"])
                 if rec["kind"] == "histogram" else rec["value"])
            reg._metrics[name] = Metric(name, rec["kind"], v,
                                        rec.get("unit", ""))
        return reg


def save_registry(reg: MetricsRegistry, path: str) -> None:
    """Atomically persist a registry as JSON (tmp + rename, so a reader
    never sees a torn file)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(reg.to_dict(), f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def load_registry(path: str) -> MetricsRegistry:
    with open(path) as f:
        return MetricsRegistry.from_dict(json.load(f))


# ---------------------------------------------------------------------------
# adapters: snapshot the legacy per-subsystem carriers into a registry.
# Pull-based on purpose — the hot paths keep their cheap native counters
# and the registry reads them at observation points, so the disabled path
# costs nothing.
# ---------------------------------------------------------------------------

def record_engine_counters(reg: MetricsRegistry, counters,
                           prefix: str = "engine") -> None:
    """The paper's :class:`~repro_torch.core.runtime.Counters`: scalar
    totals as counters, the per-partition pseudo-superstep vector as a list
    gauge.  The five device tensors reach the host in one copy."""
    import torch

    host = torch.cat([counters.iterations.reshape(1),
                      counters.net_messages.reshape(1),
                      counters.net_local_messages.reshape(1),
                      counters.mem_messages.reshape(1),
                      counters.pseudo_supersteps.reshape(-1).to(
                          counters.iterations.dtype)]).cpu().tolist()
    it, net, net_local, mem = host[:4]
    reg.set_counter(f"{prefix}.iterations", float(it))
    reg.set_counter(f"{prefix}.net_messages", float(net), unit="msgs")
    reg.set_counter(f"{prefix}.net_local_messages", float(net_local),
                    unit="msgs")
    reg.set_counter(f"{prefix}.mem_messages", float(mem), unit="msgs")
    reg.set_gauge(f"{prefix}.pseudo_supersteps", host[4:])


def record_straggler(reg: MetricsRegistry, mit,
                     prefix: str = "straggler") -> None:
    """:class:`~repro_torch.ft.straggler.StragglerMitigator` statistics."""
    reg.set_counter(f"{prefix}.redispatches", float(mit.redispatches))
    reg.set_counter(f"{prefix}.duplicates_suppressed",
                    float(mit.duplicates_suppressed))
    reg.set_gauge(f"{prefix}.deadline_seconds", float(mit.deadline),
                  unit="s")


def record_checkpointer(reg: MetricsRegistry, ck,
                        prefix: str = "checkpoint") -> None:
    """:class:`~repro_torch.checkpoint.ckpt.AsyncCheckpointer` write costs."""
    reg.set_counter(f"{prefix}.bytes_written", float(ck.bytes_written),
                    unit="B")
    reg.set_counter(f"{prefix}.save_seconds", float(ck.save_seconds),
                    unit="s")


def record_serve(reg: MetricsRegistry, engine,
                 prefix: str = "serve") -> None:
    """The serving layer's compile-cache pressure: one counter per
    (program, lane-width) cache entry built."""
    for (key, k), n in sorted(engine.trace_counts.items()):
        name = key[0] if isinstance(key, tuple) else key
        reg.set_counter(f"{prefix}.compiles.{name}.K{k}", float(n))
