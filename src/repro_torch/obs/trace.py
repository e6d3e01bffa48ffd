"""Span tracing for the superstep executor.

Three granularities, one :class:`Tracer`:

* **run-level** — :class:`RunTraceHook` brackets a whole ``run_engine``
  call in one span (``on_start`` / ``on_exit`` only): the one granularity
  a ``device_loop=True`` run has, since the whole loop runs on the device
  with no host boundary between steps (:func:`trace_hooks` picks it).
* **superstep-level** — :class:`TraceHook` records one span per executor
  step with the counter deltas and the exchange bytes the step is about
  to put on the wire.  Works on every run path (``run_engine`` with any
  policy, ``run_hybrid_ft``, ``ServeEngine``); :func:`trace_hooks` picks
  the hook class.
* **phase-level** — :func:`phased_run` executes an engine's superstep as
  its composable phase functions (:mod:`repro_torch.exec.iteration`),
  timing each phase separately: exchange, delivery, global apply, local
  phase.  The composition is bit-identical to the fused step (the phase
  functions *are* the step body), so phase attribution costs only a
  device synchronization between phases.

Every clock read that closes a span waits for the card first
(``torch.cuda.synchronize``): kernels run asynchronously, and a span
closed without it would time the launches, not the work.

Disabled is free: nothing on the engine hot path imports this module, a
``None``/disabled tracer contributes zero hooks (:func:`trace_hooks`
returns ``()``), and all accounting (exchange bytes, counter deltas) runs
only when a span is actually being recorded.

:func:`wrap_hooks` decorates any other executor hook (checkpointing, the
FT fault hook) so its per-method work shows up as ``cat="hook"`` spans —
that is how checkpoint save time is separated from step time in a trace.

:func:`traced_dist_step` wraps the distributed step
(:mod:`repro_torch.core.distributed`): one ``dist_step`` span per global
iteration on rank 0, with each rank's exchange bytes, halo slots and
pseudo-supersteps gathered as small integer vectors.

The port of ``repro.obs.trace``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.exec.driver import ExecContext, ExecHook
from repro_torch.obs import clock

__all__ = ["Span", "Tracer", "TraceHook", "RunTraceHook", "trace_hooks",
           "wrap_hooks", "exchange_bytes", "exchange_bytes_per_partition",
           "halo_slots_per_partition", "phased_run", "SuperstepRecord",
           "PhasedRunResult", "COMM_PHASES", "traced_dist_step"]


@dataclasses.dataclass
class Span:
    """One trace event.  ``ts``/``dur`` are seconds in the
    :func:`repro_torch.obs.clock.perf_counter` domain; the Chrome exporter
    converts to microseconds.  ``ph`` follows the trace-event format:
    ``"X"`` complete spans, ``"i"`` instants."""

    name: str
    ts: float
    dur: float = 0.0
    cat: str = ""
    tid: int = 0
    ph: str = "X"
    args: dict = dataclasses.field(default_factory=dict)


class Tracer:
    """Append-only span sink.  ``enabled=False`` turns every recording
    method into a no-op so instrumentation can stay wired in production
    code paths."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.spans: list[Span] = []
        self.track_names: dict[int, str] = {}

    def name_track(self, tid: int, name: str) -> None:
        self.track_names[int(tid)] = name

    def add(self, name: str, ts: float, dur: float = 0.0, cat: str = "",
            tid: int = 0, ph: str = "X", **args) -> None:
        if self.enabled:
            self.spans.append(Span(name, ts, dur, cat, tid, ph, dict(args)))

    def instant(self, name: str, cat: str = "", tid: int = 0, **args) -> None:
        """A zero-duration annotation (e.g. a recovery event)."""
        self.add(name, clock.perf_counter(), 0.0, cat, tid, ph="i", **args)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "", tid: int = 0, **args):
        """Record the block as one complete span; the yielded dict can be
        mutated to attach args discovered inside the block."""
        mutable = dict(args)
        if not self.enabled:
            yield mutable
            return
        t0 = clock.perf_counter()
        try:
            yield mutable
        finally:
            self.spans.append(Span(name, t0, clock.perf_counter() - t0,
                                   cat, tid, "X", mutable))


def _wait(t: torch.Tensor) -> None:
    """Wait for the card that holds ``t`` (a no-op for host tensors)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _leaves(tree) -> list:
    """Tensor leaves of a dict / tuple tree, dict keys sorted (the order
    ``jax.tree_util`` walks the reference's)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# exchange-bytes accounting (host-side, from the engine state the step is
# about to exchange — every engine's step body starts with the exchange, so
# the current export buffer is exactly what crosses the wire next).
# ---------------------------------------------------------------------------

def _itemsize(dtype) -> int:
    """Bytes of one element of a torch dtype, a torch dtype's name, or
    anything ``numpy.dtype`` takes."""
    if isinstance(dtype, str) and isinstance(getattr(torch, dtype, None),
                                             torch.dtype):
        dtype = getattr(torch, dtype)
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def _wire_itemsize(leaf: torch.Tensor, wire_dtype) -> int:
    if wire_dtype is not None and leaf.dtype.is_floating_point:
        return _itemsize(wire_dtype)
    return leaf.element_size()


def exchange_bytes_per_partition(graph, es, wire_dtype=None) -> np.ndarray:
    """(P,) bytes each partition contributes to the next exchange: its
    valid *sending* export slots times the per-slot payload bytes of every
    exported leaf (after ``wire_dtype`` quantization, as the reference's
    ``repro.core.runtime.exchange`` encodes the wire).  On a rank's block
    of partitions, the block's partitions."""
    p = torch.arange(es.export_send.shape[0], device=graph.device)[:, None]
    sending = torch.logical_and(es.export_send[p, graph.export_slot.long()],
                                graph.export_mask)          # (P, X)
    n_sending = sending.sum(dim=1).cpu().numpy()            # (P,)
    per_slot = 0
    for leaf in _leaves(es.export_out):
        width = int(np.prod(leaf.shape[2:], dtype=np.int64)) if \
            leaf.dim() > 2 else 1
        per_slot += width * _wire_itemsize(leaf, wire_dtype)
    return n_sending.astype(np.int64) * per_slot


def exchange_bytes(graph, es, wire_dtype=None) -> int:
    """Total bytes the next exchange puts on the wire (see
    :func:`exchange_bytes_per_partition`)."""
    return int(exchange_bytes_per_partition(graph, es, wire_dtype).sum())


def halo_slots_per_partition(graph) -> np.ndarray:
    """(P,) valid halo slots per partition — each one is a remote
    out-state the partition consumes per exchange (static per graph)."""
    return graph.halo_mask.sum(dim=1).cpu().numpy().astype(np.int64)


def _counters_host(counters) -> dict:
    """The paper counters on the host, in one device-to-host copy."""
    c = torch.cat([counters.iterations.reshape(1),
                   counters.net_messages.reshape(1),
                   counters.net_local_messages.reshape(1),
                   counters.mem_messages.reshape(1),
                   counters.pseudo_supersteps.reshape(-1).to(
                       counters.iterations.dtype)]).cpu().numpy()
    return {
        "iterations": int(c[0]),
        "net_messages": int(c[1]),
        "net_local_messages": int(c[2]),
        "mem_messages": int(c[3]),
        "pseudo_supersteps": c[4:].astype(np.int64),
    }


def _counter_deltas(before: dict, after: dict) -> dict:
    return {
        "net_messages": after["net_messages"] - before["net_messages"],
        "net_local_messages": (after["net_local_messages"]
                               - before["net_local_messages"]),
        "mem_messages": after["mem_messages"] - before["mem_messages"],
        "pseudo_supersteps": int((after["pseudo_supersteps"]
                                  - before["pseudo_supersteps"]).sum()),
    }


# ---------------------------------------------------------------------------
# executor hooks (obs -> exec, never the other way around: the executor
# must not pay a tracing import when no one traces)
# ---------------------------------------------------------------------------

class TraceHook(ExecHook):
    """One span per executor step, with the step's exchange bytes and
    counter deltas as args.

    Put this hook *last* in the hook list: span order then brackets the
    step plus the preceding hooks' after-work (wrap those with
    :func:`wrap_hooks` to see their cost separately).
    """

    def __init__(self, tracer: Tracer, tid: int = 0, wire_dtype=None):
        self.tracer = tracer
        self.tid = tid
        self.wire_dtype = wire_dtype
        self._t0 = 0.0
        self._xb = 0
        self._before: dict | None = None

    def on_start(self, ctx: ExecContext) -> None:
        self.tracer.instant("run_start", cat="engine", tid=self.tid,
                            iteration=ctx.iteration)

    def before_step(self, ctx: ExecContext) -> None:
        if not self.tracer.enabled:
            return
        self._xb = exchange_bytes(ctx.graph, ctx.es, self.wire_dtype)
        self._before = _counters_host(ctx.es.counters)
        self._t0 = clock.perf_counter()

    def after_step(self, ctx: ExecContext) -> None:
        if not self.tracer.enabled or self._before is None:
            return
        _wait(ctx.es.send)
        dur = clock.perf_counter() - self._t0
        after = _counters_host(ctx.es.counters)
        self.tracer.add(
            "superstep", self._t0, dur, cat="superstep", tid=self.tid,
            iteration=ctx.iteration, exchange_bytes=self._xb, barriers=1,
            **_counter_deltas(self._before, after))
        self._before = None


class RunTraceHook(ExecHook):
    """Run-level span only (``on_start``/``on_exit``): one span for the
    whole run, with its counter deltas."""

    def __init__(self, tracer: Tracer, tid: int = 0):
        self.tracer = tracer
        self.tid = tid
        self._t0 = 0.0
        self._before: dict | None = None

    def on_start(self, ctx: ExecContext) -> None:
        if not self.tracer.enabled:
            return
        self._before = _counters_host(ctx.es.counters)
        self._t0 = clock.perf_counter()

    def on_exit(self, ctx: ExecContext) -> None:
        if not self.tracer.enabled or self._before is None:
            return
        _wait(ctx.es.send)
        after = _counters_host(ctx.es.counters)
        self.tracer.add(
            "run", self._t0, clock.perf_counter() - self._t0, cat="engine",
            tid=self.tid, iterations=ctx.iteration,
            **_counter_deltas(self._before, after))


def trace_hooks(tracer: Tracer | None, device_loop: bool = False,
                tid: int = 0, wire_dtype=None) -> tuple[ExecHook, ...]:
    """The hooks a run should carry for ``tracer``: ``()`` when tracing is
    off (the disabled path adds zero hooks, zero work), a stepwise
    :class:`TraceHook` by default, a :class:`RunTraceHook` with
    ``device_loop=True`` (a device loop rejects stepwise hooks)."""
    if tracer is None or not tracer.enabled:
        return ()
    if device_loop:
        return (RunTraceHook(tracer, tid=tid),)
    return (TraceHook(tracer, tid=tid, wire_dtype=wire_dtype),)


class _WrappedHook(ExecHook):
    """Delegates to ``inner``, timing each overridden method as a
    ``cat="hook"`` span.  Return values pass through untouched, so the
    driver's consumed-tick contract (``before_step`` returning ``False``)
    is preserved."""

    def __init__(self, inner: ExecHook, tracer: Tracer, tid: int = 0):
        self.inner = inner
        self.tracer = tracer
        self.tid = tid

    def _call(self, method: str, ctx: ExecContext):
        fn = getattr(self.inner, method)
        if not self.tracer.enabled:
            return fn(ctx)
        name = f"{type(self.inner).__name__}.{method}"
        t0 = clock.perf_counter()
        try:
            return fn(ctx)
        finally:
            self.tracer.add(name, t0, clock.perf_counter() - t0,
                            cat="hook", tid=self.tid,
                            iteration=ctx.iteration)

    def on_start(self, ctx): return self._call("on_start", ctx)

    def before_step(self, ctx): return self._call("before_step", ctx)

    def after_step(self, ctx): return self._call("after_step", ctx)

    def on_exit(self, ctx): return self._call("on_exit", ctx)


def wrap_hooks(tracer: Tracer | None, hooks: Sequence[ExecHook],
               tid: int = 0) -> tuple[ExecHook, ...]:
    """Wrap each hook so its method calls appear as spans; identity when
    tracing is off."""
    if tracer is None or not tracer.enabled:
        return tuple(hooks)
    return tuple(_WrappedHook(h, tracer, tid=tid) for h in hooks)


# ---------------------------------------------------------------------------
# phase-level profiling: run an engine as its composable phases.
# ---------------------------------------------------------------------------

#: phases counted as communication when computing the local-compute
#: fraction; everything else in a superstep is compute.
COMM_PHASES = ("exchange", "delivery")


@dataclasses.dataclass
class SuperstepRecord:
    """One profiled superstep / global iteration."""

    superstep: int
    barriers: int                     # global synchronizations (always 1)
    exchange_bytes: int               # bytes this superstep's exchange moved
    phase_seconds: dict[str, float]   # phase name -> wall seconds
    pseudo_supersteps: int            # summed over partitions, this step
    net_messages: int
    net_local_messages: int
    mem_messages: int

    @property
    def total_seconds(self) -> float:
        return sum(self.phase_seconds.values())

    @property
    def local_compute_fraction(self) -> float:
        """Fraction of this superstep's wall time spent computing (global
        apply + local phase) rather than exchanging/delivering."""
        total = self.total_seconds
        if total <= 0.0:
            return 0.0
        comm = sum(v for k, v in self.phase_seconds.items()
                   if k in COMM_PHASES)
        return (total - comm) / total


@dataclasses.dataclass
class PhasedRunResult:
    engine: str
    es: Any
    iterations: int
    records: list[SuperstepRecord]

    @property
    def total_barriers(self) -> int:
        return sum(r.barriers for r in self.records)

    @property
    def total_exchange_bytes(self) -> int:
        return sum(r.exchange_bytes for r in self.records)

    @property
    def mean_local_compute_fraction(self) -> float:
        if not self.records:
            return 0.0
        return sum(r.local_compute_fraction for r in self.records) \
            / len(self.records)


def _phase_fns(graph, prog, vdata, engine: str, use_ell: bool,
               collect_metrics: bool, max_local_steps: int, wire_dtype
               ) -> list[tuple[str, Callable]]:
    from repro_torch.exec import iteration as it

    if engine == "bsp":
        return [
            ("exchange", lambda es: it.exchange_phase(graph, prog, es)),
            ("delivery", lambda es: it.bsp_delivery(
                graph, prog, es, use_ell, collect_metrics)),
            ("compute", lambda es: it.bsp_compute(graph, prog, es, vdata)),
        ]
    if engine == "hybrid":
        return [
            ("exchange", lambda es: it.exchange_phase(
                graph, prog, es, wire_dtype=wire_dtype)),
            ("delivery", lambda es: it.hybrid_remote_delivery(
                graph, prog, es, use_ell, collect_metrics)),
            ("global", lambda es: it.hybrid_global_phase(
                graph, prog, es, vdata, use_ell, collect_metrics)),
            ("local", lambda es: it.hybrid_local(
                graph, prog, es, vdata, max_local_steps, use_ell,
                collect_metrics)),
        ]
    raise ValueError(f"phased profiling supports engines 'bsp' and "
                     f"'hybrid', not {engine!r}")


def phased_run(graph, prog, engine: str = "hybrid", vdata: Any = None, *,
               tracer: Tracer | None = None, tid: int = 0,
               use_ell: bool = True, collect_metrics: bool = True,
               max_iters: int = 100_000, max_local_steps: int = 100_000,
               wire_dtype=None) -> PhasedRunResult:
    """Run ``engine`` to quiescence with each superstep decomposed into
    its phase functions, each timed to the card's completion.

    The phases compose to exactly the engine's step body
    (:mod:`repro_torch.exec.iteration` builds the step from the same
    functions), so the final state and every counter are bit-identical to
    ``run_bsp`` / ``run_hybrid`` — only the synchronization between phases
    costs extra.  Returns a :class:`PhasedRunResult`; with ``tracer`` the
    same data lands as per-phase + per-superstep spans.  The graph's
    device is the run's.  ``wire_dtype`` quantizes the hybrid exchange
    (:func:`repro_torch.core.runtime.exchange`).
    """
    from repro_torch.core.runtime import quiescent
    from repro_torch.exec.device_loop import graph_cache
    from repro_torch.exec.policy import make_policy
    from repro_torch.exec.syncs import host_read

    knobs = dict(use_ell=use_ell, collect_metrics=collect_metrics)
    if engine == "hybrid":
        knobs["max_local_steps"] = max_local_steps
    policy = make_policy(engine, **knobs)
    phases = _phase_fns(graph, prog, vdata, engine, use_ell,
                        collect_metrics, max_local_steps, wire_dtype)

    es = policy.init(graph, prog, vdata)
    records: list[SuperstepRecord] = []
    step = 0
    graphs: dict = {}       # the run's local-phase graph, built once
    while step < max_iters and not host_read(quiescent(prog, es)):
        step += 1
        xb = exchange_bytes(graph, es, wire_dtype)
        before = _counters_host(es.counters)
        secs: dict[str, float] = {}
        t_start = clock.perf_counter()
        for name, fn in phases:
            t0 = clock.perf_counter()
            with graph_cache(graphs):
                es = fn(es)
            _wait(es.send)
            secs[name] = clock.perf_counter() - t0
            if tracer is not None:
                tracer.add(f"{engine}.{name}", t0, secs[name], cat="phase",
                           tid=tid, superstep=step)
        deltas = _counter_deltas(before, _counters_host(es.counters))
        rec = SuperstepRecord(
            superstep=step, barriers=1, exchange_bytes=xb,
            phase_seconds=secs, pseudo_supersteps=deltas["pseudo_supersteps"],
            net_messages=deltas["net_messages"],
            net_local_messages=deltas["net_local_messages"],
            mem_messages=deltas["mem_messages"])
        records.append(rec)
        if tracer is not None:
            tracer.add(f"{engine}.superstep", t_start,
                       clock.perf_counter() - t_start, cat="superstep",
                       tid=tid, superstep=step, exchange_bytes=xb,
                       barriers=1,
                       local_compute_fraction=rec.local_compute_fraction,
                       **deltas)
    return PhasedRunResult(engine=engine, es=es, iterations=step,
                           records=records)


def traced_dist_step(step: Callable, tracer: Tracer, group=None,
                     tid: int = 0, wire_dtype=None) -> Callable:
    """Wrap a distributed step ``(graph, es) -> es`` (one rank's block)
    with span recording: rank 0 records one ``dist_step`` span per global
    iteration whose args carry each rank's exchange bytes, halo slots and
    pseudo-supersteps (``*_per_block``, rank order), gathered from every
    rank as one small integer vector.  The span closes after
    ``torch.cuda.synchronize``.  Used by
    :func:`repro_torch.core.distributed.make_dist_hybrid_step` when a
    tracer is passed; every rank must wrap its step, since the gather is
    a collective."""
    import torch.distributed as dist

    from repro_torch.core.distributed import all_gather_rows

    def wrapped(graph, es):
        if not tracer.enabled:
            return step(graph, es)
        xb = int(exchange_bytes_per_partition(graph, es, wire_dtype).sum())
        halo = int(halo_slots_per_partition(graph).sum())
        before = _counters_host(es.counters)
        t0 = clock.perf_counter()
        es = step(graph, es)
        _wait(es.send)
        dur = clock.perf_counter() - t0
        after = _counters_host(es.counters)
        pseudo = int((after["pseudo_supersteps"]
                      - before["pseudo_supersteps"]).sum())
        mine = torch.tensor([[xb, halo, pseudo]], dtype=torch.int64,
                            device=es.send.device)
        per = all_gather_rows(mine, group).cpu().numpy()    # (world, 3)
        if dist.get_rank(group) == 0:
            tracer.add(
                "dist_step", t0, dur, cat="superstep", tid=tid,
                iteration=after["iterations"],
                exchange_bytes=int(per[:, 0].sum()),
                exchange_bytes_per_block=per[:, 0].tolist(),
                halo_slots_per_block=per[:, 1].tolist(),
                pseudo_supersteps_per_block=per[:, 2].tolist(),
                net_messages=after["net_messages"] - before["net_messages"])
        return es

    return wrapped
