"""Graph-query serving: micro-batched K-lane execution of graph queries.

A :class:`ServeEngine` loads a partitioned graph once (a built
:class:`~repro_torch.core.graph.PartitionedGraph` or a ``.ghp`` shard
directory, built straight onto the engine's device) and serves point
queries against it — "distance from vertex s", "rank around seed s",
"what does s reach".  Queries are micro-batched: requests for the same
program are grouped, padded to a fixed lane width K, and dispatched as ONE
K-lane engine run over the semiring kernels with an (N, K) frontier
(:mod:`repro_torch.core.apps.multi`), so K queries cost one graph
traversal.

Dispatch cache: one entry per (program, K) holds the lane program,
constructed with ``lanes=K`` and *no* sources, and its per-lane
``changed`` function.  Sources arrive per dispatch as a ``(K,)`` int32
tensor through ``vdata={"sources": ...}``, so one entry serves every
source set; padding the batch up to the nearest width in ``lane_widths``
keeps the set of entries fixed.  ``trace_counts`` counts the entries
built per (program, K) — the reference counts its ``jax.jit`` traces
there; the port has no jit.

Two dispatch modes:

* :meth:`run` — drain the queue; each batch is one device-resident run to
  quiescence (:func:`repro_torch.exec.driver.while_engine`: on the card
  one CUDA graph whose WHILE node iterates the hybrid step, built once per
  (program, K) entry and drain and replayed, after the batch's sources
  are copied in, by the drain's next batches of that entry; one host read
  at the end), or, with a checkpoint
  directory, a host-stepped run with the checkpoint hook.  Straggler
  handling reuses :class:`repro_torch.ft.straggler.StragglerMitigator`:
  every batch is issued against a deadline, overdue batches are
  re-dispatched to the next replica slot, and duplicate completions are
  suppressed (first result wins by work id).
* :meth:`stream` — yields each query as soon as ITS lane converges, while
  the rest of the batch keeps iterating.  A lane whose state is unchanged
  across one full global iteration is at its fixed point: any delivery
  that could still change it would have changed it during that iteration,
  and unchanged lanes emit only ⊕-identity payloads (per-lane send
  masking), so nothing new is in flight for them.

:meth:`stream` and the checkpointed runs' lane hook compare a step's
state with the state before it, which relies on the port's steps never
writing a state tensor in place (pinned by the CPU tests).  The
lane-convergence masks and ``quiescent`` flags are host reads counted by
:mod:`repro_torch.exec.syncs`.

The port of ``repro.serve.engine``.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import shutil
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.core.apps.multi import (MultiSourceMonotone,
                                         PersonalizedPageRank, reachable)
from repro_torch.core.graph import PartitionedGraph, unpack_vertex
from repro_torch.core.runtime import build_ell_plans, quiescent
from repro_torch.device import check_graph_device
from repro_torch.exec.checkpoint import (CheckpointHook, checkpoint_key,
                                         drop_converged_lanes,
                                         require_monotone)
from repro_torch.exec.device_loop import graph_cache
from repro_torch.exec.driver import (ExecContext, ExecHook, run_engine,
                                     while_engine)
from repro_torch.exec.policy import hybrid_policy
from repro_torch.exec.syncs import host_read, host_read_int, host_read_mask
from repro_torch.ft.straggler import StragglerMitigator
from repro_torch.obs import clock as obs_clock
from repro_torch.obs.metrics import MetricsRegistry, save_registry

__all__ = ["Query", "ResumeEvent", "PROGRAMS", "ServeEngine",
           "STATS_FILENAME"]

#: filename of the persisted serving-statistics registry (see
#: :attr:`ServeEngine.stats_path`); read it back with
#: :func:`repro_torch.obs.metrics.load_registry`.
STATS_FILENAME = "serve_stats.json"


@dataclasses.dataclass
class Query:
    """One graph query: run ``program`` from ``source``.

    ``payload`` carries program parameters (e.g. ``tolerance`` for ppr);
    queries batch together only when program AND payload match, so every
    lane of a dispatch runs the same program instance.
    """

    request_id: int
    program: str
    source: int
    payload: dict = dataclasses.field(default_factory=dict)
    result: np.ndarray | None = None
    done: bool = False
    iterations: int | None = None

    @property
    def key(self):
        return (self.program, tuple(sorted(self.payload.items())))


@dataclasses.dataclass(frozen=True)
class ResumeEvent:
    """One killed batch picked back up from its durable checkpoint."""

    program: str
    lanes: int
    sources_digest: str
    path: str                      # checkpoint directory restored from
    iteration: int                 # global iteration the batch resumed at
    lanes_done: tuple[bool, ...]   # converged lanes dropped from the frontier


@dataclasses.dataclass(frozen=True)
class _ProgramSpec:
    factory: Callable          # (lanes, payload) -> VertexProgram
    state_key: str             # es.state entry holding the (P, Vp, L) result
    post: Callable = staticmethod(lambda col: col)


#: program registry: name -> how to build the K-lane program and read back
#: one lane of its fixed point.  All factories take ``lanes=K`` and no
#: sources — sources come in per dispatch through vdata (see the module
#: docstring).
PROGRAMS: dict[str, _ProgramSpec] = {
    "sssp": _ProgramSpec(
        lambda lanes, p: MultiSourceMonotone(lanes=lanes, semiring="min_add",
                                             **p), "val"),
    "widest": _ProgramSpec(
        lambda lanes, p: MultiSourceMonotone(lanes=lanes, semiring="max_min",
                                             **p), "val"),
    "reach": _ProgramSpec(
        lambda lanes, p: MultiSourceMonotone(lanes=lanes, semiring="min_add",
                                             **p), "val",
        lambda col: np.asarray(reachable(col))),
    "ppr": _ProgramSpec(
        lambda lanes, p: PersonalizedPageRank(lanes=lanes, **p), "rank"),
}


@dataclasses.dataclass(frozen=True)
class _LaneProgram:
    """One dispatch-cache entry: a (program, K) lane program, its per-lane
    convergence test, and the ``vdata`` its device-resident dispatches
    read, whose (K,) ``sources`` each batch overwrites in place (so the
    entry's loop graph serves every batch)."""

    prog: Any
    changed: Callable          # (prev state, state) -> (K,) bool tensor
    vdata: dict


class _LaneHook(ExecHook):
    """Per-lane convergence tracking for one checkpointed K-lane dispatch.

    ``done[j]`` goes (and stays) True once lane j's state is unchanged
    across one full global iteration — the same fixed-point criterion
    :meth:`ServeEngine.stream` yields on.  The mask rides every
    checkpoint's meta (via the :class:`CheckpointHook`'s ``meta_fn``); on
    resume it comes back from the manifest and the converged lanes are
    dropped from the restored frontier before the first step.
    """

    def __init__(self, engine: "ServeEngine", program: str, K: int,
                 changed: Callable):
        self.engine = engine
        self.program = program
        self.K = K
        self.changed = changed
        self.ckpt: CheckpointHook | None = None   # wired by the dispatcher
        self.done = np.zeros((K,), bool)
        self._prev = None
        self._resume_checked = False

    def before_step(self, ctx: ExecContext) -> None:
        if not self._resume_checked:
            self._resume_checked = True
            if self.ckpt is not None and self.ckpt.resumed_from is not None:
                meta = self.ckpt.restore_manifest() or {}
                self.done = np.asarray(
                    meta.get("lanes_done", self.done), bool)
                ctx.es = drop_converged_lanes(ctx.prog, ctx.es, self.done)
                self.engine.resume_events.append(ResumeEvent(
                    program=self.program, lanes=self.K,
                    sources_digest=self.ckpt.key.get("sources_digest", ""),
                    path=self.ckpt.resumed_from, iteration=ctx.iteration,
                    lanes_done=tuple(bool(b) for b in self.done)))
        self._prev = ctx.es.state

    def after_step(self, ctx: ExecContext) -> None:
        self.done = np.logical_or(
            self.done, ~host_read_mask(self.changed(self._prev,
                                                    ctx.es.state)))
        if self.engine.on_iteration is not None:
            self.engine.on_iteration(self.engine, self.program, self.K,
                                     ctx.iteration)


class ServeEngine:
    """Serve graph queries against one resident partitioned graph.

    Parameters
    ----------
    graph:
        A built :class:`PartitionedGraph` on ``device``, or a path to a
        ``.ghp`` shard directory (built once onto ``device`` via
        :func:`repro_torch.io.pipeline.build_partitioned_graph_from_path`,
        with ``build_kwargs``).
    lane_widths:
        The fixed micro-batch widths.  A batch of b queries is padded up
        to the smallest width >= b (larger groups split at the maximum
        width); the dispatch cache holds at most
        ``len(PROGRAMS) * len(lane_widths)`` entries.
    use_ell / max_iters:
        Forwarded to the hybrid engine per dispatch.
    straggler / dispatch_fn:
        Deadline re-dispatch state machine and an injectable dispatch
        hook ``(engine, key, K, sources, attempt) -> EngineState | None``
        (None = this attempt produced nothing before the deadline; tests
        drive this with a fake clock).
    ckpt_dir / checkpoint_every / keep:
        When ``ckpt_dir`` is set, :meth:`run` dispatches every batch
        through the checkpointing executor: the batch's state is saved
        every ``checkpoint_every`` global iterations under
        ``ckpt_dir/<program>_K<K>_<sources-digest>`` (keyed to the
        ``(program, K, sources-digest)`` tuple), a killed batch resumes
        from its latest durable checkpoint instead of recomputing (with
        already-converged lanes dropped from the restored frontier — see
        :func:`~repro_torch.exec.checkpoint.drop_converged_lanes`), and the
        batch's checkpoint family is deleted once it completes.  Monotone
        programs only (the shared executor gate); resumes are recorded in
        ``resume_events``.  Every such batch computes the graph's content
        digest for its checkpoint key.
    on_iteration:
        Optional callback ``(engine, program, K, iteration)`` invoked
        after every global iteration of a checkpointed dispatch — tests
        kill a batch mid-flight by raising from it.
    registry / stats_dir:
        The engine keeps per-program serving statistics in a
        :class:`~repro_torch.obs.metrics.MetricsRegistry` (own one by
        default, pass one to share): request inter-arrival gap and
        dispatched batch-size histograms
        (``serve.arrival_seconds.<program>``,
        ``serve.batch_size.<program>``), plus dispatch-cache builds per
        (program, K).  With ``stats_dir`` set (default: ``ckpt_dir``) the
        registry is persisted to ``<stats_dir>/serve_stats.json`` after
        every :meth:`run` / :meth:`stream` drain; read it back with
        :func:`repro_torch.obs.metrics.load_registry`.
    device:
        Where the graph lives and the queries run: ``cuda`` unless
        ``"cpu"`` is passed.

    Raises:
        RuntimeError: CUDA asked for (the default) and absent.
        ValueError: a built graph lives on another device.
    """

    def __init__(self, graph: PartitionedGraph | str, *,
                 lane_widths: tuple[int, ...] = (1, 4, 16, 64),
                 use_ell: bool = True, max_iters: int = 10_000,
                 straggler: StragglerMitigator | None = None,
                 dispatch_fn: Callable | None = None,
                 build_kwargs: dict | None = None,
                 ckpt_dir: str | None = None, checkpoint_every: int = 1,
                 keep: int = 3, on_iteration: Callable | None = None,
                 registry: MetricsRegistry | None = None,
                 stats_dir: str | None = None,
                 device: str | torch.device | None = None):
        if isinstance(graph, str):
            from repro_torch.io.pipeline import \
                build_partitioned_graph_from_path
            graph = build_partitioned_graph_from_path(
                graph, device=device, **(build_kwargs or {}))
        check_graph_device(graph, device)
        if use_ell:
            build_ell_plans(graph)    # before any capture reads them
        self.graph = graph
        self.lane_widths = tuple(sorted(lane_widths))
        self.use_ell = use_ell
        self.max_iters = max_iters
        self.straggler = straggler or StragglerMitigator()
        self._dispatch_fn = dispatch_fn
        self.ckpt_dir = ckpt_dir
        self.checkpoint_every = checkpoint_every
        self.keep = keep
        self.on_iteration = on_iteration
        self.resume_events: list[ResumeEvent] = []
        self._policy = hybrid_policy(use_ell=use_ell, collect_metrics=False)
        self.queue: list[Query] = []
        self._ids = itertools.count()        # monotonic: ids never collide
        self._work_ids = itertools.count()
        self._lanes: dict[tuple, _LaneProgram] = {}   # (key, K) -> entry
        # (key, K) -> its loop graphs: the last entry's, within one drain
        self._graphs: dict = {}
        self.trace_counts: dict[tuple, int] = {}   # entries built per (key, K)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.stats_dir = stats_dir if stats_dir is not None else ckpt_dir
        self._last_arrival: dict[str, float] = {}

    @property
    def stats_path(self) -> str | None:
        """Where the serving-statistics registry persists (None when no
        ``stats_dir``/``ckpt_dir`` was configured)."""
        if self.stats_dir is None:
            return None
        return os.path.join(self.stats_dir, STATS_FILENAME)

    def _persist_stats(self) -> None:
        from repro_torch.obs.metrics import record_serve

        record_serve(self.registry, self)
        if self.stats_path is not None:
            save_registry(self.registry, self.stats_path)

    # -- admission ---------------------------------------------------------

    def submit(self, program: str, source: int, **payload) -> Query:
        """Enqueue one query; returns its (pending) :class:`Query`."""
        if program not in PROGRAMS:
            raise KeyError(f"unknown program {program!r}; have "
                           f"{sorted(PROGRAMS)}")
        q = Query(next(self._ids), program, int(source), payload)
        now = obs_clock.monotonic()
        last = self._last_arrival.get(program)
        if last is not None:
            self.registry.observe(f"serve.arrival_seconds.{program}",
                                  now - last, unit="s")
        self._last_arrival[program] = now
        self.queue.append(q)
        return q

    # -- batching ----------------------------------------------------------

    def _take_batches(self) -> list[tuple[tuple, list[Query]]]:
        """Drain the queue into (key, queries) chunks of <= max lane width,
        grouping same-program same-payload queries (submit order kept
        within a group)."""
        groups: dict[tuple, list[Query]] = {}
        for q in self.queue:
            groups.setdefault(q.key, []).append(q)
        self.queue = []
        wmax = self.lane_widths[-1]
        batches = [(key, qs[i:i + wmax])
                   for key, qs in groups.items()
                   for i in range(0, len(qs), wmax)]
        for key, qs in batches:
            self.registry.observe(f"serve.batch_size.{key[0]}", len(qs),
                                  unit="queries")
        return batches

    def _pad_width(self, b: int) -> int:
        for w in self.lane_widths:
            if w >= b:
                return w
        return self.lane_widths[-1]

    def _sources(self, queries: list[Query], K: int) -> torch.Tensor:
        src = [q.source for q in queries]
        src += [src[-1]] * (K - len(src))    # pad lanes repeat a real source
        return torch.tensor(src, dtype=torch.int32, device=self.graph.device)

    # -- dispatch cache ----------------------------------------------------

    def _lane_program(self, key: tuple, K: int) -> _LaneProgram:
        """The (program, K) cache entry, built (and counted) on first
        use."""
        ck = (key, K)
        if ck not in self._lanes:
            self.trace_counts[ck] = self.trace_counts.get(ck, 0) + 1
            name, payload = key
            prog = PROGRAMS[name].factory(K, dict(payload))
            device = self.graph.device

            def changed(prev, state):
                ch = torch.zeros((K,), dtype=torch.bool, device=device)
                for name in state:
                    ch = torch.logical_or(ch, torch.any(
                        (state[name] != prev[name]).reshape(-1, K), dim=0))
                return ch

            sources = torch.zeros((K,), dtype=torch.int32, device=device)
            self._lanes[ck] = _LaneProgram(prog, changed,
                                           {"sources": sources})
        return self._lanes[ck]

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, key: tuple, K: int, sources, attempt: int):
        """One K-lane run to quiescence on the device (or the injected
        dispatch hook), as the reference's jitted ``while_engine``."""
        if self._dispatch_fn is not None:
            return self._dispatch_fn(self, key, K, sources, attempt)
        ck = (key, K)
        if ck not in self._graphs:
            # the last entry's graphs only: a graph keeps its buffers and
            # its memory pool on the card for as long as it is kept
            self._graphs = {ck: {}}
        lp = self._lane_program(key, K)
        graph, policy, prog, vdata = self.graph, self._policy, lp.prog, \
            lp.vdata
        vdata["sources"].copy_(sources)
        es = policy.init(graph, prog, vdata)
        with graph_cache(self._graphs[ck]):
            return while_engine(prog,
                                lambda e: policy.step(graph, prog, e, vdata),
                                es, self.max_iters)

    def _dispatch_checkpointed(self, key: tuple, K: int, sources):
        """One batch through the checkpointing executor: host-stepped with
        a :class:`CheckpointHook` keyed to (program, K, sources-digest),
        resuming from the latest durable checkpoint when one exists and
        deleting the batch's checkpoint family once it completes."""
        lp = self._lane_program(key, K)
        prog = lp.prog
        require_monotone(prog, "K-lane resume")
        name = key[0]
        vdata = {"sources": sources}
        ckey = checkpoint_key(self.graph, prog, vdata)
        bdir = os.path.join(self.ckpt_dir,
                            f"{name}_K{K}_{ckey['sources_digest']}")
        es0 = self._policy.init(self.graph, prog, vdata)
        lane = _LaneHook(self, name, K, lp.changed)
        ckpt = CheckpointHook(
            key=ckey, ckpt_dir=bdir, every=self.checkpoint_every,
            keep=self.keep, template=es0,
            meta_fn=lambda _ctx: {"lanes_done": [bool(b)
                                                 for b in lane.done]})
        lane.ckpt = ckpt
        killed = True
        try:
            ctx = run_engine(self.graph, prog, self._policy, vdata,
                             max_iters=self.max_iters, hooks=(lane, ckpt),
                             es=es0, jit_step=lambda e: self._policy.step(
                                 self.graph, prog, e, vdata))
            killed = False
        finally:
            if killed:    # queued saves become durable for the resume
                try:
                    ckpt.checkpointer.wait()
                finally:
                    ckpt.checkpointer.close()
        shutil.rmtree(bdir, ignore_errors=True)   # completed: drop family
        return ctx.es

    def _dispatch_mitigated(self, key: tuple, K: int, sources):
        """One batch through the straggler state machine: issue against the
        deadline, re-dispatch to the next replica slot while overdue,
        first completion wins."""
        wid = next(self._work_ids)
        self.straggler.issue(wid, replica=0)
        attempt = 0
        while True:
            es = self._dispatch(key, K, sources, attempt)
            if es is not None and self.straggler.complete(wid):
                return es
            overdue = [w for w in self.straggler.overdue()
                       if w.work_id == wid]
            if es is None and not overdue:
                raise RuntimeError(
                    f"dispatch produced no result for work {wid} and the "
                    f"deadline ({self.straggler.deadline:.3f}s) has not "
                    f"passed — nothing to re-dispatch")
            attempt += 1

    def _finish(self, queries: list[Query], lanes: np.ndarray, iters: int):
        spec = PROGRAMS[queries[0].program]
        for j, q in enumerate(queries):
            q.result = spec.post(lanes[:, j])
            q.iterations = iters
            q.done = True

    # -- serving -----------------------------------------------------------

    def run(self) -> list[Query]:
        """Serve everything in the queue; returns the completed queries
        (each batch = one K-lane run to quiescence)."""
        done: list[Query] = []
        try:
            for key, queries in self._take_batches():
                K = self._pad_width(len(queries))
                sources = self._sources(queries, K)
                if self.ckpt_dir is not None:
                    es = self._dispatch_checkpointed(key, K, sources)
                else:
                    es = self._dispatch_mitigated(key, K, sources)
                spec = PROGRAMS[queries[0].program]
                lanes = unpack_vertex(self.graph, es.state[spec.state_key])
                self._finish(queries, lanes,
                             host_read_int(es.counters.iterations))
                done.extend(queries)
        finally:
            self._graphs = {}    # the drain's graphs leave the card with it
        self._persist_stats()
        return done

    def stream(self) -> Iterator[Query]:
        """Serve the queue host-stepped, yielding each query as soon as its
        lane converges (state unchanged across one full iteration — see
        the module docstring for why that is the lane's fixed point)."""
        for key, queries in self._take_batches():
            K = self._pad_width(len(queries))
            sources = self._sources(queries, K)
            lp = self._lane_program(key, K)
            spec = PROGRAMS[queries[0].program]
            vdata = {"sources": sources}
            es = self._policy.init(self.graph, lp.prog, vdata)
            pending = {j: q for j, q in enumerate(queries)}
            it = 0
            graphs: dict = {}    # the batch's local-phase graph, built once
            while pending and it < self.max_iters:
                prev = es.state
                with graph_cache(graphs):
                    es = self._policy.step(self.graph, lp.prog, es, vdata)
                it += 1
                if host_read(quiescent(lp.prog, es)):
                    lane_done = np.ones((K,), bool)
                else:
                    lane_done = ~host_read_mask(lp.changed(prev, es.state))
                if not any(lane_done[j] for j in pending):
                    continue
                lanes = unpack_vertex(self.graph, es.state[spec.state_key])
                for j in [j for j in pending if lane_done[j]]:
                    q = pending.pop(j)
                    q.result = spec.post(lanes[:, j])
                    q.iterations = it
                    q.done = True
                    yield q
            if pending:          # max_iters safety valve: flush as-is
                lanes = unpack_vertex(self.graph, es.state[spec.state_key])
                for j, q in sorted(pending.items()):
                    q.result = spec.post(lanes[:, j])
                    q.iterations = it
                    q.done = True
                    yield q
        self._persist_stats()
