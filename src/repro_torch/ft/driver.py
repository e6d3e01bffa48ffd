"""Fault-tolerant hybrid driver: superstep checkpointing, failure recovery,
elastic resume (paper §5.3).

GraphHP's local phase runs minutes of pseudo-supersteps between
synchronization points, which amplifies the cost of losing a worker
mid-iteration — so the engine checkpoints ``EngineState`` at
global-iteration boundaries (the only points where the whole computation is
a pure function of vertex state: halo buffers are refilled by the next
exchange, so nothing transient needs saving) through an
:class:`~repro_torch.checkpoint.AsyncCheckpointer` that snapshots to host
and writes off-thread.  Each checkpoint is keyed to the graph content
digest + program name + iteration; resume validates the key and restores
bit-for-bit — a run interrupted after iteration k and resumed produces the
*identical* final state and :class:`~repro_torch.core.runtime.Counters` as
the uninterrupted run.

Failure recovery follows the paper's ping mechanism:
:class:`~repro_torch.ft.heartbeat.HeartbeatMonitor` tracks simulated
workers on an injected logical clock (one tick per global iteration), a
:class:`~repro_torch.ft.inject.FaultInjector` scripts deterministic
kills/delays, and a detected failure triggers ``reassign_failed`` +
restore from the latest durable checkpoint, with the recovery cost
(iterations lost, restore seconds, bytes read) surfaced on the run
result.

Elastic resume (k -> k' partitions, via ``repro_torch.io.resize``)
re-shards the checkpointed vertex state by global vertex id and
re-announces every vertex's current out-value on the first exchange —
safe exactly for monotone-semiring programs (min/max combiners:
re-delivery can only re-confirm the fixed point), which the shared
executor gate
(:func:`repro_torch.exec.checkpoint.require_monotone`) enforces.

This module is configuration only: the loop lives in
:mod:`repro_torch.exec.driver`, checkpoint save/resume in
:class:`repro_torch.exec.checkpoint.CheckpointHook`, and ``run_hybrid_ft``
wires them to a :class:`_FaultHook` driving the heartbeat -> reassign ->
restore cycle between steps.

A port of ``repro.ft.driver``.  Each step is the hybrid policy's step
(there is no jit); the reference's ``step_fn``/``es_shardings`` (the
distributed step) and ``tracer``/``registry`` (observability) are not
ported yet, so straggler flags come from the counters.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, CheckpointError,
                                         _flatten_with_names, _np_dtype,
                                         _tensor, _unflatten,
                                         load_checkpoint_arrays)
from repro_torch.core.runtime import EngineState, deliver
from repro_torch.core.vertex_program import VertexProgram
from repro_torch.device import check_graph_device
from repro_torch.exec.checkpoint import (CheckpointHook, checkpoint_key,
                                         require_monotone)
from repro_torch.exec.driver import ExecContext, ExecHook, run_engine
from repro_torch.exec.iteration import init_hybrid
from repro_torch.exec.policy import hybrid_policy
from repro_torch.ft.elastic import partition_owners, reshard_vertex_tree
from repro_torch.ft.heartbeat import HeartbeatMonitor
from repro_torch.ft.inject import FaultInjector
from repro_torch.ft.straggler import ShardFlag, flag_slow_shards
from repro_torch.obs import clock as obs_clock

__all__ = ["run_hybrid_ft", "RecoveryEvent", "FTRunResult", "checkpoint_key",
           "elastic_restore", "reshard_checkpoint_arrays"]

_PSEUDO = "pseudo_supersteps"
_HALO = ("halo_out", "halo_send")


@dataclasses.dataclass(frozen=True)
class RecoveryEvent:
    """One failure -> reassign -> restore cycle, with its cost."""

    tick: int                     # driver tick at detection
    failed_workers: tuple[int, ...]
    moved: dict[int, list]        # reassignment table (worker -> partitions)
    restored_iteration: int
    iterations_lost: int          # work rolled back to the checkpoint
    restore_seconds: float
    bytes_read: int               # the latest checkpoint only, never a rebuild


@dataclasses.dataclass
class FTRunResult:
    es: EngineState
    iterations: int
    recoveries: list[RecoveryEvent]
    straggler_flags: list[ShardFlag]
    resumed_from: str | None      # checkpoint dir this run started from
    epoch: int                    # monitor reassignment epoch at exit


def reshard_checkpoint_arrays(arrs: dict[str, np.ndarray],
                              old_part: np.ndarray, new_part: np.ndarray,
                              pad_multiple: int = 8) -> dict[str, np.ndarray]:
    """Re-shard one checkpoint's leaves (by manifest name) from the old to
    the new partitioning: vertex-keyed ``(P, Vp, ...)`` families remap by
    global vertex id, halo families drop (derived state — the next exchange
    refills them), per-partition ``pseudo_supersteps`` reset (the counts
    are meaningless across a re-partition), scalars carry over."""
    P_n = int(np.asarray(new_part).max()) + 1 if len(new_part) else 1
    keep = {k: v for k, v in arrs.items()
            if not any(h in k for h in _HALO)}
    out = reshard_vertex_tree(keep, old_part, new_part,
                              pad_multiple=pad_multiple)
    for name in list(out):
        if _PSEUDO in name:
            out[name] = np.zeros((P_n,), dtype=np.asarray(out[name]).dtype)
    return out


def elastic_restore(ckpt_path: str, graph, prog: VertexProgram, vdata: Any,
                    old_part: np.ndarray, new_part: np.ndarray,
                    pad_multiple: int = 8, use_ell: bool = True,
                    collect_metrics: bool = True,
                    expect_digest: str | None = None,
                    device: str | torch.device | None = None
                    ) -> tuple[EngineState, int]:
    """Restore a checkpoint written under ``old_part`` into an engine state
    for ``graph`` built under ``new_part`` (k -> k' elastic resume).

    Returns ``(state, iteration)``.  Monotone-semiring programs only (the
    re-announce on the first exchange re-delivers current values, which
    min/max combiners absorb and a sum combiner would double-count) — the
    gate is the executor's
    :func:`~repro_torch.exec.checkpoint.require_monotone`, shared with the
    serving layer's K-lane resume.  ``device`` must be where ``graph``
    lives (``cuda`` unless ``"cpu"`` is passed)."""
    check_graph_device(graph, device)
    require_monotone(prog, "elastic restore")
    arrs, manifest = load_checkpoint_arrays(ckpt_path)
    meta = manifest.get("meta", {})
    if meta.get("program") not in (None, type(prog).__name__):
        raise CheckpointError(
            f"{ckpt_path}: checkpoint is for program {meta.get('program')!r}"
            f", restoring {type(prog).__name__!r}")
    if expect_digest is not None and meta.get("graph_digest") != expect_digest:
        raise CheckpointError(
            f"{ckpt_path}: graph_digest {meta.get('graph_digest')!r} != "
            f"expected {expect_digest!r}")
    if not meta.get("elastic"):
        arrs = reshard_checkpoint_arrays(arrs, old_part, new_part,
                                         pad_multiple=pad_multiple)
    template = init_hybrid(graph, prog, vdata, use_ell=use_ell,
                           collect_metrics=collect_metrics)
    out = []
    for name, leaf in _flatten_with_names(template):
        if name not in arrs:          # halo families: refilled by exchange
            out.append(leaf)
            continue
        a = arrs[name]
        want = _np_dtype(leaf)        # numpy names on both sides
        if tuple(a.shape) != tuple(leaf.shape) or a.dtype != want:
            raise CheckpointError(
                f"{ckpt_path}: re-sharded leaf {name!r} is {a.dtype}"
                f"{a.shape}, the new graph's state wants {want}"
                f"{tuple(leaf.shape)} (pad_multiple mismatch?)")
        out.append(_tensor(np.ascontiguousarray(a), graph.device))
    es = _unflatten(template, iter(out))
    # re-announce: every valid vertex re-sends its current out-value — via
    # export_send for the next exchange (edges the new cut made remote), and
    # by one immediate local delivery into pending (edges a shrink made
    # local, whose consumers used to be fed by the old cut's exchange; the
    # global apply overwrites `send` before the iteration's local delivery,
    # so a flag alone would be lost — this mirrors ``init_hybrid``).
    # Monotone combiners make the duplicate deliveries to old consumers
    # no-ops.
    es = dataclasses.replace(es, export_out=dict(es.out),
                             export_send=graph.vertex_mask,
                             send=graph.vertex_mask)
    es, _ = deliver(graph, prog, es, edges="local", use_ell=use_ell,
                    collect_metrics=collect_metrics)
    return es, int(manifest["step"])


class _FaultHook(ExecHook):
    """Heartbeat/failure detection between executor steps.

    Each tick advances the injected logical clock, beats the live (or
    injector-scripted) workers, and sweeps the monitor; a detected failure
    reassigns the dead workers' partitions and rolls the run back to the
    latest durable checkpoint via the shared :class:`CheckpointHook`,
    consuming the tick (the step is skipped).  Deterministic by
    construction: no wall-clock enters control flow.
    """

    def __init__(self, monitor: HeartbeatMonitor,
                 injector: FaultInjector | None,
                 ckpt: CheckpointHook, clock: list, tick_seconds: float):
        self.monitor = monitor
        self.injector = injector
        self.ckpt = ckpt
        self.clock = clock
        self.tick_seconds = tick_seconds
        self.recoveries: list[RecoveryEvent] = []

    def before_step(self, ctx: ExecContext) -> bool | None:
        self.clock[0] += self.tick_seconds
        n_workers = len(self.monitor.workers)
        beating = (self.injector.beating(ctx.tick)
                   if self.injector is not None else range(n_workers))
        for w in beating:
            self.monitor.beat(w)
        newly_failed = self.monitor.sweep()
        if not newly_failed:
            return None
        moved = self.monitor.reassign_failed()
        t0 = obs_clock.perf_counter()
        es, rit, _, nbytes = self.ckpt.restore()
        ev = RecoveryEvent(
            tick=ctx.tick, failed_workers=tuple(newly_failed), moved=moved,
            restored_iteration=rit, iterations_lost=ctx.iteration - rit,
            restore_seconds=obs_clock.perf_counter() - t0, bytes_read=nbytes)
        self.recoveries.append(ev)
        ctx.es, ctx.iteration = es, rit
        return False                  # rolled back: skip this tick's step


def run_hybrid_ft(
    graph,
    prog: VertexProgram,
    vdata: Any = None,
    *,
    ckpt_dir: str | None = None,
    checkpointer: AsyncCheckpointer | None = None,
    checkpoint_every: int = 1,
    keep: int = 3,
    resume: bool = True,
    max_iters: int = 100_000,
    max_local_steps: int = 100_000,
    use_ell: bool = True,
    collect_metrics: bool = True,
    n_workers: int = 1,
    monitor: HeartbeatMonitor | None = None,
    injector: FaultInjector | None = None,
    tick_seconds: float = 1.0,
    straggler_factor: float = 1.5,
    balance: float | None = None,
    device: str | torch.device | None = None,
) -> FTRunResult:
    """Run global iterations to quiescence with checkpointing + recovery.

    Each step is one global iteration of the hybrid policy
    (:func:`~repro_torch.exec.iteration.hybrid_iteration`), as in
    :func:`~repro_torch.core.engine_hybrid.run_hybrid`.

    Checkpoints land under ``ckpt_dir`` every ``checkpoint_every`` global
    iterations: the state is copied to the host in the loop's thread and
    written off-thread (:class:`AsyncCheckpointer`), each checkpoint keyed
    to :func:`~repro_torch.exec.checkpoint.checkpoint_key`; ``resume=True``
    restarts from the latest complete checkpoint when one exists (exact
    resume: identical final state and counters to the uninterrupted run).

    Failure detection runs on an injected logical clock: each driver tick
    advances it ``tick_seconds``, live workers heartbeat (all of them, or
    the ones ``injector`` scripts), and a sweep past ``fail_after`` marks a
    worker FAILED — the driver then reassigns its partitions to the
    least-loaded healthy workers and rolls back to the latest checkpoint,
    recording a :class:`RecoveryEvent`.  Deterministic by construction: no
    wall-clock enters control flow.

    Engine knobs (``vdata``, ``max_iters``, ``max_local_steps``,
    ``use_ell``, ``collect_metrics``, ``device``) mean exactly what they
    mean to :func:`~repro_torch.core.engine_hybrid.run_hybrid`: ``device``
    is ``cuda`` unless ``"cpu"`` is passed, and the graph must live there.
    ``straggler_factor`` flags a partition whose pseudo-superstep count
    exceeds that multiple of the median; ``balance`` (the labeling's max
    partition size over the even share) marks the flags as skew.

    Returns:
        An :class:`FTRunResult`: the final ``EngineState`` (``es``) and
        iteration count, every :class:`RecoveryEvent` and straggler
        ``ShardFlag`` observed, ``resumed_from`` (checkpoint dir this run
        restored from, or ``None`` for a cold start) and the monitor's
        final reassignment ``epoch``.

    Raises:
        CheckpointError: a checkpoint under ``ckpt_dir`` is keyed to a
            different graph digest or program than this run — refusing to
            restore mismatched state.
        RuntimeError: CUDA asked for (the default) and absent.
        ValueError: the graph lives on another device.
    """
    check_graph_device(graph, device)
    policy = hybrid_policy(use_ell=use_ell, collect_metrics=collect_metrics,
                           max_local_steps=max_local_steps)
    template = init_hybrid(graph, prog, vdata, use_ell=use_ell,
                           collect_metrics=collect_metrics)
    ckpt = CheckpointHook(key=checkpoint_key(graph, prog, vdata),
                          ckpt_dir=ckpt_dir, checkpointer=checkpointer,
                          every=checkpoint_every, keep=keep, resume=resume,
                          template=template)

    # --- simulated cluster: contiguous partition blocks per worker --------
    P = graph.n_partitions
    clock = [0.0]
    if monitor is None:
        monitor = HeartbeatMonitor(n_workers, suspect_after=1.5 * tick_seconds,
                                   fail_after=2.5 * tick_seconds,
                                   clock=lambda: clock[0])
        for p, w in enumerate(partition_owners(P, n_workers)):
            monitor.assign(int(w), p)
    fault = _FaultHook(monitor, injector, ckpt, clock, tick_seconds)

    ctx = run_engine(graph, prog, policy, vdata, max_iters=max_iters,
                     hooks=(fault, ckpt), es=template)

    pseudo = ctx.es.counters.pseudo_supersteps.cpu().numpy()
    flags = flag_slow_shards(pseudo, balance=balance,
                             factor=straggler_factor)
    return FTRunResult(es=ctx.es, iterations=ctx.iteration,
                       recoveries=fault.recoveries, straggler_flags=flags,
                       resumed_from=ckpt.resumed_from, epoch=monitor.epoch)
