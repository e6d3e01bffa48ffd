"""Checkpointing as an executor hook.

One :class:`CheckpointHook` serves every run path: the fault-tolerant
driver (`run_hybrid_ft`), the K-lane serving layer (`ServeEngine`), and
anything else built on :func:`repro_torch.exec.driver.run_engine`.  Checkpoints
are keyed by :func:`checkpoint_key` — graph content digest + program name,
extended with ``(lanes, sources_digest)`` for K-lane programs so a killed
multi-query batch can only resume into the identical (program, K, sources)
dispatch — and validated by :func:`validate_key` on restore.

:func:`require_monotone` is the single engine gate shared by every path
that re-enters a computation with less than the full saved message state
(elastic restore's re-announce, the K-lane frontier drop): only monotone
(min/max-combiner) programs absorb re-delivered or dropped values without
moving their fixed point.

A port of ``repro.exec.checkpoint``: the same keys (the port's
``graph_digest`` equals the reference's on the same graph) and the same
gates, over the port's hook protocol (``repro_torch.exec.driver``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, CheckpointError,
                                   checkpoint_bytes, latest_checkpoint,
                                   load_checkpoint, read_manifest)
from repro_torch.core.runtime import EngineState
from repro_torch.exec.driver import ExecContext, ExecHook

__all__ = ["checkpoint_key", "validate_key", "require_monotone",
           "drop_converged_lanes", "CheckpointHook"]


def checkpoint_key(graph, prog, vdata: Any = None) -> dict:
    """What a checkpoint is keyed to.

    Always: the graph content digest (the same ``io.digest.graph_digest``
    the ingest benchmark pins builder identity with) + the program's class
    name.  A graph never changes once built (its ELL block plans rely on
    that too), so its digest is computed once per graph object and kept in
    ``graph.__dict__``, which no copy carries.  K-lane programs
    additionally pin ``lanes`` and the ``sources_digest`` of their (K,)
    sources/seeds (static or via ``vdata={"sources": ...}``) — one
    checkpoint family per (program, K, sources) dispatch, so a resumed
    batch can never restore another batch's state.
    """
    from repro_torch.core.apps.multi import sources_digest
    from repro_torch.io.digest import graph_digest

    digest = graph.__dict__.get("_digest")
    if digest is None:
        digest = graph.__dict__["_digest"] = graph_digest(graph)
    key = {"graph_digest": digest, "program": type(prog).__name__}
    lanes = max((int(getattr(ch, "lanes", 0) or 0) for ch in prog.channels),
                default=0)
    if lanes:
        key["lanes"] = lanes
        src = None
        if vdata is not None and "sources" in vdata:
            src = vdata["sources"]
        else:
            src = getattr(prog, "sources", None)
            if src is None:
                src = getattr(prog, "seeds", None)
        if src is not None:
            key["sources_digest"] = sources_digest(src)
    return key


def validate_key(meta: dict, key: dict, path: str) -> None:
    """Refuse to restore a checkpoint whose meta disagrees with ``key`` on
    any keyed field (graph digest, program, lanes, sources digest)."""
    for k, want in key.items():
        if meta.get(k) != want:
            raise CheckpointError(
                f"{path}: checkpoint is keyed to {k}={meta.get(k)!r}, this "
                f"run has {want!r} — refusing to restore state from a "
                f"different graph/program")


def require_monotone(prog, what: str) -> None:
    """The one engine gate for partial-state re-entry (elastic restore,
    K-lane frontier drop): monotone (min/max-combiner) programs only."""
    bad = [ch.name for ch in prog.channels if ch.combiner not in
           ("min", "max")]
    if bad:
        raise CheckpointError(
            f"{what} re-announces every vertex's current value on the next "
            f"exchange, which only monotone (min/max-combiner) programs "
            f"absorb; channels {bad} do not qualify")


def drop_converged_lanes(prog, es: EngineState, done) -> EngineState:
    """Exclude already-converged lanes from a restored frontier.

    ``done`` is the (L,) per-lane convergence mask saved with the
    checkpoint (a lane whose state was unchanged across one full iteration
    is at its fixed point).  Done lanes' pending payloads and export
    values are reset to the channel's ⊕-identity, so on resume they emit
    nothing: the bootstrap combine is an identity, per-lane send gating
    stays off, and no message rides the next exchange for them.  Callers
    must have passed :func:`require_monotone` — for monotone channels a
    dropped re-delivery can only re-confirm the fixed point, so per-lane
    results stay bit-identical to the uninterrupted run.
    """
    done = torch.as_tensor(done, dtype=torch.bool, device=es.send.device)

    def ident_where(x, ident):
        return torch.where(done, torch.tensor(ident, dtype=x.dtype,
                                              device=x.device), x)

    pending = dict(es.pending)
    export_out = dict(es.export_out)
    for ch in prog.channels:
        if not getattr(ch, "lanes", 0):
            continue
        comps, has = pending[ch.name]
        comps = tuple(ident_where(c, ident)
                      for c, (_, ident) in zip(comps, ch.components))
        pending[ch.name] = (comps, has)
        _, ident = ch.components[0]
        export_out[ch.name] = ident_where(export_out[ch.name], ident)
    return dataclasses.replace(es, pending=pending, export_out=export_out)


class CheckpointHook(ExecHook):
    """Executor hook: resume on start, checkpoint every N iterations,
    flush on exit.

    ``meta_fn(ctx) -> dict`` extends each checkpoint's meta (the serving
    layer records its per-lane convergence mask here); ``restore()`` is
    public so a failure-recovery hook can roll the run back to the latest
    durable checkpoint mid-loop.

    ``placement`` (a :class:`repro_torch.core.distributed.BlockPlacement`,
    where the reference's hook has ``shardings``) runs the hook on one
    rank's block: at a save every rank joins one gather of the global
    state onto the writer rank, which alone holds and writes it — the
    bytes a single-process run would write — and every rank restores the
    global checkpoint and takes its own block out of it.
    """

    def __init__(self, *, key: dict, ckpt_dir: str | None = None,
                 checkpointer: AsyncCheckpointer | None = None,
                 every: int = 1, keep: int = 3, resume: bool = True,
                 template: EngineState | None = None,
                 placement: Any = None,
                 meta_fn: Callable[[ExecContext], dict] | None = None):
        self.key = dict(key)
        writes = placement is None or placement.writer
        self._own = checkpointer is None and ckpt_dir is not None and writes
        self.checkpointer = (AsyncCheckpointer(ckpt_dir, keep=keep)
                             if self._own else
                             checkpointer if writes else None)
        self.base = ckpt_dir if ckpt_dir is not None else getattr(
            checkpointer, "base", None)
        self.every = every
        self.resume = resume
        self.template = template
        self.placement = placement
        self.meta_fn = meta_fn
        self.resumed_from: str | None = None

    # -- restore -----------------------------------------------------------

    def restore(self) -> tuple[EngineState, int, str | None, int]:
        """(state, iteration, path, bytes_read) from the latest durable
        checkpoint, or ``(template, 0, None, 0)`` when none exists."""
        if self.checkpointer is not None:
            self.checkpointer.wait()   # in-flight writes become durable
        if self.placement is not None:
            self.placement.barrier()   # ... on the writer rank, for all
        path = latest_checkpoint(self.base) if self.base else None
        if path is None:
            return self.template, 0, None, 0
        validate_key(read_manifest(path).get("meta", {}), self.key, path)
        if self.placement is None:
            es, step = load_checkpoint(path, self.template)
        else:
            es, step = load_checkpoint(
                path, self.placement.like(self.template), device="cpu")
            es = self.placement.take(es)
        return es, int(step), path, checkpoint_bytes(path)

    def restore_manifest(self) -> dict | None:
        """Meta of the latest durable checkpoint (lane masks etc.), or
        None when no checkpoint exists."""
        path = latest_checkpoint(self.base) if self.base else None
        return None if path is None else read_manifest(path).get("meta", {})

    # -- hook protocol -----------------------------------------------------

    def on_start(self, ctx: ExecContext) -> None:
        if self.template is None:
            self.template = ctx.es
        if self.resume and self.base is not None:
            es, it, path, _ = self.restore()
            if path is not None:
                ctx.es, ctx.iteration = es, it
                self.resumed_from = path

    def after_step(self, ctx: ExecContext) -> None:
        if self.base is None or ctx.iteration % self.every:
            return
        es = ctx.es
        if self.placement is not None:    # every rank joins; the writer
            es = self.placement.gather(es)          # alone gets the state
        if self.checkpointer is not None:
            meta = {**self.key, "iteration": ctx.iteration}
            if self.meta_fn is not None:
                meta.update(self.meta_fn(ctx))
            self.checkpointer.save(ctx.iteration, es, meta=meta)

    def on_exit(self, ctx: ExecContext) -> None:
        if self.checkpointer is not None:
            self.checkpointer.wait()
            if self._own:
                self.checkpointer.close()
