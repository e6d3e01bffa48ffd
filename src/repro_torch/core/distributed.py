"""Distributed GraphHP execution: one block of partitions per rank over
``torch.distributed``, the port of ``repro.core.distributed``.

This is the paper's architecture.  Each rank owns one contiguous block of
partitions, as one ``shard_map`` device does in the reference, and
iterates pseudo-supersteps on it to its own partitions' quiescence: no
collective runs inside that local loop, which runs on the rank's device
(a WHILE node of a CUDA graph on the card,
:mod:`repro_torch.exec.device_loop`).  The outer loop stays host-driven:
its quiescence check is read on the host.  The only communication of a
global iteration is one all-gather of the export tables (the exchange),
plus one all-reduce of the iteration's counter deltas onto the
replicated totals (the master's aggregation); the driver's quiescence
check is one more all-reduce (:func:`dist_quiescent`, the master polling
its workers).

A rank's block (:func:`block_view`, :func:`block_state`) slices every
tensor leaf on dim 0 — vertex families by partition, edge families and
ELL tiles by block row — and keeps the static sizes global
(``n_partitions``, ``n_vertices``, ``vp``, ``hp``, ...), as inside
``shard_map``.  The runtime reads a block's own partition count off its
leading sizes, and :func:`block_view` gives each ELL slice flat views
re-offset to block-local strides (``runtime.block_flat``), so each rank
runs the same three CUDA kernels on block-local views, in the same fold
order: the ranks' result is bit-identical to the single-process run.

The wire: every collective moves raw bytes (``.view(torch.uint8)`` of
contiguous leaves, packed into one buffer per call), so one path carries
every dtype on gloo and NCCL alike — gloo refuses ``uint16`` and
``int16`` tensors, which a ``bfloat16`` carrier or a genuine ``uint16``
payload would need.  The backend and device are the caller's choice:

* ``nccl`` — rank ``r`` on ``cuda:r``; refused when the host has fewer
  cards than ranks (``gpu``-marked tests cover it: they need a card per
  rank, and the CPU tests use gloo alone);
* ``gloo`` with CUDA tensors — several ranks may share one card; each
  collective stages its bytes through pinned host buffers (counted in
  ``COMM["staged_bytes"]``);
* ``gloo`` with CPU tensors — the CPU tests.

:func:`spawn_ranks` starts the ranks (``spawn`` processes, a ``FileStore``
rendezvous in a temporary directory, a wall-clock deadline after which
every rank is killed); :func:`run_dist_hybrid` runs a program to
quiescence on them and returns the gathered global state.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import tempfile
import time
import traceback
from functools import partial
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.checkpoint.ckpt import _flatten_with_names, _unflatten
from repro_torch.core.graph import EllSlice, PartitionedGraph
from repro_torch.core.runtime import (Counters, EngineState, block_flat,
                                      build_ell_plans, quiescent)
from repro_torch.core.vertex_program import VertexProgram
from repro_torch.device import resolve_device
from repro_torch.exec.driver import run_engine
from repro_torch.exec.iteration import hybrid_iteration, init_hybrid
from repro_torch.exec.policy import EnginePolicy
from repro_torch.exec.syncs import host_read

__all__ = ["BACKENDS", "COMM", "reset_comm", "check_world", "block_view",
           "block_state", "gather_state", "all_gather_rows", "dist_init",
           "dist_quiescent", "make_dist_hybrid_step", "DistHybridStep",
           "BlockPlacement", "block_graph_shapes", "engine_state_shapes",
           "spawn_ranks", "run_dist_hybrid", "DistRunResult"]

BACKENDS = ("gloo", "nccl")

#: This process's collectives: how many, the bytes they gathered or
#: reduced, and the bytes staged through host memory (gloo with CUDA
#: tensors: device -> pinned host and back).
COMM = {"collectives": 0, "wire_bytes": 0, "staged_bytes": 0}


def reset_comm() -> None:
    for k in COMM:
        COMM[k] = 0


# ---------------------------------------------------------------------------
# trees: EngineState / PartitionedGraph / dicts / tuples of tensors, walked
# as the checkpoints walk them (static dataclass fields skipped, dict keys
# sorted: the same order on every rank)
# ---------------------------------------------------------------------------

def _tree_leaves(tree) -> list:
    return [leaf for _, leaf in _flatten_with_names(tree)]


def _map_tree(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """``fn`` over every tensor leaf; other leaves pass through."""
    return _unflatten(tree, iter(
        fn(l) if isinstance(l, torch.Tensor) else l
        for l in _tree_leaves(tree)))


def _tree_to(tree, device):
    return _map_tree(lambda t: t.to(device), tree)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def check_world(graph: PartitionedGraph, world: int) -> None:
    """The reference's divisibility rule: one block of whole partitions
    and whole edge blocks per rank."""
    if graph.n_partitions % world or graph.n_blocks % world:
        raise ValueError(
            f"distributed step needs n_partitions ({graph.n_partitions})"
            f" and n_blocks ({graph.n_blocks}) divisible by the device "
            f"count ({world}); build with edge_blocks={world} (or a "
            f"multiple)")


def _cut(rank: int, world: int, device):
    """Rank ``rank``'s rows of a partition-major leaf, on ``device``;
    0-dim leaves (the replicated counters) whole."""
    def cut(t: torch.Tensor) -> torch.Tensor:
        if t.dim() == 0:
            return t.to(device)
        n = t.shape[0] // world
        return t[rank * n:(rank + 1) * n].to(device)
    return cut


def block_view(graph: PartitionedGraph, rank: int, world: int,
               device=None) -> PartitionedGraph:
    """Rank ``rank``'s block of ``graph`` on ``device`` (``cuda`` unless
    ``"cpu"`` is passed): every tensor leaf sliced on dim 0 — the vertex
    and halo families by partition, the edge families and every
    ``EllSlice`` tile by block row — and the static fields kept global, as
    ``shard_map`` shards the reference's graph.  The slices are taken on
    ``graph``'s device before the copy, so a host graph is never copied
    to the card whole.

    Each ``EllSlice``'s flat views are the block's own
    (:func:`~repro_torch.core.runtime.block_flat`, computed on ``device``
    from the block's tiles), not copies of the global ones: those hold
    global offsets, which no block reads."""
    check_world(graph, world)
    cut = _cut(rank, world, resolve_device(device))
    if world == 1:
        return _map_tree(cut, graph)
    none = torch.empty((0,), dtype=torch.int32)
    bare = lambda ells: tuple(dataclasses.replace(
        s, flat_rows=none, flat_idx=none) for s in ells)
    bg = _map_tree(cut, dataclasses.replace(
        graph, local_ell=bare(graph.local_ell),
        remote_ell=bare(graph.remote_ell)))
    p = graph.n_partitions // world
    own = lambda ells: tuple(dataclasses.replace(
        s, **dict(zip(("flat_rows", "flat_idx"), block_flat(s, graph.vp, p))))
        for s in ells)
    bg = dataclasses.replace(bg, local_ell=own(bg.local_ell),
                             remote_ell=own(bg.remote_ell))
    bg.__dict__["_block_local"] = True       # read by runtime.slice_flat
    return bg


def block_state(es, rank: int, world: int, device=None):
    """Rank ``rank``'s block of a global engine state (or of any tree of
    partition-major tensors, such as ``vdata``): every leaf sliced on dim
    0, ``pseudo_supersteps`` included; the 0-dim counters replicated."""
    return _map_tree(_cut(rank, world, resolve_device(device)), es)


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def _staged(t: torch.Tensor, group) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _gather_bytes(buf: torch.Tensor, group, dst: int | None):
    """(n,) uint8 on every rank -> (world, n) uint8, rank order, on the
    device of ``buf``: on every rank (``dst`` None, one all-gather), or on
    rank ``dst`` of ``group`` alone (one gather; None on the others)."""
    world = dist.get_world_size(group)
    n = buf.numel()
    here = dst is None or dist.get_rank(group) == dst
    COMM["collectives"] += 1
    COMM["wire_bytes"] += world * n
    staged = _staged(buf, group)
    src = buf
    if staged:
        src = torch.empty((n,), dtype=torch.uint8, pin_memory=True)
        src.copy_(buf)
        COMM["staged_bytes"] += n + (world * n if here else 0)
    out = (torch.empty((world * n,), dtype=torch.uint8, device=src.device,
                       pin_memory=staged) if here else None)
    if dst is None:
        # the name both torch 2.11 and 2.13 have (2.13 forwards it to
        # ``all_gather_single``, which 2.11 lacks, with a FutureWarning)
        dist.all_gather_into_tensor(out, src, group=group)
    else:
        dist.gather(src, list(out.chunk(world)) if here else None,
                    dst=dist.get_global_rank(group or dist.group.WORLD, dst),
                    group=group)
    return None if out is None else out.to(buf.device).reshape(world, n)


def _gather_rows(tree, group, dst: int | None):
    leaves = _tree_leaves(tree)
    parts = [l.contiguous().reshape(-1).view(torch.uint8) for l in leaves]
    out = _gather_bytes(torch.cat(parts), group, dst)
    if out is None:
        return None
    world, res, off = out.shape[0], [], 0
    for l, p in zip(leaves, parts):
        # a fresh buffer: the view as ``l.dtype`` needs aligned rows
        chunk = torch.empty((world, p.numel()), dtype=torch.uint8,
                            device=out.device)
        chunk.copy_(out[:, off:off + p.numel()])
        res.append(chunk.view(l.dtype).reshape(
            (world * l.shape[0],) + tuple(l.shape[1:])))
        off += p.numel()
    return _unflatten(tree, iter(res))


def all_gather_rows(tree, group=None):
    """Every tensor leaf ``(n, ...)`` of ``tree`` gathered along dim 0 in
    rank order, ``(world * n, ...)`` — one collective for the whole tree,
    its leaves packed as raw bytes, so every dtype (bool, uint16,
    bfloat16, float8) takes the same path on every backend.  Every rank
    passes leaves of the same shapes and dtypes."""
    return _gather_rows(tree, group, None)


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of an int64 vector over the ranks (a fresh tensor)."""
    COMM["collectives"] += 1
    COMM["wire_bytes"] += t.numel() * t.element_size()
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        COMM["staged_bytes"] += 2 * host.numel() * host.element_size()
        return host.to(t.device)
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


def gather_state(es_block: EngineState, group=None) -> EngineState | None:
    """The global engine state rebuilt from every rank's block (the 0-dim
    counters are replicated and kept) on rank 0 of ``group`` alone, on
    its block's device — for checks and checkpoints; None on every other
    rank.  Every rank calls it (one gather)."""
    parts = [l for l in _tree_leaves(es_block) if l.dim() > 0]
    gathered = _gather_rows(parts, group, 0)
    if gathered is None:
        return None
    gathered = iter(gathered)
    return _map_tree(lambda t: t if t.dim() == 0 else next(gathered),
                     es_block)


_MSG_FIELDS = ("net_messages", "net_local_messages", "mem_messages")


def _reduce_counters(c0: Counters, c: Counters, group) -> Counters:
    """Replicated totals: ``c0`` plus every rank's delta ``c - c0`` of the
    three message counters, in one all-reduce."""
    delta = torch.stack([getattr(c, f) - getattr(c0, f)
                         for f in _MSG_FIELDS])
    tot = _all_reduce_sum(delta, group)
    return dataclasses.replace(c, **{f: getattr(c0, f) + tot[i]
                                     for i, f in enumerate(_MSG_FIELDS)})


def dist_init(graph: PartitionedGraph, prog: VertexProgram, vdata: Any,
              group=None, use_ell: bool = True,
              collect_metrics: bool = True) -> EngineState:
    """Initialization on this rank's block: ``init_hybrid`` on the block
    view (init delivers along local edges only, so the result is this
    rank's block of the global init), then one all-reduce of the init
    counters onto replicated totals."""
    es = init_hybrid(graph, prog, vdata, use_ell=use_ell,
                     collect_metrics=collect_metrics)
    c0 = Counters.zeros(es.send.shape[0], es.send.device)
    return dataclasses.replace(
        es, counters=_reduce_counters(c0, es.counters, group))


def dist_quiescent(prog: VertexProgram, es_block: EngineState,
                   group=None) -> bool:
    """The master's termination check: this block's ``quiescent``, then
    one all-reduce over the ranks (one host read)."""
    busy = torch.logical_not(quiescent(prog, es_block)).to(torch.int64)
    return host_read(_all_reduce_sum(busy.reshape(1), group)[0] == 0)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

class DistHybridStep:
    """One global iteration of GraphHP on this rank's block,
    ``step(graph, es) -> es`` (see :func:`make_dist_hybrid_step`), with
    the two other parts of a run that need the ranks: :meth:`init` and
    :meth:`quiescent`.  :meth:`policy` packs all three for
    :func:`repro_torch.exec.driver.run_engine`; ``placement`` (a
    :class:`BlockPlacement`, or None) is where this rank's state lives,
    for :func:`repro_torch.ft.run_hybrid_ft`."""

    def __init__(self, prog: VertexProgram, group=None, vdata: Any = None,
                 max_local_steps: int = 10_000, wire_dtype=None,
                 use_ell: bool = True, collect_metrics: bool = True,
                 tracer=None, placement: "BlockPlacement | None" = None):
        self.prog, self.group, self.vdata = prog, group, vdata
        self.placement = placement
        self.use_ell, self.collect_metrics = use_ell, collect_metrics
        self._kw = dict(gather_table=partial(all_gather_rows, group=group),
                        max_local_steps=max_local_steps,
                        wire_dtype=wire_dtype, use_ell=use_ell,
                        collect_metrics=collect_metrics)
        self._step = self._local_step
        if tracer is not None:
            from repro_torch.obs.trace import traced_dist_step  # opt-in
            self._step = traced_dist_step(self._local_step, tracer, group,
                                          wire_dtype=wire_dtype)

    def _local_step(self, graph: PartitionedGraph,
                    es: EngineState) -> EngineState:
        world = dist.get_world_size(self.group)
        check_world(graph, world)
        if graph.vertex_gid.shape[0] * world != graph.n_partitions:
            raise ValueError(
                f"the step takes this rank's block (block_view): "
                f"{graph.vertex_gid.shape[0]} of {graph.n_partitions} "
                f"partitions on {world} ranks")
        c0 = es.counters          # replicated totals from last iteration
        es = hybrid_iteration(graph, self.prog, es, self.vdata, **self._kw)
        return dataclasses.replace(
            es, counters=_reduce_counters(c0, es.counters, self.group))

    def __call__(self, graph: PartitionedGraph,
                 es: EngineState) -> EngineState:
        return self._step(graph, es)

    def init(self, graph: PartitionedGraph, vdata: Any = None) -> EngineState:
        if self.use_ell:
            build_ell_plans(graph)    # before any capture reads them
        return dist_init(graph, self.prog,
                         self.vdata if vdata is None else vdata, self.group,
                         use_ell=self.use_ell,
                         collect_metrics=self.collect_metrics)

    def quiescent(self, prog: VertexProgram, es: EngineState) -> bool:
        return dist_quiescent(prog, es, self.group)

    def policy(self) -> EnginePolicy:
        return EnginePolicy(
            name="dist_hybrid", init=lambda g, p, v: self.init(g, v),
            step=lambda g, p, e, v: self(g, e), halt=self.quiescent)


def make_dist_hybrid_step(prog: VertexProgram, group=None, vdata: Any = None,
                          max_local_steps: int = 10_000, wire_dtype=None,
                          use_ell: bool = True, collect_metrics: bool = True,
                          tracer=None,
                          placement: "BlockPlacement | None" = None
                          ) -> DistHybridStep:
    """The distributed hybrid step for this rank: ``step(graph, es) ->
    es`` runs one global iteration on the rank's block (``graph`` from
    :func:`block_view`, ``es`` a block state from :meth:`~DistHybridStep.
    init` or :func:`block_state`).

    ``group`` is the ``torch.distributed`` process group (default: the
    world) and takes the place of the reference's ``mesh, axes``.  Per
    global iteration: ``hybrid_iteration`` on the block with the
    all-gather of the export tables as its ``gather_table`` (the one
    exchange), then one all-reduce of this iteration's deltas of
    ``net_messages``, ``net_local_messages`` and ``mem_messages`` onto
    the replicated totals.  ``wire_dtype`` (``torch.bfloat16`` or a
    float8) quantizes the exchange's float payloads; ``use_ell`` /
    ``collect_metrics`` as on the single-process engines.  ``vdata`` is
    this rank's block of the program's per-vertex data.

    ``tracer`` (a :class:`repro_torch.obs.trace.Tracer`) wraps the step
    with :func:`repro_torch.obs.trace.traced_dist_step`: rank 0 records
    one ``dist_step`` span per global iteration.  ``placement`` (a
    :class:`BlockPlacement` over the same group) lets
    :func:`repro_torch.ft.run_hybrid_ft` checkpoint and restore the
    rank's block as ``step_fn``.

    Raises (when called): ``ValueError`` if the world does not divide
    ``n_partitions`` and ``n_blocks``, as the reference does.
    """
    return DistHybridStep(prog, group, vdata, max_local_steps, wire_dtype,
                          use_ell, collect_metrics, tracer, placement)


@dataclasses.dataclass(frozen=True)
class BlockPlacement:
    """Where a rank's engine state lives, for
    :func:`repro_torch.ft.run_hybrid_ft` (carried by the distributed step,
    in place of the reference's ``es_shardings``): ``gather`` rebuilds
    the global state from every rank's block on the writer rank alone (a
    collective; None on the other ranks), ``take`` cuts this rank's block
    out of a restored global state onto its device.  ``graph`` is the
    global graph the checkpoints are keyed to (the host copy the ranks
    were given), ``writer`` whether this rank writes them; ``barrier``
    holds the ranks until the writer's checkpoints are durable.
    ``gather`` / ``all_gather`` take any tree of partition-major
    tensors."""

    rank: int
    world: int
    group: Any
    device: torch.device
    graph: PartitionedGraph

    @property
    def writer(self) -> bool:
        return self.rank == 0

    def gather(self, es_block: EngineState) -> EngineState | None:
        es = gather_state(es_block, self.group)
        return None if es is None else _tree_to(es, "cpu")

    def all_gather(self, tree):
        """``tree`` gathered on every rank, on the host."""
        return _tree_to(all_gather_rows(tree, self.group), "cpu")

    def take(self, es: EngineState) -> EngineState:
        return block_state(es, self.rank, self.world, self.device)

    def like(self, es_block: EngineState) -> EngineState:
        """A ``meta`` stand-in of the global state, to restore into."""
        return _map_tree(lambda t: torch.empty(
            t.shape if t.dim() == 0 else
            (t.shape[0] * self.world,) + tuple(t.shape[1:]),
            dtype=t.dtype, device="meta"), es_block)

    def barrier(self) -> None:
        COMM["collectives"] += 1
        dist.barrier(group=self.group)


# ---------------------------------------------------------------------------
# dry-run shapes
# ---------------------------------------------------------------------------

def block_graph_shapes(n_partitions: int, vp: int, ep: int, xp: int, hp: int,
                       gp: int | None = None, kl: int = 0,
                       n_blocks: int | None = None) -> PartitionedGraph:
    """Stand-in graph of ``meta`` tensors (no allocation), the reference's
    shapes and dtypes.  ``kl`` > 0 adds one dense-base ELL bin of that
    slice width per side; ``ep`` / ``gp`` are per-block widths of the
    block-ragged edge layout; ``n_blocks`` defaults to one block per
    partition."""
    gp = gp or vp
    nb = n_partitions if n_blocks is None else n_blocks
    if n_partitions % nb:
        raise ValueError(f"n_blocks={nb} must divide "
                         f"n_partitions={n_partitions}")
    ppb = n_partitions // nb
    i32, f32, b = torch.int32, torch.float32, torch.bool

    def f(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def ell(stride):
        if kl == 0:
            return ()
        return (EllSlice(
            rows=f((nb, ppb * vp), i32),
            idx=f((nb, ppb * vp, kl), i32),
            val=f((nb, ppb * vp, kl), f32),
            msk=f((nb, ppb * vp, kl), b),
            grp=f((nb, ppb * vp, kl), i32),
            flat_rows=f((n_partitions * vp,), i32),
            flat_idx=f((n_partitions * vp, kl), i32),
            nb=ppb * vp, kb=kl, lo=0, dense=True, stride=stride,
            payload_bound=n_partitions * vp - 1),)

    return PartitionedGraph(
        vertex_gid=f((n_partitions, vp), i32),
        vertex_mask=f((n_partitions, vp), b),
        is_boundary=f((n_partitions, vp), b),
        out_degree=f((n_partitions, vp), i32),
        edge_src=f((nb, ep), i32),
        edge_dst=f((nb, ep), i32),
        edge_w=f((nb, ep), f32),
        edge_mask=f((nb, ep), b),
        edge_local=f((nb, ep), b),
        edge_src_gid=f((nb, ep), i32),
        edge_dst_gid=f((nb, ep), i32),
        edge_part=f((nb, ep), i32),
        edge_group=f((nb, ep), i32),
        group_remote=f((nb, gp), b),
        group_mask=f((nb, gp), b),
        export_slot=f((n_partitions, xp), i32),
        export_mask=f((n_partitions, xp), b),
        export_fanout=f((n_partitions, xp), i32),
        halo_ptr=f((n_partitions, hp), i32),
        halo_mask=f((n_partitions, hp), b),
        local_ell=ell(vp), remote_ell=ell(vp + hp),
        n_partitions=n_partitions, n_vertices=n_partitions * vp,
        n_edges=n_partitions * ep, vp=vp, ep=ep, xp=xp, hp=hp, gp=gp,
        n_blocks=nb, ep_by_p=(ep // ppb,) * n_partitions,
        gp_by_p=(gp // ppb,) * n_partitions)


def engine_state_shapes(prog: VertexProgram, graph: PartitionedGraph,
                        value_dtype=torch.float32) -> EngineState:
    """Stand-in ``EngineState`` of ``meta`` tensors for SSSP-like
    single-value apps.  The counters are the port's int64 (the
    reference's are int32)."""
    p, vp, hp = graph.n_partitions, graph.vp, graph.hp

    def f(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    val = {"dist": f((p, vp), value_dtype)}
    halo = {"dist": f((p, hp), value_dtype)}
    pend = {ch.name: (tuple(f((p, vp), dt) for dt, _ in ch.components),
                      f((p, vp), torch.bool))
            for ch in prog.channels}
    i64 = torch.int64
    return EngineState(
        state=val, out=dict(val), send=f((p, vp), torch.bool),
        active=f((p, vp), torch.bool),
        export_out=dict(val), export_send=f((p, vp), torch.bool),
        pending=pend, halo_out=halo, halo_send=f((p, hp), torch.bool),
        counters=Counters(
            iterations=f((), i64), pseudo_supersteps=f((p,), i64),
            net_messages=f((), i64), net_local_messages=f((), i64),
            mem_messages=f((), i64)))


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def _rank_entry(rank: int, world: int, backend: str, device: str,
                store_path: str, out_dir: str, fn: Callable, args: tuple,
                timeout_s: float, threads: int | None) -> None:
    """A spawned rank: join the group, run ``fn``, save its result; on
    any failure write the traceback beside it (before leaving the group,
    so a failing rank's file predates its peers') and exit non-zero."""
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(f"cuda:{rank}" if backend == "nccl" else device)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(rank, world, dist.group.WORLD, dev, *args)
        tmp = os.path.join(out_dir, f"result_{rank}.pt.tmp")
        torch.save(out, tmp)
        os.replace(tmp, os.path.join(out_dir, f"result_{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


#: Seconds the other ranks get to go down after one fails, so that the
#: error names every failed rank.
_GRACE_S = 5.0


def spawn_ranks(fn: Callable, world: int, backend: str, device: str,
                args: tuple = (), *, deadline_s: float = 600.0,
                threads: int | None = None) -> list:
    """Run ``fn(rank, world, group, device, *args)`` on ``world`` ranks,
    each a process of the ``spawn`` start method, and return their
    results in rank order (``fn`` and ``args`` are pickled: ``fn`` a
    module-level function; CPU tensors in ``args`` reach the ranks through
    shared memory, not copies).

    ``backend`` is ``"gloo"`` or ``"nccl"`` and ``device`` the ranks'
    device, both the caller's choice: ``nccl`` puts rank ``r`` on
    ``cuda:r`` and needs ``device="cuda"`` and a card per rank; ``gloo``
    puts every rank on ``device`` (``"cpu"``, or one card shared).  The
    ranks meet through a ``FileStore`` in a fresh temporary directory
    (no port), with ``deadline_s`` as the process group's timeout too.
    ``threads`` sets each rank's ``torch.set_num_threads``.

    Raises:
        ValueError: an unknown backend, or NCCL on a device other than
            ``cuda`` or with fewer cards than ranks.
        RuntimeError: a rank failed (its traceback is in the message);
            every other rank is killed.
        TimeoutError: ``deadline_s`` passed with a rank still running;
            every rank is killed.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if backend == "nccl":
        if torch.device(device).type != "cuda":
            raise ValueError("nccl runs rank r on cuda:r: pass "
                             "device='cuda'")
        if torch.cuda.device_count() < world:
            raise ValueError(
                f"nccl needs one card per rank: {world} ranks, "
                f"{torch.cuda.device_count()} cards (ranks sharing a card "
                f"take backend='gloo')")
    else:
        resolve_device(device)
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    procs = []
    try:
        for r in range(world):
            p = ctx.Process(target=_rank_entry, daemon=True, args=(
                r, world, backend, str(device), os.path.join(tmp, "store"),
                tmp, fn, args, deadline_s, threads))
            p.start()
            procs.append(p)
        end = time.monotonic() + deadline_s
        while any(p.exitcode is None for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                grace = time.monotonic() + _GRACE_S
                while (any(p.exitcode is None for p in procs)
                       and time.monotonic() < grace):
                    time.sleep(0.05)
                _raise_failed(procs, tmp)
            if time.monotonic() > end:
                raise TimeoutError(
                    f"{world} ranks still running after {deadline_s} s")
            time.sleep(0.05)
        _raise_failed(procs, tmp)
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
    finally:
        for p in procs:
            if p.exitcode is None:
                p.kill()
        for p in procs:
            p.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)


def _raise_failed(procs, tmp: str) -> None:
    """Raise with the traceback of every rank that exited non-zero, the
    first to fail first (a rank that dies takes its peers' collectives
    down after it)."""
    bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
    if not bad:
        return
    path = lambda r: os.path.join(tmp, f"error_{r}.txt")
    first = lambda r: (os.stat(path(r)).st_mtime_ns
                       if os.path.exists(path(r)) else float("inf"))
    msgs = []
    for r in sorted(bad, key=first):
        text = "(no traceback: the process was killed)"
        if os.path.exists(path(r)):
            with open(path(r)) as f:
                text = f.read()
        msgs.append(f"rank {r} failed (exit code {procs[r].exitcode}):\n"
                    + text)
    raise RuntimeError("\n".join(msgs))


# ---------------------------------------------------------------------------
# a whole run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistRunResult:
    """A distributed run: the gathered global state (on the host), the
    global iterations, and each rank's own numbers (``ranks[r]``:
    ``seconds`` of the run, ``block_s`` to cut and copy its block,
    ``pseudo_supersteps`` of its block, ``host_syncs``,
    ``launches``, ``comm`` (:data:`COMM`), ``peak_device_bytes``), and,
    for a traced run, rank 0's spans.  ``share_s``: seconds to move the
    host graph into shared memory (nothing when it already is)."""

    es: EngineState
    iterations: int
    ranks: list[dict]
    share_s: float
    spans: list | None = None


def _hybrid_rank(rank, world, group, device, graph, prog, vdata, knobs,
                 trace):
    """One rank of :func:`run_dist_hybrid`."""
    from repro_torch.exec.syncs import host_reads, reset_host_reads
    from repro_torch.kernels.common import LAUNCHES, reset_launches

    tracer = None
    if trace:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer()
    t0 = time.perf_counter()
    bg = block_view(graph, rank, world, device)
    bvdata = block_state(vdata, rank, world, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    block_s = time.perf_counter() - t0
    knobs = dict(knobs)
    max_iters = knobs.pop("max_iters")
    step = make_dist_hybrid_step(prog, group, vdata=bvdata, tracer=tracer,
                                 **knobs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    dist.barrier(group=group)
    reset_launches()
    reset_host_reads()
    reset_comm()
    t0 = time.perf_counter()
    ctx = run_engine(bg, prog, step.policy(), bvdata, max_iters=max_iters)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    stats = dict(seconds=secs, block_s=block_s, host_syncs=host_reads(),
                 launches=dict(LAUNCHES), comm=dict(COMM),
                 pseudo_supersteps=ctx.es.counters.pseudo_supersteps.cpu(),
                 peak_device_bytes=(torch.cuda.max_memory_allocated(device)
                                    if device.type == "cuda" else 0))
    es = gather_state(ctx.es, group)
    return dict(stats, iterations=ctx.iteration,
                es=None if es is None else _tree_to(es, "cpu"),
                spans=tracer.spans if tracer is not None and rank == 0
                else None)


def run_dist_hybrid(graph: PartitionedGraph, prog: VertexProgram, world: int,
                    *, backend: str, device: str, vdata: Any = None,
                    max_iters: int = 100_000, max_local_steps: int = 100_000,
                    wire_dtype=None, use_ell: bool = True, trace: bool = False,
                    deadline_s: float = 3600.0,
                    threads: int | None = None) -> DistRunResult:
    """Run ``prog`` to quiescence on ``world`` ranks, each on its block of
    the host graph ``graph`` (:func:`spawn_ranks` with ``backend`` and
    ``device``; ``vdata`` is sliced like the graph).  Each rank builds its
    block view, runs :meth:`DistHybridStep.init` and then
    :func:`~repro_torch.exec.driver.run_engine` with the distributed step
    and :func:`dist_quiescent` as the halt rule; rank 0 returns the
    gathered global state.  ``trace`` records the ``dist_step`` spans.

    Raises:
        ValueError: the world does not divide the graph's partitions and
            edge blocks (before any rank starts), or as
            :func:`spawn_ranks`.
    """
    check_world(graph, world)
    if graph.device.type != "cpu":
        raise ValueError("run_dist_hybrid takes the host graph; each rank "
                         "copies its own block to the device")
    knobs = dict(max_iters=max_iters, max_local_steps=max_local_steps,
                 wire_dtype=wire_dtype, use_ell=use_ell)
    t0 = time.perf_counter()
    for leaf in _tree_leaves(graph):      # what pickling would do, timed
        leaf.share_memory_()
    share_s = time.perf_counter() - t0
    out = spawn_ranks(_hybrid_rank, world, backend, device,
                      args=(graph, prog, vdata, knobs, trace),
                      deadline_s=deadline_s, threads=threads)
    ranks = [{k: v for k, v in o.items() if k not in ("es", "spans")}
             for o in out]
    return DistRunResult(es=out[0]["es"], iterations=out[0]["iterations"],
                         ranks=ranks, share_s=share_s, spans=out[0]["spans"])
