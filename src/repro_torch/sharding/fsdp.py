"""Sharded parameters gathered at use (FSDP-style), and the collectives of
the sharded paths.

A model whose parameters are DTensors (placed by the rules,
``sharding.util.place``) holds only this rank's shard of each.
:func:`unsharded` gives a view of it that the model code reads as it reads
the model: each access to a parameter gathers the whole tensor from its
shards and drops it after use, so inside the per-unit
``torch.utils.checkpoint`` a unit's weights are gathered for the forward
and again for the recompute, never held across units.  Gradients flow back
through the gather: the whole gradient is summed over the ranks that split
the batch (the ``data`` axis, inside a pod) and each rank keeps its shard.

The residual stream's sequence shards (sequence parallelism,
``sharding.util.seq_axis``) move through :func:`shard_seq` and
:func:`gather_seq`: the ``model`` ranks compute the same values, so a
rank keeps its slice of the sequence between units and gathers the whole
before each; the backward of a gather is a slice (each rank's gradient of
the whole is already the whole gradient), that of a slice a gather.

Every collective here goes through ``repro_torch.core.distributed``'s
byte path, which stages CUDA tensors through pinned host memory when the
group is gloo (the smoke's ranks share one card; NCCL refuses two ranks on
one device) and counts calls and bytes in ``COMM``.  DTensor's own
collectives are never called.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch
import torch.distributed as dist

from repro_torch.sharding.util import (NamedSharding, current_mesh,
                                       local_chunk, seq_axis)

__all__ = ["resolve_group", "all_gather_stack", "all_reduce", "gather_full",
           "data_group", "seq_group", "shard_seq", "gather_seq", "unsharded",
           "is_sharded", "sharding_of", "local_of", "like_placed"]


def resolve_group(axis):
    """A process group, or the group along the named dimension of the
    ambient mesh (``launch.mesh.set_mesh``); None stays None."""
    if axis is None or not isinstance(axis, str):
        return axis
    mesh = current_mesh()
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"axis {axis!r} names no dimension of the ambient "
                         f"mesh ({mesh}): set one with launch.mesh.set_mesh "
                         f"or pass a process group")
    return mesh.get_group(axis)


def all_gather_stack(t: torch.Tensor, group) -> torch.Tensor:
    """``(n, *t.shape)``: every rank's ``t`` in group-rank order (one
    collective, raw bytes)."""
    from repro_torch.core.distributed import all_gather_rows
    return all_gather_rows([t.contiguous()[None]], group=group)[0]


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``op`` of ``t`` over the group (a fresh tensor)."""
    from repro_torch.core.distributed import COMM, _staged
    COMM["collectives"] += 1
    COMM["wire_bytes"] += t.numel() * t.element_size()
    if _staged(t, group):
        host = t.detach().cpu()
        dist.all_reduce(host, op=op, group=group)
        COMM["staged_bytes"] += 2 * host.numel() * host.element_size()
        return host.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def gather_full(local: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The whole tensor from this rank's shard: one all-gather over each
    mesh dimension that shards it, innermost split first (the inverse of
    ``local_chunk``).  Replicated dimensions move nothing."""
    mesh = sharding.mesh
    out = local
    shards = [(i, p.dim) for i, p in enumerate(sharding.placements)
              if p.is_shard()]
    for i, d in reversed(shards):
        g = all_gather_stack(out, mesh.get_group(i))      # (n, ...)
        out = g.movedim(0, d).flatten(d, d + 1)
    return out


def data_group(mesh):
    """The ranks that split a step's batch inside a pod: the ``data``
    dimension's group, or None on a mesh without one."""
    names = mesh.mesh_dim_names or ()
    if "data" not in names or mesh.size(names.index("data")) == 1:
        return None
    return mesh.get_group("data")


def seq_group():
    """The group the residual stream's sequence is sharded over: the
    ambient mesh's ``seq_axis()`` dimension when sequence parallelism is
    on and that dimension has more than one rank; else None (the
    reference's constraint is the identity without such a mesh)."""
    axis, mesh = seq_axis(), current_mesh()
    names = () if mesh is None else (mesh.mesh_dim_names or ())
    if axis is None or axis not in names or \
            mesh.size(names.index(axis)) == 1:
        return None
    return mesh.get_group(axis)


def _pad_seq(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` with zero rows appended on dim 1 up to a multiple of ``n``."""
    pad = -t.shape[1] % n
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)


def _slice_seq(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's slice of ``t``'s dim 1, zero-padded to a multiple of
    the group's size: a copy, so the whole tensor is not kept alive."""
    n = dist.get_world_size(group)
    t = _pad_seq(t, n)
    size = t.shape[1] // n
    return t.narrow(1, dist.get_rank(group) * size, size).clone(
        memory_format=torch.contiguous_format)


def _gather_seq(local: torch.Tensor, group, seq: int) -> torch.Tensor:
    """Every rank's slice side by side on dim 1 (one all-gather), the
    padding cut off at ``seq``."""
    whole = all_gather_stack(local, group).movedim(0, 1).flatten(1, 2)
    return whole.narrow(1, 0, seq).contiguous()


class _ShardSeq(torch.autograd.Function):
    """Forward: this rank's slice of the sequence.  Backward: the whole
    gradient from every rank's slice (one all-gather)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.seq = group, x.shape[1]
        return _slice_seq(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather_seq(grad.contiguous(), ctx.group, ctx.seq), None


class _GatherSeq(torch.autograd.Function):
    """Forward: the whole sequence from every rank's slice (one
    all-gather).  Backward: this rank's slice of the gradient, not a sum
    over the ranks: they repeat the same compute on the gathered stream,
    so each rank's gradient of it is already the whole gradient."""

    @staticmethod
    def forward(ctx, local, group, seq):
        ctx.group = group
        return _gather_seq(local, group, seq)

    @staticmethod
    def backward(ctx, grad):
        return _slice_seq(grad, ctx.group), None, None


def shard_seq(x: torch.Tensor, group) -> torch.Tensor:
    """(B, S, ...) -> this rank's (B, ceil(S / n), ...) slice of the
    sequence over the ``n`` ranks of ``group`` (the last slices padded
    with zeros when ``n`` does not divide S)."""
    return _ShardSeq.apply(x, group)


def gather_seq(local: torch.Tensor, group, seq: int) -> torch.Tensor:
    """The inverse of :func:`shard_seq`: the whole (B, ``seq``, ...)
    stream from every rank's slice, the padding dropped."""
    return _GatherSeq.apply(local, group, seq)


class _Gather(torch.autograd.Function):
    """Forward: the whole parameter from its shard.  Backward: the whole
    gradient summed over the batch-splitting ranks, then this rank's
    shard of it."""

    @staticmethod
    def forward(ctx, local, sharding):
        ctx.sharding = sharding
        return gather_full(local, sharding) if _sharded(sharding) \
            else local.view_as(local)

    @staticmethod
    def backward(ctx, grad):
        group = data_group(ctx.sharding.mesh)
        if group is not None:
            grad = all_reduce(grad.contiguous(), group)
        return local_chunk(grad, ctx.sharding).contiguous(), None


def _sharded(sharding: NamedSharding) -> bool:
    return any(p.is_shard() for p in sharding.placements)


def is_sharded(model) -> bool:
    """Does the model hold DTensor parameters?"""
    from torch.distributed.tensor import DTensor
    return any(isinstance(p, DTensor) for p in model.parameters())


def sharding_of(p) -> NamedSharding:
    """A DTensor's :class:`NamedSharding` (its spec is not kept)."""
    return NamedSharding(p.device_mesh, None, tuple(p.placements))


def local_of(p) -> torch.Tensor:
    """A DTensor's local shard (the tensor itself, no autograd edge), or
    a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return p._local_tensor if isinstance(p, DTensor) else p


def like_placed(local: torch.Tensor, like):
    """``local`` as a DTensor with ``like``'s mesh, placements and global
    shape when ``like`` is a DTensor; else ``local`` as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(like, DTensor):
        return local
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


class _View:
    """A parameter node read through gathers (see :func:`unsharded`)."""

    def __init__(self, node, leaves: Mapping, shardings: Mapping,
                 prefix: str):
        self._node, self._leaves = node, leaves
        self._shardings, self._prefix = shardings, prefix

    def __getitem__(self, key: str):
        name = self._prefix + key
        if name in self._leaves:
            s = self._shardings.get(name)
            leaf = self._leaves[name]
            return leaf if s is None else _Gather.apply(leaf, s)
        child = self._node[key]
        if isinstance(child, torch.nn.ModuleList):
            return [_View(c, self._leaves, self._shardings, f"{name}.{i}.")
                    for i, c in enumerate(child)]
        return _View(child, self._leaves, self._shardings, name + ".")

    def __contains__(self, key: str) -> bool:
        return key in self._node


def unsharded(model, leaves: Mapping | None = None):
    """The model as its code reads it (``p["wq"]``, ``"ffn" in p``), each
    DTensor parameter gathered whole at every access.  ``leaves`` (name ->
    local shard) replaces the parameters' own shards, as a train step's
    differentiable leaves; plain parameters are read as they are.  A model
    with no DTensor parameter is returned as it is."""
    from torch.distributed.tensor import DTensor
    params = dict(model.named_parameters())
    shardings = {k: sharding_of(p) for k, p in params.items()
                 if isinstance(p, DTensor)}
    if not shardings and leaves is None:
        return model
    if leaves is None:
        leaves = {k: local_of(p) for k, p in params.items()}
    return _View(model, leaves, shardings, "")
