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
                                       local_chunk)

__all__ = ["resolve_group", "all_gather_stack", "all_reduce", "gather_full",
           "data_group", "unsharded", "is_sharded", "sharding_of",
           "local_of", "like_placed"]


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
