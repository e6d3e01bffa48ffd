"""Spec sanitation and placements (the port of ``repro.sharding.util``).

``sanitize_specs`` drops sharding on axes whose size does not divide the
dimension (e.g. batch=1 long-context decode cannot shard over data=16), so
every shard the port cuts is even: it never relies on DTensor's uneven
chunking.  ``named`` turns specs into DTensor placements on a
``DeviceMesh``; ``place`` / ``local_chunk`` cut a tensor into this rank's
shard with no collective (``DTensor.redistribute`` of CUDA tensors over
gloo crashes the process in torch 2.11, so the port's collectives are its
own, ``repro_torch.sharding.fsdp``).

The ambient mesh (``repro_torch.launch.mesh.set_mesh``) is what
``maybe_constrain`` reads; the batch split (``split_batch``) is how many
ranks a step's batch is spread over, which MoE's block dispatch reads;
the sequence-parallel switch (``seq_parallel`` / ``set_seq_parallel``)
is what ``seq_axis`` reads, and with it the model stack shards its
residual stream over ``model`` between units (``models.stack``).
"""

from __future__ import annotations

import contextlib
import math
from collections.abc import Mapping
from typing import Any, NamedTuple

import torch
from torch import nn

from repro_torch.sharding.rules import (P, PartitionSpec, _map_leaves,
                                        cache_specs, map_specs)

__all__ = ["sanitize_specs", "NamedSharding", "named", "placements_for",
           "axis_sizes", "mesh_coords", "local_chunk", "place", "place_tree",
           "local_tree", "local_nbytes", "maybe_constrain",
           "current_mesh", "use_mesh", "set_seq_parallel", "seq_parallel",
           "seq_axis", "split_batch", "batch_shards", "decode_layout",
           "shard_cache"]

Tree = Any


def axis_sizes(mesh) -> dict[str, int]:
    """Mesh-axis name -> size, of a ``DeviceMesh`` or of any object whose
    ``shape`` maps names to sizes (the reference's ``Mesh`` does)."""
    if isinstance(getattr(mesh, "shape", None), Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(sizes: Mapping, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _shaped(tree):
    return dict(tree.named_parameters()) if isinstance(tree, nn.Module) \
        else tree


def sanitize_specs(specs: Tree, shapes: Tree, mesh) -> Tree:
    """Replace spec entries that don't divide the dimension with None."""
    sizes = axis_sizes(mesh)

    def fix(spec: P, leaf) -> P:
        out = [ax if ax is not None and i < leaf.ndim
               and leaf.shape[i] % _axis_size(sizes, ax) == 0 else None
               for i, ax in enumerate(spec)]
        out += [None] * (leaf.ndim - len(out))
        return P(*out[: leaf.ndim])

    return map_specs(fix, specs, _shaped(shapes))


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

class NamedSharding(NamedTuple):
    """A spec on a mesh, with its DTensor placements (one per mesh
    dimension: ``Shard(d)`` or ``Replicate()``)."""

    mesh: Any
    spec: PartitionSpec
    placements: tuple


def placements_for(spec: PartitionSpec, mesh) -> tuple:
    """Each mesh dimension becomes ``Shard(d)`` on the tensor dimension
    whose spec entry names it, or ``Replicate()``.  A tuple entry shards
    one dimension over several mesh dimensions, in mesh order.  Raises
    ``ValueError`` on a spec that names a mesh axis twice, names one the
    mesh lacks, or lists a tuple out of mesh order: no placements say
    those."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    owner: dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            tuple(entry) if isinstance(entry, (tuple, list)) else (entry,))
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec}: the mesh has no axis {a!r} "
                                 f"(it has {names})")
            if a in owner:
                raise ValueError(f"{spec} names mesh axis {a!r} twice")
            owner[a] = d
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                    for a in axes):
            raise ValueError(f"{spec}: {entry} is not in mesh order {names}")
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in names)


def named(specs: Tree, mesh) -> Tree:
    """A :class:`NamedSharding` per spec of the tree."""
    return map_specs(lambda s: NamedSharding(mesh, s, placements_for(s, mesh)),
                     specs)


def mesh_coords(mesh) -> dict[str, int]:
    """This rank's coordinate along each mesh dimension."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _sharded_dims(sharding: NamedSharding):
    """(mesh-dim index, tensor dim) of every ``Shard`` placement."""
    return [(i, p.dim) for i, p in enumerate(sharding.placements)
            if p.is_shard()]


def local_chunk(t: torch.Tensor, sharding: NamedSharding,
                coords: Mapping | None = None) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` (a view): split along
    each sharded dimension, mesh dimension by mesh dimension."""
    mesh = sharding.mesh
    coords = mesh_coords(mesh) if coords is None else coords
    names = mesh.mesh_dim_names
    for i, d in _sharded_dims(sharding):
        n = mesh.shape[i]
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide "
                             f"over {n} ranks (sanitize the spec)")
        size = t.shape[d] // n
        t = t.narrow(d, coords[names[i]] * size, size)
    return t


def local_nbytes(shape, dtype: torch.dtype, sharding: NamedSharding) -> int:
    """Bytes of one rank's shard of a tensor of ``shape``."""
    n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    sizes = list(axis_sizes(sharding.mesh).values())
    return n // math.prod(sizes[i] for i, _ in _sharded_dims(sharding))


def place(t: torch.Tensor, sharding: NamedSharding, device=None):
    """The whole tensor ``t`` (the same on every rank) as a DTensor holding
    a copy of this rank's shard on ``device`` (default: ``t``'s); no
    collective runs."""
    from torch.distributed.tensor import DTensor
    local = _copy(local_chunk(t, sharding), device)
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=t.shape,
                              stride=_contiguous_stride(t.shape))


def _contiguous_stride(shape) -> tuple:
    out, n = [], 1
    for size in reversed(tuple(shape)):
        out.append(n)
        n *= size
    return tuple(reversed(out))


def place_tree(tree: Tree, shardings: Tree, device=None) -> Tree:
    """:func:`place` over a tree (``shardings`` from :func:`named`)."""
    return _zip_map(lambda t, s: place(t, s, device), tree, shardings)


def local_tree(tree: Tree, shardings: Tree, device=None) -> Tree:
    """Plain tensors: a copy of this rank's shard of every leaf."""
    return _zip_map(lambda t, s: _copy(local_chunk(t, s), device), tree,
                    shardings)


def _copy(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device`` (default: its own), never
    ``t`` itself: a shard must not share storage with the whole tensor."""
    return t.to(t.device if device is None else device,
                copy=True).contiguous()


def decode_layout(cache: Tree, mesh, data="data", tp: str = "model"):
    """(specs, decode_axis) of a whole decode cache on ``mesh``: the
    rules' sanitized ``cache_specs`` and ``tp`` where every KV cache's
    sequence divides over ``tp``; else every cache whole along ``tp``
    (its sequence and its Mamba states) and None — a decode over an axis
    reads every KV cache it is given as a sequence shard, so a stack
    whose ring buffers do not divide keeps them all whole."""
    specs = sanitize_specs(cache_specs(cache, data=data, tp=tp), cache, mesh)
    seq = []
    _map_leaves(lambda keys, s: seq.append(s[1]) if keys[-1] in (
        "k", "v", "c_kv", "k_rope") else None, specs)
    if all(s == tp for s in seq):
        return specs, tp
    return sanitize_specs(cache_specs(cache, data=data, tp=None), cache,
                          mesh), None


def shard_cache(cache: Tree, mesh, data="data", tp: str = "model"):
    """(this rank's shard of a whole decode cache, as plain tensors; the
    ``decode_axis`` to decode it with), by :func:`decode_layout`."""
    specs, axis = decode_layout(cache, mesh, data, tp)
    return local_tree(cache, named(specs, mesh)), axis


def _zip_map(fn, tree, shardings):
    if isinstance(shardings, NamedSharding):
        return fn(tree, shardings)
    if isinstance(shardings, Mapping):
        return {k: _zip_map(fn, tree[k], s) for k, s in shardings.items()}
    return [_zip_map(fn, t, s) for t, s in zip(tree, shardings)]


# ---------------------------------------------------------------------------
# the ambient mesh, constraints, the batch split
# ---------------------------------------------------------------------------

_MESH = None


@contextlib.contextmanager
def use_mesh(mesh):
    """Set the ambient mesh for the block (``launch.mesh.set_mesh``)."""
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def current_mesh():
    return _MESH


def maybe_constrain(x, *parts):
    """Redistribute a DTensor to the named layout while a mesh is set,
    as far as the mesh has the axes and they divide the dims; the identity
    on plain tensors and without a mesh (the reference's mesh-free path).
    The port's own paths keep activations as plain local tensors, so this
    is the identity on every one of them."""
    from torch.distributed.tensor import DTensor
    mesh = _MESH
    if mesh is None or not isinstance(x, DTensor):
        return x
    sizes = axis_sizes(mesh)
    out = []
    for i, axis in enumerate(parts):
        axes = () if axis is None else (axis if isinstance(axis, tuple)
                                        else (axis,))
        ok = (axes and all(a in sizes for a in axes) and i < x.ndim
              and x.shape[i] % _axis_size(sizes, axis) == 0)
        out.append(axis if ok else None)
    placements = placements_for(P(*out), mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


# Sequence parallelism (Korthikanti et al.): when on, the residual stream
# between units is sharded over ``model`` on the sequence dim as well as
# over ``data`` on the batch dim, so the per-unit remat carry shrinks by
# the ``model`` axis's size.  The reference's GSPMD does it from a
# constraint; the port's stack does it with its own collectives
# (``sharding.fsdp.shard_seq`` / ``gather_seq``).
_SEQ_PARALLEL = False


def set_seq_parallel(enabled: bool) -> None:
    """Turn sequence parallelism on or off for the process (the
    reference's switch); :func:`seq_parallel` sets it for a block."""
    global _SEQ_PARALLEL
    _SEQ_PARALLEL = bool(enabled)


@contextlib.contextmanager
def seq_parallel(enabled: bool = True):
    """Sequence parallelism on (or off) inside the block, and the previous
    setting restored after it."""
    prev = _SEQ_PARALLEL
    set_seq_parallel(enabled)
    try:
        yield
    finally:
        set_seq_parallel(prev)


def seq_axis():
    """The mesh axis the residual stream's sequence dim is sharded over:
    ``"model"`` with sequence parallelism on, else None."""
    return "model" if _SEQ_PARALLEL else None


_BATCH_SHARDS = 1


@contextlib.contextmanager
def split_batch(n: int):
    """The block runs on one of ``n`` equal row-slices of the batch (a
    sharded step): code whose result depends on how the whole batch is cut
    (MoE's dispatch blocks) reads :func:`batch_shards`."""
    global _BATCH_SHARDS
    prev, _BATCH_SHARDS = _BATCH_SHARDS, int(n)
    try:
        yield
    finally:
        _BATCH_SHARDS = prev


def batch_shards() -> int:
    return _BATCH_SHARDS
