"""Partition rules: parameter / batch / cache PartitionSpecs (the port of
``repro.sharding.rules``).

2-D param sharding (MaxText-style): FSDP along ``data`` × tensor-parallel
along ``model``; MoE experts shard over ``model`` (expert parallelism); KV
caches shard their sequence axis over ``model`` so decode works for any head
count (the flash-decode merge handles the softmax across shards).

Specs are keyed by the port's names: parameters by
``model.named_parameters()`` names, caches as the cache tree itself (dicts
and per-unit lists, a :class:`PartitionSpec` at each leaf).  The port's
scanned units are one module each (``stack.units.<i>.layer_j``), so every
unit's tensor gets the *unstacked* spec: the reference's spec of the
stacked leaf without its leading ``None``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

from torch import nn

__all__ = ["PartitionSpec", "P", "param_specs", "batch_spec", "cache_specs",
           "prepend_axis", "map_specs"]

Tree = Any


class PartitionSpec(tuple):
    """One entry per tensor dimension: a mesh-axis name, ``None``
    (replicated) or a tuple of names (one dimension over several mesh
    axes).  A tuple, so it compares equal to the reference's spec's
    entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def map_specs(fn, *trees):
    """``fn`` over the leaves of parallel trees whose first holds specs
    (mappings keep their keys, lists and tuples their order)."""
    first = trees[0]
    if isinstance(first, PartitionSpec):
        return fn(*trees)
    if isinstance(first, Mapping):
        return {k: map_specs(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [map_specs(fn, *(t[i] for t in trees))
                for i in range(len(first))]
    raise TypeError(f"not a spec tree leaf: {type(first)}")


def _map_leaves(fn, tree, path=()):
    """``fn(keys, leaf)`` over a tree of tensors or specs (dicts, lists)."""
    if isinstance(tree, PartitionSpec):
        return fn(list(path), tree)
    if isinstance(tree, Mapping):
        return {k: _map_leaves(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(list(path), tree)


def _named(shapes) -> dict:
    if isinstance(shapes, nn.Module):
        return dict(shapes.named_parameters())
    return dict(shapes)


def _base_spec(keys: list[str], ndim: int, fsdp: str, tp: str) -> P:
    last = keys[-1]
    if last == "embed":
        return P(tp, fsdp)
    if last in ("lm_head", "vis_proj", "frontend_proj"):
        return P(fsdp, tp)
    if last in ("wq", "wk", "wv", "in_proj", "shared_wi"):
        return P(fsdp, tp)
    if last in ("out_proj", "shared_wo"):
        return P(tp, fsdp)
    if last == "wi":
        return P(tp, fsdp, None) if ndim == 3 else P(fsdp, tp)
    if last == "wo":
        return P(tp, None, fsdp) if ndim == 3 else P(tp, fsdp)
    if last == "router":
        return P(fsdp, None)
    if last == "w_dkv":
        return P(fsdp, None)
    if last in ("w_uk", "w_uv"):
        return P(None, tp, None)
    if last == "conv_w":
        return P(None, tp)
    return P()                       # 1-d scales/biases: replicated


def param_specs(shapes: nn.Module | Mapping, fsdp: str = "data",
                tp: str = "model", prepend: tuple = ()) -> dict:
    """Spec per parameter name of a model (or a name -> tensor mapping)."""
    out = {}
    for name, leaf in _named(shapes).items():
        base = tuple(_base_spec(name.split("."), leaf.ndim, fsdp, tp))
        out[name] = P(*prepend, *base, *(None,) * (leaf.ndim - len(base)))
    return out


def batch_spec(batch_shapes: Mapping, data: str | tuple = "data",
               prepend: tuple = ()) -> dict:
    """Batch dict: batch dimension over the data axis."""
    return {k: P(*prepend, data, *([None] * (v.ndim - 1)))
            for k, v in batch_shapes.items()}


def cache_specs(cache_shapes: Tree, data: str | tuple = "data",
                tp: str = "model", seq_shard: bool = True,
                prepend: tuple = ()) -> Tree:
    """KV/state caches: batch over data; sequence over model (decode flash
    merge); mamba states head-sharded over model."""

    def spec_for(keys, leaf):
        last = keys[-1]
        seq = tp if seq_shard else None
        if last in ("k", "v"):                    # (B, S, KVH, hd)
            base = (data, seq, None, None)
        elif last in ("c_kv", "k_rope"):          # (B, S, r)
            base = (data, seq, None)
        elif last == "conv":                      # (B, K-1, C)
            base = (data, None, tp)
        elif last == "ssm":                       # (B, H, P, N)
            base = (data, tp, None, None)
        elif last == "enc_out":                   # (B, F, D)
            base = (data, None, None)
        else:
            base = (data,) + (None,) * (leaf.ndim - 1)
        return P(*prepend, *base)

    return _map_leaves(spec_for, cache_shapes)


def prepend_axis(specs: Tree, axis: str) -> Tree:
    """Prepend a mesh axis (e.g. 'pod') to every spec in a tree."""
    return map_specs(lambda s: P(axis, *s), specs)
