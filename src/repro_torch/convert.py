"""Carry structures across between the reference and the port.

The reference's ``PartitionedGraph`` and ``EngineState`` play the part of
weights here: with :func:`to_numpy` on the reference side and
:func:`graph_from_numpy` / :func:`engine_state_from_numpy` on the port
side, one graph (or one engine state) feeds both packages, and
:func:`to_numpy` on the port's result compares leaf by leaf.

Nothing here imports the reference: a structure crosses as nested plain
values — dataclasses become dicts of their fields, tuples become lists,
array leaves become numpy arrays, static fields stay Python values.  An
engine checkpoint crosses on disk: :func:`engine_state_from_checkpoint`
reads one that either package wrote.

The LM substrate's weights cross the same way.  The reference stacks its
scanned units on a leading axis (``stack.units.<leaf>[i]``); the port keeps
one module per unit (``stack.units.<i>.<leaf>``).
:func:`lm_params_from_numpy` unstacks a reference param tree into the
port's model and :func:`lm_params_to_numpy` stacks it back; the same pairs
exist for ``AdamWState`` and ``OuterState`` (whose moments and residuals
the port keys by parameter name), and :func:`lm_cache_to_numpy` gives a
port decode cache the reference's layout.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import (CheckpointError, _flatten_with_names,
                                         _np_dtype, _unflatten,
                                         latest_checkpoint,
                                         load_checkpoint_arrays)
from repro_torch.core.graph import EllSlice, PartitionedGraph
from repro_torch.core.runtime import Counters, EngineState
from repro_torch.device import resolve_device

__all__ = ["to_numpy", "graph_from_numpy", "engine_state_from_numpy",
           "engine_state_from_checkpoint", "lm_params_from_numpy",
           "lm_params_to_numpy", "adamw_state_from_numpy",
           "adamw_state_to_numpy", "outer_state_from_numpy",
           "outer_state_to_numpy", "lm_cache_to_numpy"]


def to_numpy(obj: Any) -> Any:
    """Nested numpy copy of a structure of either package: dataclass ->
    dict of fields, dict -> dict, tuple/list -> list, tensor or array ->
    ``np.ndarray``; other values as they are."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, Mapping):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [to_numpy(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        # .cpu().numpy() of a host tensor is a view of its storage
        t = obj.detach()
        return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()
    if hasattr(obj, "__array__"):          # numpy / reference arrays
        return np.asarray(obj)
    return obj


def _tensor(a, device: torch.device) -> torch.Tensor:
    # a copy: the source may be a read-only view of the reference's buffer
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def _static(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    if isinstance(v, np.ndarray):
        return v.item()
    return v


def _dataclass_from(cls, fields: Mapping, device: torch.device):
    kw = {}
    for f in dataclasses.fields(cls):
        v = fields[f.name]
        if f.metadata.get("static"):
            kw[f.name] = _static(v)
        elif f.name in ("local_ell", "remote_ell"):
            kw[f.name] = tuple(_dataclass_from(EllSlice, s, device)
                               for s in v)
        else:
            kw[f.name] = _tensor(v, device)
    return cls(**kw)


def graph_from_numpy(fields: Mapping, device=None) -> PartitionedGraph:
    """The port's ``PartitionedGraph`` from a reference graph's fields
    (``to_numpy(reference_graph)``): every leaf keeps its dtype."""
    return _dataclass_from(PartitionedGraph, fields, resolve_device(device))


def _tree(v, device):
    if isinstance(v, Mapping):
        return {k: _tree(x, device) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return tuple(_tree(x, device) for x in v)
    return _tensor(v, device)


def engine_state_from_numpy(fields: Mapping, device=None) -> EngineState:
    """The port's ``EngineState`` from a reference state's fields
    (``to_numpy(reference_state)``).  Counters widen to the port's int64."""
    device = resolve_device(device)
    kw = {f.name: _tree(fields[f.name], device)
          for f in dataclasses.fields(EngineState) if f.name != "counters"}
    counters = Counters(**{k: _tensor(v, device).to(torch.int64)
                           for k, v in fields["counters"].items()})
    return EngineState(counters=counters, **kw)


def engine_state_from_checkpoint(path: str, like: EngineState, device=None
                                 ) -> tuple[EngineState, int]:
    """The port's ``EngineState`` on ``device`` from an engine checkpoint
    written by either package — the reference's ``run_hybrid_ft`` or the
    port's — and its iteration.  ``path`` is a ``step_*`` directory or a
    base directory (its newest complete checkpoint is taken).  ``like`` is
    the port's ``init_hybrid`` for the same graph and program: its leaf
    names, shapes and dtypes are what the checkpoint must hold, except that
    the reference's int32 counters widen to the port's int64.

    Raises:
        CheckpointError: no complete checkpoint, a corrupt blob, or leaves
            that are not those of ``like``.
    """
    device = resolve_device(device)
    if not os.path.exists(os.path.join(path, "manifest.json")):
        found = latest_checkpoint(path)
        if found is None:
            raise CheckpointError(f"{path}: no complete checkpoint found")
        path = found
    arrs, manifest = load_checkpoint_arrays(path)
    named = _flatten_with_names(like)
    if list(arrs) != [name for name, _ in named]:
        raise CheckpointError(
            f"{path}: leaves {list(arrs)} are not those of the EngineState "
            f"template {[name for name, _ in named]}")
    out = []
    for name, leaf in named:
        a, want = arrs[name], _np_dtype(leaf)
        widen = (name.startswith(".counters/") and a.dtype == np.int32
                 and want == np.int64)
        if tuple(a.shape) != tuple(leaf.shape) or (a.dtype != want
                                                   and not widen):
            raise CheckpointError(
                f"{path}: leaf {name!r} is {a.dtype}{a.shape}, the "
                f"EngineState template wants {want}{tuple(leaf.shape)}")
        out.append(_tensor(a, device).to(leaf.dtype))
    return _unflatten(like, iter(out)), int(manifest["step"])


# ---------------------------------------------------------------------------
# the LM substrate
# ---------------------------------------------------------------------------

def _stack_trees(trees: list, axis: int):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _stack_trees([t[k] for t in trees], axis) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack_trees([t[i] for t in trees], axis)
                for i in range(len(first))]
    return np.stack([np.asarray(t) for t in trees], axis=axis)


def _stack_units(tree, axis: int):
    """The reference's layout of a port tree: every list of per-unit trees
    under a ``units`` key stacked on ``axis``."""
    if isinstance(tree, Mapping):
        return {k: (_stack_trees([_stack_units(u, axis) for u in v], axis)
                    if k == "units" else _stack_units(v, axis))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_stack_units(v, axis) for v in tree]
    return tree


def _leaves(tree) -> list:
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _take(tree, i: int, axis: int):
    if isinstance(tree, Mapping):
        return {k: _take(v, i, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_take(v, i, axis) for v in tree]
    return np.take(np.asarray(tree), i, axis=axis)


def _unstack_units(tree, axis: int):
    """The port's layout of a reference tree: the stacked tree under every
    ``units`` key split along ``axis`` into a list of per-unit trees."""
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            if k == "units":
                n = np.shape(_leaves(v)[0])[axis]
                out[k] = [_take(v, i, axis) for i in range(n)]
            else:
                out[k] = _unstack_units(v, axis)
        return out
    if isinstance(tree, (list, tuple)):
        return [_unstack_units(v, axis) for v in tree]
    return tree


def _flat(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Dotted names (the port's parameter names) -> leaves."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def _tree_of(module: torch.nn.Module, leaf, prefix: str = ""):
    """``module``'s parameter tree (nodes as dicts, ``ModuleList`` as
    lists) with each parameter replaced by ``leaf(name)``."""
    if isinstance(module, torch.nn.ModuleList):
        return [_tree_of(c, leaf, f"{prefix}{i}.")
                for i, c in enumerate(module)]
    out = {k: leaf(prefix + k)
           for k, _ in module.named_parameters(recurse=False)}
    out.update({k: _tree_of(c, leaf, f"{prefix}{k}.")
                for k, c in module.named_children()})
    return out


def _skeleton(cfg) -> torch.nn.Module:
    from repro_torch.models.registry import param_shapes
    return param_shapes(cfg, torch.float32)


def _named_from_numpy(tree, cfg, device, axis: int = 0
                      ) -> dict[str, torch.Tensor]:
    """A reference param-shaped tree as the port's ``{name: tensor}``,
    checked against the names and shapes of ``cfg``'s model (``axis``:
    where the reference stacks units, after any pod axis)."""
    named = _flat(_unstack_units(tree, axis))
    want = dict(_skeleton(cfg).named_parameters())
    if set(named) != set(want):
        raise ValueError(
            f"tree does not hold {cfg.name}'s parameters: missing "
            f"{sorted(set(want) - set(named))}, unknown "
            f"{sorted(set(named) - set(want))}")
    pod = () if axis == 0 else np.shape(_leaves(tree)[0])[:axis]
    for k, p in want.items():
        if tuple(named[k].shape) != pod + tuple(p.shape):
            raise ValueError(f"{k}: shape {named[k].shape}, {cfg.name} "
                             f"wants {pod + tuple(p.shape)}")
    device = resolve_device(device)
    return {k: _tensor(a, device) for k, a in named.items()}


def _numpy_like(cfg, values: Mapping, axis: int = 0) -> dict:
    """The reference's param tree of ``cfg`` with ``values[name]`` at each
    parameter (units stacked on ``axis``)."""
    return _stack_units(_tree_of(_skeleton(cfg),
                                 lambda k: to_numpy(values[k])), axis)


def lm_params_from_numpy(tree: Mapping, cfg, device=None) -> torch.nn.Module:
    """The port's model for ``cfg`` holding a reference param tree
    (``to_numpy(params)``: stacked units, every leaf's dtype kept)."""
    model = _skeleton(cfg)
    model.load_state_dict(_named_from_numpy(tree, cfg, device), assign=True)
    return model


def lm_params_to_numpy(model: torch.nn.Module, cfg) -> dict:
    """The reference's param tree (stacked units) of a port model."""
    return _numpy_like(cfg, dict(model.named_parameters()))


def adamw_state_from_numpy(fields: Mapping, cfg, device=None):
    """The port's ``AdamWState`` from a reference state's fields
    (``to_numpy(state)``)."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(mu=_named_from_numpy(fields["mu"], cfg, device),
                      nu=_named_from_numpy(fields["nu"], cfg, device),
                      step=_tensor(fields["step"], resolve_device(device)))


def adamw_state_to_numpy(state, cfg) -> dict:
    return {"mu": _numpy_like(cfg, state.mu), "nu": _numpy_like(cfg, state.nu),
            "step": to_numpy(state.step)}


def outer_state_from_numpy(fields: Mapping, cfg, device=None):
    """The port's ``OuterState`` from a reference state's fields; the
    residuals keep their leading pod axis."""
    from repro_torch.core.hybrid_sync import OuterState
    from repro_torch.optim.compression import ErrorFeedbackState
    return OuterState(
        anchor=_named_from_numpy(fields["anchor"], cfg, device),
        momentum=_named_from_numpy(fields["momentum"], cfg, device),
        ef=ErrorFeedbackState(residual=_named_from_numpy(
            fields["ef"]["residual"], cfg, device, axis=1)))


def outer_state_to_numpy(state, cfg) -> dict:
    return {"anchor": _numpy_like(cfg, state.anchor),
            "momentum": _numpy_like(cfg, state.momentum),
            "ef": {"residual": _numpy_like(cfg, state.ef.residual, axis=1)}}


def lm_cache_to_numpy(cache: Mapping) -> dict:
    """The reference's layout (stacked units) of a port decode cache."""
    return _stack_units(to_numpy(cache), 0)
