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
           "engine_state_from_checkpoint"]


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
        return obj.detach().cpu().numpy()
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
