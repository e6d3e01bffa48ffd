"""Carry structures across between the reference and the port.

The reference's ``PartitionedGraph`` and ``EngineState`` play the part of
weights here: with :func:`to_numpy` on the reference side and
:func:`graph_from_numpy` / :func:`engine_state_from_numpy` on the port
side, one graph (or one engine state) feeds both packages, and
:func:`to_numpy` on the port's result compares leaf by leaf.

Nothing here imports the reference: a structure crosses as nested plain
values — dataclasses become dicts of their fields, tuples become lists,
array leaves become numpy arrays, static fields stay Python values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.graph import EllSlice, PartitionedGraph
from repro_torch.core.runtime import Counters, EngineState
from repro_torch.device import resolve_device

__all__ = ["to_numpy", "graph_from_numpy", "engine_state_from_numpy"]


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
