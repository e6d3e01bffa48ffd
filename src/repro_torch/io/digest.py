"""Canonical content digest of a ``PartitionedGraph``.

The in-memory and out-of-core builders promise *bit-identical* structures;
a digest makes that claim checkable across process boundaries, and across
packages: it equals ``repro.io.digest.graph_digest`` of the reference's
graph built from the same inputs (same field order, numpy dtype names,
shape strings and bytes).  Tensors are copied to the host to be hashed, so
on the card it costs one device-to-host copy of the whole graph.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

__all__ = ["graph_digest"]


def _update(h, value) -> None:
    if isinstance(value, tuple):
        h.update(str(len(value)).encode())
        for v in value:
            if dataclasses.is_dataclass(v):
                for f in dataclasses.fields(v):
                    _update(h, getattr(v, f.name))
            else:                      # static int tuples (ep_by_p/gp_by_p)
                _update(h, v)
    elif isinstance(value, (int, bool)):
        h.update(str(value).encode())
    else:
        arr = (value.detach().cpu().numpy()
               if isinstance(value, torch.Tensor) else np.asarray(value))
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())


def graph_digest(graph) -> str:
    """SHA-256 over every field of the graph (dataclass field order:
    arrays as dtype+shape+bytes, ELL slice tuples recursively, static
    ints verbatim).  Attributes outside the dataclass fields (the dense
    delivery plan cached on the graph) do not enter it."""
    h = hashlib.sha256()
    for f in dataclasses.fields(graph):
        _update(h, getattr(graph, f.name))
    return h.hexdigest()
