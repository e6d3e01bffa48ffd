"""Weakly connected components by min-label propagation.

Every vertex starts with its own id as its label; each round every arc,
taken both ways, hands its tail's label to its head where that is smaller
(a gather and a ``scatter_reduce`` amin), and integer labels then jump to
their label's label, which only ever lowers them.  Labels only fall and
each names a vertex of its own component, so a round that changes nothing
leaves every vertex with the least id in its component.
"""

from __future__ import annotations

import torch

__all__ = ["labels"]


def labels(edges, n: int, *, dtype: torch.dtype = torch.int64,
           device="cpu") -> torch.Tensor:
    """(n,) least vertex id of each vertex's weakly connected component over
    the (E, 2) arcs ``edges``, carried in ``dtype`` on ``device`` (a
    floating ``dtype`` rounds the ids and skips the jumps)."""
    edges = torch.as_tensor(edges, device=device)
    src, dst = edges[:, 0].long(), edges[:, 1].long()
    lab = torch.arange(n, device=device).to(dtype)
    jump = not dtype.is_floating_point
    for _ in range(n + 1):
        new = lab.scatter_reduce(0, dst, lab[src], "amin")
        new = new.scatter_reduce(0, src, lab[dst], "amin")
        if jump:
            new = new[new]
        if torch.equal(new, lab):
            return lab
        lab = new
    raise RuntimeError("labels did not settle in n rounds")
