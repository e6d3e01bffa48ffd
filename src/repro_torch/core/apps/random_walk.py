"""Most-likely absorbing random walk: per-vertex best-path probability.

A walker starts at ``source`` and steps to a uniformly random
out-neighbour; each vertex computes the probability of the *most likely*
walk reaching it, ``P[v] = max over in-edges of P[u] * p(u -> v)``.  Two
isomorphic monotone formulations, each with the edge weights
:func:`random_walk_edge_weights` builds on the host (so the device loop
is pure ⊗ arithmetic, no transcendental):

  * ``mode='odds'``    — weights ``w = out_degree(src)``; state is
    ``1/P = Π w``; the minimum over walks: (min, *), ``min_mul``.
  * ``mode='logprob'`` — weights ``w = -log out_degree(src)``; state is
    ``log P = Σ w``; the maximum over walks: (max, +), ``max_add``.

Both are adopt-if-better programs (SSSP with the algebra swapped), so the
local phase fuses through `min_step`.  ``probability`` converts either
state back to P (1 at the source, 0 where unreachable).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.vertex_program import Channel, StepInfo, VertexProgram
from repro_torch.kernels.common import maximum, minimum

INF = float("inf")


class RandomWalk(VertexProgram):
    boundary_participates = True
    # single min/min_mul (or max/max_add) channel, out == state,
    # adopt-if-better apply, never self-activating, keep-latest export
    fused_kernel = "min_step"

    def __init__(self, source: int, mode: str = "odds"):
        if mode not in ("odds", "logprob"):
            raise ValueError(mode)
        self.source = source
        self.mode = mode
        if mode == "odds":
            self.channels = (Channel("mass", "min", ((torch.float32, INF),),
                                     semiring="min_mul"),)
        else:
            self.channels = (Channel("mass", "max", ((torch.float32, -INF),),
                                     semiring="max_add"),)

    @property
    def _ident(self) -> float:
        return INF if self.mode == "odds" else -INF

    def init(self, gid, vmask, vdata):
        is_src = gid == self.source
        # odds: 1/P = 1 at the source; logprob: log P = 0
        start = 1.0 if self.mode == "odds" else 0.0
        mass = torch.where(is_src, start, self._ident).to(torch.float32)
        send = torch.logical_and(is_src, vmask)
        return {"mass": mass}, {"mass": mass}, send, torch.zeros_like(vmask)

    def emit(self, ch, out_src, w, src_gid, dst_gid):
        # the graph carries the mode's weight convention (module doc)
        if self.mode == "odds":
            msg = out_src["mass"] * w
        else:
            msg = out_src["mass"] + w
        return (msg,), torch.ones(w.shape, dtype=torch.bool, device=w.device)

    def ell_payload(self, ch, out, send):
        # message = mass[src] ⊗ edge_val; non-senders take the ⊕ identity
        return torch.where(send, out["mass"], self._ident)

    def apply(self, state, inbox, gid, vmask, vdata, info: StepInfo):
        (msg,), has = inbox["mass"]
        masked = torch.where(has, msg, self._ident)
        if self.mode == "odds":
            new = minimum(state["mass"], masked)
            send = new < state["mass"]
        else:
            new = maximum(state["mass"], masked)
            send = new > state["mass"]
        return {"mass": new}, {"mass": new}, send, torch.zeros_like(send)

    def probability(self, mass):
        """Best-walk probability P from either state convention."""
        if self.mode == "odds":
            return torch.where(torch.isfinite(mass), 1.0 / mass, 0.0)
        return torch.where(torch.isfinite(mass), torch.exp(mass), 0.0)


def random_walk_edge_weights(edges, n_vertices, mode: str = "odds"):
    """Uniform-transition edge weights in the mode's convention: inverse
    step probability ``out_degree(src)`` for 'odds', ``-log
    out_degree(src)`` = log p for 'logprob'.  Computed on the host so the
    device loop never evaluates a transcendental."""
    deg = np.bincount(edges[:, 0], minlength=n_vertices).astype(np.float32)
    w = deg[edges[:, 0]]
    return w if mode == "odds" else -np.log(w)
