"""K-lane multi-query programs: one engine run answers K independent
queries.

Vertex state carries a trailing lane axis of width L
(``Channel(lanes=L)``), every message is an (..., L) stack, and delivery
rides the semiring kernels with an (N, L) frontier — one launch per
degree bin answers all L sources.

  * :class:`MultiSourceMonotone` — the monotone relax/adopt family over
    any ``MONOTONE_SEMIRINGS`` entry: multi-source SSSP (min_add, and
    reachability through :func:`reachable`), widest paths (max_min),
    odds / log-likelihood walks (min_mul / max_add).
  * :class:`PersonalizedPageRank` — lane j runs incremental PageRank with
    all teleport mass at seed j.

Lane contracts (what makes K lanes equal K single runs):

  * Send flags stay *per vertex* (any lane): scheduling, has-message flags
    and counters are lane-oblivious, so a K-lane message counts once.
  * Monotone programs export full per-lane state (keep-latest, like
    SSSP): re-delivering a known lane value is a ⊕-no-op.
  * Accumulative (sum) programs pre-neutralize ``out`` per lane
    (``where(lane_send, delta, 0)``), so additive export accumulation
    stays per-lane exact.

Sources/seeds go to the constructor or per run through
``vdata={"sources": (L,) int}``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.core.vertex_program import Channel, StepInfo, VertexProgram
from repro_torch.kernels.common import (MONOTONE_SEMIRINGS, SEMIRINGS, f32,
                                        semiring_improves)

__all__ = ["MultiSourceMonotone", "PersonalizedPageRank", "reachable",
           "sources_digest"]


def sources_digest(sources) -> str:
    """Content digest of a (K,) source/seed vector — the lane-batch half
    of a ``(program, K, sources)`` checkpoint key.  Order-sensitive on
    purpose: lane j of a checkpoint is only valid for lane j's source."""
    if isinstance(sources, torch.Tensor):
        sources = sources.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(sources, dtype=np.int64))
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


# "the path starts here" per monotone semiring: the ⊗-identity, except
# max_min, whose source must not cap any path (+inf bottleneck)
_SOURCE_VALUE = {"min_add": 0.0, "max_add": 0.0, "min_mul": 1.0,
                 "max_min": float("inf")}


def _lane_mask(send, v):
    """Broadcast a per-vertex send mask against per-lane values."""
    return send.reshape(tuple(send.shape) + (1,) * (v.dim() - send.dim()))


def _lane_ids(vdata, fixed, device) -> torch.Tensor:
    src = vdata["sources"] if vdata is not None and "sources" in vdata \
        else fixed
    return torch.as_tensor(src).to(device=device, dtype=torch.int32)


class MultiSourceMonotone(VertexProgram):
    """K-lane monotone propagation: lane j solves the single-source
    problem from ``sources[j]`` under ``semiring``; state/out hold a
    (P, Vp, L) value table, lane j bit-identical to a single-source run."""

    boundary_participates = True
    # single monotone channel, out == state, adopt-if-better apply, never
    # self-activating, keep-latest export: the lane-general min_step
    # contract — the hybrid engine fuses the whole local phase
    fused_kernel = "min_step"

    def __init__(self, sources=None, *, lanes: int | None = None,
                 semiring: str = "min_add", source_value=None):
        if semiring not in MONOTONE_SEMIRINGS:
            raise ValueError(f"{semiring!r} is not a monotone semiring")
        if lanes is None:
            if sources is None:
                raise ValueError("need sources or lanes")
            lanes = len(sources)
        self.sources = sources
        self.lanes = int(lanes)
        self.semiring = semiring
        self.source_value = (_SOURCE_VALUE[semiring] if source_value is None
                             else source_value)
        combiner = "min" if semiring.startswith("min") else "max"
        _, _, ident = SEMIRINGS[semiring]
        self.ident = f32(ident)
        self.channels = (Channel("val", combiner, ((torch.float32, ident),),
                                 semiring=semiring, lanes=self.lanes),)

    def init(self, gid, vmask, vdata):
        src = _lane_ids(vdata, self.sources, gid.device)    # (L,)
        is_src = gid[..., None] == src                      # (P, Vp, L)
        val = torch.where(is_src, f32(self.source_value),
                          self.ident).to(torch.float32)
        send = torch.logical_and(torch.any(is_src, dim=-1), vmask)
        return {"val": val}, {"val": val}, send, torch.zeros_like(vmask)

    def emit(self, ch, out_src, w, src_gid, dst_gid):
        _, times, _ = SEMIRINGS[self.semiring]
        return (times(out_src["val"], w[..., None]),), \
            torch.ones(w.shape, dtype=torch.bool, device=w.device)

    def ell_payload(self, ch, out, send):
        # message = val[src] ⊗ w per lane; non-senders flatten to the ⊕
        # identity (re-delivering a known lane value is a ⊕-no-op)
        v = out["val"]
        return torch.where(_lane_mask(send, v), v, self.ident)

    def apply(self, state, inbox, gid, vmask, vdata, info: StepInfo):
        combine, _, _ = SEMIRINGS[self.semiring]
        improves = semiring_improves(self.semiring)
        (msg,), has = inbox["val"]
        msg = torch.where(_lane_mask(has, msg), msg, self.ident)
        new = combine(state["val"], msg)
        send = torch.any(improves(new, state["val"]), dim=-1)
        return {"val": new}, {"val": new}, send, torch.zeros_like(send)


class PersonalizedPageRank(VertexProgram):
    """Per-seed personalized PageRank, K lanes at once: lane j runs the
    incremental-PageRank recurrence with all teleport mass at seed j,
    ``rank_j = (1-d)·e_seed_j + d·AᵀD⁻¹ rank_j`` (unnormalized; use
    ``pagerank_edge_weights``).  Lane j equals a single-seed run."""

    boundary_participates = True
    fused_kernel = "pr_step"

    def __init__(self, seeds=None, *, lanes: int | None = None,
                 tolerance: float = 1e-4, damping: float = 0.85):
        if lanes is None:
            if seeds is None:
                raise ValueError("need seeds or lanes")
            lanes = len(seeds)
        self.seeds = seeds
        self.lanes = int(lanes)
        self.tol = float(tolerance)
        self.damping = float(damping)
        self.channels = (Channel("delta", "sum", ((torch.float32, 0.0),),
                                 semiring="add_mul", lanes=self.lanes),)

    def init(self, gid, vmask, vdata):
        is_seed = gid[..., None] == _lane_ids(vdata, self.seeds, gid.device)
        base = torch.where(is_seed, f32(1.0 - self.damping),
                           0.0).to(torch.float32)
        send = torch.logical_and(torch.any(is_seed, dim=-1), vmask)
        return {"rank": base}, {"delta": base}, send, torch.zeros_like(send)

    def emit(self, ch, out_src, w, src_gid, dst_gid):
        return ((f32(self.damping) * out_src["delta"]) * w[..., None],), \
            torch.ones(w.shape, dtype=torch.bool, device=w.device)

    def ell_payload(self, ch, out, send):
        # out["delta"] is pre-neutralized per lane, so vertex-level gating
        # completes the (+)-annihilation
        v = out["delta"]
        return torch.where(_lane_mask(send, v), f32(self.damping) * v, 0.0)

    def apply(self, state, inbox, gid, vmask, vdata, info: StepInfo):
        (delta,), has = inbox["delta"]
        delta = torch.where(_lane_mask(has, delta), delta, 0.0)
        rank = state["rank"] + delta
        lane_send = delta > f32(self.tol)
        # pre-neutralized out: only improving lanes re-propagate
        out = torch.where(lane_send, delta, 0.0)
        send = torch.any(lane_send, dim=-1)
        return {"rank": rank}, {"delta": out}, send, torch.zeros_like(send)

    # ---- additive SourceCombine (per-lane exact: out is pre-neutralized)
    def accumulate_export(self, acc_out, acc_send, new_out, new_send):
        d = new_out["delta"]
        acc = acc_out["delta"] + torch.where(_lane_mask(new_send, d), d, 0.0)
        return {"delta": acc}, torch.logical_or(acc_send, new_send)

    def export_identity(self, out):
        return {"delta": torch.zeros_like(out["delta"])}


def reachable(dist_lanes):
    """Reachability view of a min_add :class:`MultiSourceMonotone` result:
    vertex v is reachable from lane j's source iff its distance is
    finite."""
    if isinstance(dist_lanes, torch.Tensor):
        return torch.isfinite(dist_lanes)
    return np.isfinite(dist_lanes)
