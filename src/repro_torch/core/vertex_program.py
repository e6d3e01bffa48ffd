"""Vertex-centric program API (the paper's `Compute()` contract, vectorized),
the PyTorch counterpart of ``repro.core.vertex_program``.

A :class:`VertexProgram` is the array-level equivalent of subclassing
Hama's ``Vertex`` class:

  * ``init``    — superstep 0 (the paper's initialization iteration),
  * ``emit``    — message generation along an edge, evaluated receiver-side
                  from the sender's exported *out-state*,
  * channels    — per-destination combination (``Combine()``) as a monoid,
  * ``apply``   — the body of ``Compute()``: consume the combined inbox,
                  update vertex state, decide what to send and whether to
                  stay active (``voteToHalt``),
  * ``accumulate_export`` — ``SourceCombine()``: how out-states pile up in a
                  partition's export buffer between global exchanges
                  (default: keep-latest, the paper's default rule).

All hooks are plain functions of tensors, vectorized over every vertex of
every partition; state, out-state and export buffers are dicts of
``(P, Vp[, L])`` tensors.  :func:`combine_segments` is the dense delivery
path's per-destination combine.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

__all__ = ["Channel", "VertexProgram", "StepInfo", "combine_segments",
           "SegmentPlan", "segment_plan", "segment_sum", "segment_select",
           "INT_INF"]

INT_INF = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class Channel:
    """A typed message channel with a monoid combiner.

    combiner: 'sum' | 'min' | 'max' | 'lexmin'.  'lexmin' is the
      lexicographic minimum over the payload tuple, by cascaded masked
      segment-mins (deterministic tie-breaking).
    components: per-payload-component (torch dtype, identity) pairs.
    semiring: optional kernel declaration, one of the `ell_spmv` semirings
      ('add_mul' | 'min_add' | 'max_add' | 'min_mul' | 'max_min') or None.
      Declaring one states that the channel's per-edge message factors as
      ``x[src] ⊗ edge_val`` with an always-valid emit, where ``x`` comes
      from :meth:`VertexProgram.ell_payload`; delivery then runs through
      the ELL kernels.  Only single-component channels are eligible.
    lanes: 0 for a per-vertex scalar channel; L > 0 for a K-lane channel
      whose arrays carry a trailing lane axis of width L.
    """

    name: str
    combiner: str
    components: Sequence[tuple[Any, Any]]
    semiring: str | None = None
    lanes: int = 0

    def identity_like(self, shape: tuple[int, ...],
                      device: torch.device) -> tuple[torch.Tensor, ...]:
        if self.lanes:
            shape = tuple(shape) + (self.lanes,)
        return tuple(torch.full(shape, ident, dtype=dt, device=device)
                     for dt, ident in self.components)


@dataclasses.dataclass(frozen=True)
class StepInfo:
    """What the engine tells `apply` about the current step."""

    superstep: torch.Tensor | int       # global iteration index
    pseudo_step: torch.Tensor | int     # pseudo-superstep within local phase
    phase: str                          # 'init' | 'global' | 'local' | 'superstep'


class VertexProgram:
    """Base class; subclasses define the hooks below."""

    channels: tuple[Channel, ...] = ()
    # whether boundary vertices participate in local phases (paper §4.2 —
    # safe for incremental computations; accelerates convergence)
    boundary_participates: bool = True
    # name of a fully-fused local-phase kernel ('pr_step' | 'min_step') or
    # None; setting it asserts the program satisfies that kernel's contract
    # (see ``exec.local_phase``)
    fused_kernel: str | None = None

    # -- hooks ------------------------------------------------------------
    def init(self, gid, vmask, vdata):
        """-> (state dict, out dict, send (bool per vertex), active)."""
        raise NotImplementedError

    def emit(self, ch: Channel, out_src, w, src_gid, dst_gid):
        """-> (payload tuple, valid bool) per edge for channel ``ch``."""
        raise NotImplementedError

    def apply(self, state, inbox, gid, vmask, vdata, info: StepInfo):
        """-> (state, out, send, active).  ``inbox[name] = (payloads, has_msg)``."""
        raise NotImplementedError

    def accumulate_export(self, acc_out, acc_send, new_out, new_send):
        """SourceCombine(): default keep-latest-if-sent (paper default)."""
        merged = {k: _where_send(new_send, new_out[k], acc_out[k])
                  for k in acc_out}
        return merged, torch.logical_or(acc_send, new_send)

    def export_identity(self, out):
        """Export-buffer reset value after an exchange.  Keep-latest programs
        don't care (the send flag gates); accumulative (sum) programs
        override with zeros so deltas re-accumulate from scratch."""
        return out

    def ell_payload(self, ch: Channel, out, send):
        """Per-vertex kernel operand ``x`` (P, Vp) for a semiring channel:
        the channel's message along s -> d equals ``x[s] ⊗ edge_val``, and
        ``x`` is the ⊕-annihilating value where ``~send``.  None forces the
        dense path (the default)."""
        return None

    def ell_edge_values(self, ch: Channel, val):
        """Edge-value operand for the ELL kernel — the packed edge weights
        by default."""
        return val

    def global_only_active(self, state, vdata):
        """Optional (P, Vp) mask of vertices whose self-activity needs only
        global-cadence scheduling; None means no such vertices."""
        return None


def _where_send(send, new, old):
    send_b = send.reshape(send.shape + (1,) * (new.dim() - send.dim()))
    return torch.where(send_b, new, old)


# ---------------------------------------------------------------------------
# Monoid segment combination.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """A stable sort of a segment-id vector, computed once per graph.

    ``perm`` lists the elements segment by segment, each segment's in its
    original order; segment ``s`` is ``perm[offsets[s]:offsets[s + 1]]``."""

    perm: torch.Tensor       # (E,) int64
    offsets: torch.Tensor    # (num_segments + 1,) int64


def segment_plan(seg: torch.Tensor, num_segments: int) -> SegmentPlan:
    """The :class:`SegmentPlan` of segment ids ``seg`` (E,)."""
    sorted_seg, perm = torch.sort(seg.long(), stable=True)
    bounds = torch.arange(num_segments + 1, device=seg.device)
    return SegmentPlan(perm, torch.searchsorted(sorted_seg, bounds))


def _bx(v, p):
    """Broadcast a per-edge (E,) mask against (E[, L]) payloads."""
    return v.reshape(tuple(v.shape) + (1,) * (p.dim() - v.dim()))


def segment_sum(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """Per-segment sum of ``x`` (E[, L]) in the order of the elements,
    from +0.0: the fold of ``jax.ops.segment_sum`` on the host, bit for
    bit.  Floats go through ``torch.segment_reduce`` over a 2-D view,
    which folds each segment sequentially on the CPU and on CUDA (its 1-D
    CUDA path is a CUB tree, so it is never taken); integers through an
    int64 prefix sum, exact and wrapped back to the payload's width.
    Neither uses atomics."""
    n = plan.offsets.shape[0] - 1
    tail = tuple(x.shape[1:])
    data = x.index_select(0, plan.perm)
    if x.is_floating_point():
        out = torch.segment_reduce(data.reshape(data.shape[0], -1), "sum",
                                   offsets=plan.offsets, axis=0, unsafe=True)
        return out.reshape((n,) + tail)
    csum = torch.cumsum(data, dim=0, dtype=torch.int64)
    csum = torch.cat([csum.new_zeros((1,) + tail), csum])
    return (csum[plan.offsets[1:]] - csum[plan.offsets[:-1]]).to(x.dtype)


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 whose signed order is the float order with -0.0
    below +0.0 (an involution: applied to a key it gives the bits back)."""
    b = x.view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def segment_select(x: torch.Tensor, seg: torch.Tensor, num_segments: int,
                   combiner: str) -> torch.Tensor:
    """Per-segment min or max (``combiner``) of ``x`` (E[, L]) over segment
    ids ``seg`` (E,), as ``jax.ops.segment_min`` / ``segment_max`` give it:
    NaN propagates, -0.0 orders below +0.0, an empty segment holds the
    dtype's extreme (+-inf for floats).  Floats are compared through
    :func:`_order_key`, NaN keyed past every number, so the reduction runs
    on exact integer keys: its result does not depend on the order in
    which the elements arrive."""
    take_min = combiner == "min"
    reduce = "amin" if take_min else "amax"
    if x.is_floating_point():
        if x.dtype != torch.float32:
            raise TypeError(f"float payloads must be float32, got {x.dtype}")
        nan_key, ext = ((torch.iinfo(torch.int32).min, float("inf"))
                        if take_min else
                        (torch.iinfo(torch.int32).max, float("-inf")))
        key = torch.where(torch.isnan(x), nan_key, _order_key(x))
        bits = int(np.float32(ext).view(np.int32))
        init = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    else:
        key = x
        info = torch.iinfo(x.dtype)
        init = info.max if take_min else info.min
    idx = _bx(seg.long(), key).expand(key.shape)
    out = torch.full((num_segments,) + tuple(key.shape[1:]), init,
                     dtype=key.dtype, device=key.device)
    out.scatter_reduce_(0, idx, key, reduce)
    return _order_key(out).view(torch.float32) if x.is_floating_point() \
        else out


def combine_segments(
    ch: Channel,
    payloads: tuple[torch.Tensor, ...],
    valid: torch.Tensor,
    dst: torch.Tensor,
    num_segments: int,
    plan: SegmentPlan | None = None,
) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """Combine per-edge payloads (E[, L]) into per-destination inboxes.

    Returns (combined payload tuple each (num_segments, ...), has_msg
    bool).  Invalid edges contribute the channel identity.  ``plan`` is
    :func:`segment_plan` of ``dst``, passed in where it is cached."""
    if plan is None:
        plan = segment_plan(dst, num_segments)
    has = segment_sum(valid.to(torch.int32), plan) > 0

    if ch.combiner == "sum":
        return tuple(segment_sum(torch.where(_bx(valid, p), p,
                                             torch.zeros_like(p)), plan)
                     for p in payloads), has

    if ch.combiner in ("min", "max"):
        return tuple(
            segment_select(torch.where(_bx(valid, p), p, ident), dst,
                           num_segments, ch.combiner)
            for p, (_, ident) in zip(payloads, ch.components)), has

    if ch.combiner == "lexmin":
        # cascaded masked segment-min: component k takes part only where
        # every earlier component equals its segment's minimum
        eligible = valid
        outs = []
        for p, (_, ident) in zip(payloads, ch.components):
            m = segment_select(torch.where(eligible, p, ident), dst,
                               num_segments, "min")
            outs.append(m)
            eligible = torch.logical_and(eligible, p == m[dst.long()])
        return tuple(outs), has

    raise ValueError(f"unknown combiner {ch.combiner!r}")
