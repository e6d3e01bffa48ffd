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
``(P, Vp[, L])`` tensors.  The dense segment combine (``combine_segments``)
serves only the dense delivery path, which this slice of the port does not
carry yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

__all__ = ["Channel", "VertexProgram", "StepInfo", "INT_INF"]

INT_INF = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class Channel:
    """A typed message channel with a monoid combiner.

    combiner: 'sum' | 'min' | 'max' | 'lexmin'.
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
