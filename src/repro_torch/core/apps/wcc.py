"""Weakly-connected components by min-label propagation.

The classic Pregel "HashMin" program: every vertex repeatedly adopts the
smallest component label it hears about.  A high-diameter component
converges in O(P) global iterations on GraphHP against O(diameter)
supersteps on Hama (the paper's Single Pivot discussion, §1).  Run on a
symmetrized edge list.

Labels are int32.  They ride the float32 kernels only where every value
is exact there: :func:`repro_torch.core.runtime.ell_f32_exact` per ELL bin
for delivery, and the fused-phase gate for the whole state.
"""

from __future__ import annotations

import torch

from repro_torch.core.vertex_program import Channel, StepInfo, VertexProgram
from repro_torch.kernels.common import minimum

_IMAX = torch.iinfo(torch.int32).max


class WCC(VertexProgram):
    channels = (Channel("label", "min", ((torch.int32, _IMAX),),
                        semiring="min_add"),)
    boundary_participates = True
    # min-label propagation fuses through `min_step` like SSSP, below
    # 2**24 vertices (the gate keeps larger integer states off the float32
    # loop; per-bin ELL delivery still applies where the bin allows)
    fused_kernel = "min_step"

    def init(self, gid, vmask, vdata):
        label = torch.where(vmask, gid, _IMAX).to(torch.int32)
        return {"label": label}, {"label": label}, vmask, \
            torch.zeros_like(vmask)

    def emit(self, ch, out_src, w, src_gid, dst_gid):
        return (out_src["label"],), torch.ones(w.shape, dtype=torch.bool,
                                               device=w.device)

    # kernel path: labels ride min_add with zeroed edge values
    def ell_payload(self, ch, out, send):
        return torch.where(send, out["label"].to(torch.float32),
                           float("inf"))

    def ell_edge_values(self, ch, val):
        return torch.zeros_like(val)

    def apply(self, state, inbox, gid, vmask, vdata, info: StepInfo):
        (msg,), has = inbox["label"]
        new = minimum(state["label"], torch.where(has, msg, _IMAX))
        send = new < state["label"]
        return {"label": new}, {"label": new}, send, torch.zeros_like(send)
