"""Single-source widest (maximum-capacity / bottleneck) paths.

The max-min twin of SSSP: the capacity of a path is the *minimum*
capacity of its edges, and every vertex keeps the *maximum* such
bottleneck over all paths from the source — the (max, min) semiring.  A
vertex raises its capacity and re-sends only when it improves; always
votes to halt.  Monotone, so boundary vertices join local phases and the
whole local phase fuses through `min_step` with ⊕ = max, ⊗ = min.
"""

from __future__ import annotations

import torch

from repro_torch.core.vertex_program import Channel, StepInfo, VertexProgram
from repro_torch.kernels.common import maximum, minimum

NINF = float("-inf")


class WidestPath(VertexProgram):
    channels = (Channel("cap", "max", ((torch.float32, NINF),),
                        semiring="max_min"),)
    boundary_participates = True
    # single max/max_min channel, out == state, adopt-if-better apply,
    # never self-activating, keep-latest export: the min_step contract
    fused_kernel = "min_step"

    def __init__(self, source: int):
        self.source = source

    def init(self, gid, vmask, vdata):
        is_src = gid == self.source
        cap = torch.where(is_src, float("inf"), NINF).to(torch.float32)
        send = torch.logical_and(is_src, vmask)
        return {"cap": cap}, {"cap": cap}, send, torch.zeros_like(vmask)

    def emit(self, ch, out_src, w, src_gid, dst_gid):
        # path capacity through this edge: bottleneck of sender and edge
        return (minimum(out_src["cap"], w),), \
            torch.ones(w.shape, dtype=torch.bool, device=w.device)

    def ell_payload(self, ch, out, send):
        # message = min(cap[src], w); non-senders flatten to -inf (max id.)
        return torch.where(send, out["cap"], NINF)

    def apply(self, state, inbox, gid, vmask, vdata, info: StepInfo):
        (msg,), has = inbox["cap"]
        new = maximum(state["cap"], torch.where(has, msg, NINF))
        send = new > state["cap"]
        return {"cap": new}, {"cap": new}, send, torch.zeros_like(send)
