"""Single-source shortest paths (paper §6.1, Algorithm 4).

Min-combiner over distance messages; a vertex relaxes and re-sends only when
its value improves; always votes to halt.  Incremental (monotone min), so
boundary vertices participate in local phases (paper recommendation).
"""

from __future__ import annotations

import torch

from repro_torch.core.vertex_program import Channel, StepInfo, VertexProgram
from repro_torch.kernels.common import minimum

INF = float("inf")


class SSSP(VertexProgram):
    channels = (Channel("dist", "min", ((torch.float32, INF),),
                        semiring="min_add"),)
    boundary_participates = True
    # the hybrid engine runs the whole local phase through the fused
    # `min_step` kernel: single min_add channel, out == state,
    # relax-on-improve apply, never self-activating, keep-latest export
    fused_kernel = "min_step"

    def __init__(self, source: int):
        self.source = source

    def init(self, gid, vmask, vdata):
        is_src = gid == self.source
        dist = torch.where(is_src, 0.0, INF).to(torch.float32)
        send = torch.logical_and(is_src, vmask)
        active = torch.zeros_like(vmask)          # voteToHalt()
        return {"dist": dist}, {"dist": dist}, send, active

    def emit(self, ch, out_src, w, src_gid, dst_gid):
        return (out_src["dist"] + w,), torch.ones(w.shape, dtype=torch.bool,
                                                  device=w.device)

    def ell_payload(self, ch, out, send):
        # message = dist[src] + w; non-senders relax to +inf (min identity)
        return torch.where(send, out["dist"], INF)

    def apply(self, state, inbox, gid, vmask, vdata, info: StepInfo):
        (msg,), has = inbox["dist"]
        new = minimum(state["dist"], torch.where(has, msg, INF))
        send = new < state["dist"]
        return {"dist": new}, {"dist": new}, send, torch.zeros_like(send)
