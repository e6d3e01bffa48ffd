"""Incremental (accumulative) PageRank (paper §6.2, Algorithm 5).

Each vertex accumulates delta updates into its rank; when the received delta
exceeds the tolerance Δ it propagates ``0.85 * delta / out_degree`` to its
neighbours (the edge weight is pre-set to ``1/out_degree(src)`` by
:func:`pagerank_edge_weights`).  The fixed point of
``rank = 0.15 + 0.85 Σ rank/deg`` is N × the normalized PageRank vector.

Sum channel ⇒ the export buffer *accumulates* deltas between exchanges
(``accumulate_export``) and resets to zero after each exchange
(``export_identity``) — the GraphHP SourceCombine() with an additive rule.

``damping`` and ``tolerance`` enter float32 arithmetic rounded to float32,
as the reference's weak-typed Python scalars do.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.vertex_program import Channel, StepInfo, VertexProgram
from repro_torch.kernels.common import f32


class IncrementalPageRank(VertexProgram):
    channels = (Channel("delta", "sum", ((torch.float32, 0.0),),
                        semiring="add_mul"),)
    boundary_participates = True
    # the hybrid engine runs the whole local phase through the fused
    # `pr_step` kernel: sum channel, always-emitting, never self-activating,
    # strictly positive contributions (w > 0, delta > tol)
    fused_kernel = "pr_step"

    def __init__(self, tolerance: float = 1e-4, damping: float = 0.85):
        self.tol = float(tolerance)
        self.damping = float(damping)

    def init(self, gid, vmask, vdata):
        base = torch.where(vmask, f32(0.15), 0.0).to(torch.float32)
        return {"rank": base}, {"delta": base}, vmask, torch.zeros_like(vmask)

    def emit(self, ch, out_src, w, src_gid, dst_gid):
        return ((f32(self.damping) * out_src["delta"]) * w,), \
            torch.ones(w.shape, dtype=torch.bool, device=w.device)

    def ell_payload(self, ch, out, send):
        # message = (damping * delta)[src] * w; non-senders contribute 0
        return torch.where(send, f32(self.damping) * out["delta"], 0.0)

    def apply(self, state, inbox, gid, vmask, vdata, info: StepInfo):
        (delta,), has = inbox["delta"]
        delta = torch.where(has, delta, 0.0)
        rank = state["rank"] + delta
        send = delta > f32(self.tol)
        return {"rank": rank}, {"delta": delta}, send, torch.zeros_like(send)

    # ---- additive SourceCombine ----------------------------------------
    def accumulate_export(self, acc_out, acc_send, new_out, new_send):
        acc = acc_out["delta"] + torch.where(new_send, new_out["delta"], 0.0)
        return {"delta": acc}, torch.logical_or(acc_send, new_send)

    def export_identity(self, out):
        return {"delta": torch.zeros_like(out["delta"])}


def pagerank_edge_weights(edges, n_vertices):
    """1/out_degree(src) per edge — what Algorithm 5's send loop divides by."""
    deg = np.bincount(edges[:, 0], minlength=n_vertices).astype(np.float32)
    return 1.0 / np.maximum(deg[edges[:, 0]], 1.0)
