"""Error-feedback int8 delta compression for the cross-pod phase (the port
of ``repro.optim.compression``).

The hybrid-sync global phase exchanges an accumulated parameter delta
across pods.  Before the wire, deltas are quantized to int8 with one scale
per leaf — over the leaf's whole tensor, the pod axis included when the
tree is pod-stacked; the quantization error is fed back into the next
round's accumulator.  Rounding is half to even (``torch.round``, as
``jnp.round``), so the int8 codes equal the reference's.  Trees are
mappings from names to tensors.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch

__all__ = ["ErrorFeedbackState", "ef_init", "ef_int8_compress",
           "ef_int8_decompress"]

Tensors = Mapping[str, torch.Tensor]


@dataclasses.dataclass
class ErrorFeedbackState:
    residual: dict


def ef_init(params: Tensors) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual={
        k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for k, p in params.items()})


@torch.no_grad()
def ef_int8_compress(tree: Tensors, ef: ErrorFeedbackState
                     ) -> tuple[dict, dict, ErrorFeedbackState]:
    """-> (q_int8, scales, new_ef).  Quantizes (tree + residual)."""
    q, scales, err = {}, {}, {}
    for k, x in tree.items():
        xf = x.float() + ef.residual[k]
        scale = torch.clamp(torch.amax(torch.abs(xf)), min=1e-12) / 127.0
        q[k] = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        scales[k] = scale
        err[k] = xf - q[k].float() * scale
    return q, scales, ErrorFeedbackState(residual=err)


def ef_int8_decompress(q: Tensors, scales: Tensors,
                       dtype=torch.float32) -> dict:
    return {k: (qq.float() * scales[k]).to(dtype) for k, qq in q.items()}
