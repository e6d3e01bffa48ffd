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

__all__ = ["ErrorFeedbackState", "ef_init", "quantize", "ef_int8_compress",
           "ef_int8_decompress"]

Tensors = Mapping[str, torch.Tensor]


@dataclasses.dataclass
class ErrorFeedbackState:
    residual: dict


def ef_init(params: Tensors) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual={
        k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for k, p in params.items()})


def quantize(xf: torch.Tensor, absmax: torch.Tensor):
    """-> (q_int8, scale, error) of ``xf`` at the scale ``absmax`` / 127
    (``absmax``: the largest |value| of the whole leaf, which may span
    more than ``xf``)."""
    # the divisor is a tensor on the operand's device: PyTorch's CUDA
    # division by a Python number (a CPU scalar) multiplies by its float32
    # reciprocal instead, which rounds apart from a division (and from the
    # host's and the reference's) for about one value in 20
    scale = torch.clamp(absmax, min=1e-12) / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale, xf - q.float() * scale


@torch.no_grad()
def ef_int8_compress(tree: Tensors, ef: ErrorFeedbackState
                     ) -> tuple[dict, dict, ErrorFeedbackState]:
    """-> (q_int8, scales, new_ef).  Quantizes (tree + residual)."""
    q, scales, err = {}, {}, {}
    for k, x in tree.items():
        xf = x.float() + ef.residual[k]
        q[k], scales[k], err[k] = quantize(xf, torch.amax(torch.abs(xf)))
    return q, scales, ErrorFeedbackState(residual=err)


def ef_int8_decompress(q: Tensors, scales: Tensors,
                       dtype=torch.float32) -> dict:
    return {k: (qq.float() * scales[k]).to(dtype) for k, qq in q.items()}
