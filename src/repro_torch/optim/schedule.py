"""LR schedules (functions of the step), float32 tensors as in the
reference (the port of ``repro.optim.schedule``)."""

from __future__ import annotations

import math

import torch

__all__ = ["linear_warmup", "cosine_schedule"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(step, warmup: int, peak: float) -> torch.Tensor:
    return peak * torch.clamp((_f32(step) + 1) / max(warmup, 1), max=1.0)


def cosine_schedule(step, warmup: int, total: int, peak: float,
                    floor: float = 0.0) -> torch.Tensor:
    step = _f32(step)
    warm = linear_warmup(step, warmup, peak)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * t))
    return torch.where(step < warmup, warm, cos)
