"""AdamW from scratch, with dtype-configurable moments (the port of
``repro.optim.adamw``).

The reference's own formula, not ``torch.optim.AdamW`` (whose decoupled
decay and ``eps`` placement round differently): global-norm clipping,
bias-corrected ``mh / (sqrt(vh) + eps) + wd * p``, then ``p - lr * delta``,
all in float32.  Parameters, gradients and moments are mappings from the
model's parameter names (``model.named_parameters()``) to tensors; the
state stays explicit (:class:`AdamWState`), so it checkpoints and crosses
to the reference (``repro_torch.convert``) like any other tree.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch
from torch import nn

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm"]

Tensors = Mapping[str, torch.Tensor]


@dataclasses.dataclass
class AdamWState:
    mu: dict
    nu: dict
    step: torch.Tensor


def named(params: nn.Module | Tensors) -> dict[str, torch.Tensor]:
    """A model's parameters by name, or a mapping as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params: nn.Module | Tensors,
               moment_dtype=torch.float32) -> AdamWState:
    params = named(params)
    device = next(iter(params.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
             for k, p in params.items()}
    return AdamWState(mu=zeros, nu={k: z.clone() for k, z in zeros.items()},
                      step=torch.zeros((), dtype=torch.int32, device=device))


def global_norm(tree: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree.values()))


@torch.no_grad()
def adamw_update(
    params: nn.Module | Tensors,
    grads: Tensors,
    state: AdamWState,
    lr: torch.Tensor | float,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
) -> tuple[dict[str, torch.Tensor], AdamWState]:
    """-> (new parameters by name, new state); nothing is written in
    place."""
    params = named(params)
    keys = list(params)
    step = state.step + 1
    gn = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-12), max=1.0)

    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    # the reference's per-leaf formula, op for op, over all leaves at once
    # (``_foreach`` ops round each element as the single-tensor ops do);
    # the in-place ops only reuse temporaries
    f, fi = torch._foreach_mul, torch._foreach_mul_
    p32 = [params[k].float() for k in keys]
    g = f([grads[k].float() for k in keys], scale)
    m_new = f([state.mu[k].float() for k in keys], b1)
    torch._foreach_add_(m_new, f(g, 1 - b1))
    v_new = f([state.nu[k].float() for k in keys], b2)
    sq = f(g, g)
    fi(sq, 1 - b2)
    torch._foreach_add_(v_new, sq)
    del g, sq
    delta = torch._foreach_div(m_new, c1)                    # mh
    den = torch._foreach_div(v_new, c2)                      # vh
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(delta, den)
    del den
    torch._foreach_add_(delta, f(p32, weight_decay))
    fi(delta, lr.to(p32[0].device) if isinstance(lr, torch.Tensor) else lr)
    p_new = torch._foreach_sub(p32, delta)
    return ({k: p_new[i].to(params[k].dtype) for i, k in enumerate(keys)},
            AdamWState(
                mu={k: m_new[i].to(state.mu[k].dtype)
                    for i, k in enumerate(keys)},
                nu={k: v_new[i].to(state.nu[k].dtype)
                    for i, k in enumerate(keys)},
                step=step))
