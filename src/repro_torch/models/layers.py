"""Elementary layers: norms, rotary embeddings, MLPs, initializers (the port
of ``repro.models.layers``).

Parameters live in :class:`Params`, an ``nn.Module`` whose children carry
the reference's param-dict keys: ``p["wq"]`` reads as it does there, and
``state_dict`` names follow the reference's tree (a list becomes an
``nn.ModuleList``, so ``stack.head[0]`` is ``stack.head.0``).
``*_init(init, ...)`` draws from the explicit host generator of an
:class:`Init` and places the tensors on its device, so one seed gives the
same weights on every device.  Matmuls accumulate in float32 whatever the
storage dtype.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Init", "Params", "dense_init", "matmul", "f32_einsum",
           "norm_init", "norm_fwd", "rope_frequencies", "apply_rope",
           "sinusoidal_positions", "sinusoidal_position_at", "mlp_init",
           "mlp_fwd", "softcap", "embed_init"]


class Params(nn.Module):
    """A node of a parameter tree: tensors become its parameters, mappings
    its child nodes and lists an ``nn.ModuleList`` of nodes, each under the
    reference's key."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(key, value if isinstance(
                    value, nn.Parameter) else nn.Parameter(value))
            elif isinstance(value, Mapping):
                self.add_module(key, Params(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(key, nn.ModuleList(Params(v) for v in value))
            else:
                raise TypeError(f"{key!r}: cannot hold a {type(value)}")

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


@dataclasses.dataclass(frozen=True)
class Init:
    """Where parameters come from: an explicit host ``torch.Generator``,
    the storage dtype and the device.  Values are drawn on the host in
    float32 and then moved and cast; on the ``meta`` device nothing is
    drawn (shapes only)."""

    gen: torch.Generator
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cpu")

    def normal(self, shape, scale: float = 1.0, dtype=None) -> torch.Tensor:
        dtype = dtype or self.dtype
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device="meta")
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32)
        return (x * scale).to(self.device, dtype)

    def full(self, shape, value: float, dtype=None) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype or self.dtype,
                          device=self.device)


def dense_init(init: Init, d_in: int, d_out: int,
               scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return init.normal((d_in, d_out), scale)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 accumulation, result in x.dtype."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def f32_einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``einsum`` with float32 operands (the reference's
    ``preferred_element_type=float32``)."""
    return torch.einsum(eq, *(o.float() for o in ops))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(init: Init, d: int, kind: str) -> dict:
    p = {"scale": init.full((d,), 1.0)}
    if kind == "layernorm":
        p["bias"] = init.full((d,), 0.0)
    return p


def norm_fwd(p, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # pragma: no cover
        raise ValueError(kind)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, hd) rotated by per-position angles; positions (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)                # (hd/2,)
    angles = positions[..., :, None].float() * freqs          # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10_000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :d]


def sinusoidal_position_at(pos, d: int, device=None) -> torch.Tensor:
    """Single position -> (d,) sinusoid."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)
    ang = torch.as_tensor(pos, dtype=torch.float32,
                          device=device) / torch.pow(10_000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:d]


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _act(name: str):
    return {"silu": F.silu, "relu": F.relu,
            # jax.nn.gelu defaults to the tanh approximation
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def mlp_init(init: Init, d: int, f: int, kind: str) -> dict:
    if kind == "gated":
        return {"wi": dense_init(init, d, 2 * f),
                "wo": dense_init(init, f, d)}
    return {"wi": dense_init(init, d, f),
            "wo": dense_init(init, f, d)}


def mlp_fwd(p, x: torch.Tensor, kind: str, act: str) -> torch.Tensor:
    h = matmul(x, p["wi"])
    if kind == "gated":
        gate, up = h.chunk(2, dim=-1)
        h = _act(act)(gate) * up
    else:
        h = _act(act)(h)
    return matmul(h, p["wo"])


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
    return x


def embed_init(init: Init, vocab: int, d: int) -> torch.Tensor:
    return init.normal((vocab, d), 0.02)
