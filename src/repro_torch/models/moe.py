"""Mixture-of-experts FFN with sort-based capacity dispatch (the port of
``repro.models.moe``).

Tokens are split into blocks; each block sorts its (token, choice) pairs
by expert (a stable sort), ranks them within their expert, and scatters
each to slot ``expert × capacity + rank``; pairs past the capacity go to
one overflow slot (``E·cap``) and are dropped.  Capacity is per (block,
expert), factor 1.25.  The expert outputs are gathered back, weighted by
their gates and scatter-added onto the tokens.  DeepSeek-style shared
experts are a fused dense MLP running alongside.

The reference's ``lax.top_k`` puts the lower expert first among equal
gates; ``torch.topk`` promises no order for ties, so the top k here are
the first k of a stable descending sort.  The reference's GSPMD hints
(``maybe_constrain``) have no counterpart on one device and are dropped.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.layers import Init, _act, dense_init, f32_einsum, matmul

__all__ = ["moe_init", "moe_fwd", "moe_aux_loss"]


def moe_init(init: Init, cfg) -> dict:
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.d_expert
    p = {
        "router": dense_init(init, d, e),
        "wi": init.normal((e, d, 2 * fe), 1.0 / math.sqrt(d)),
        "wo": init.normal((e, fe, d), 1.0 / math.sqrt(fe)),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * fe
        p["shared_wi"] = dense_init(init, d, 2 * fs)
        p["shared_wo"] = dense_init(init, fs, d)
    return p


def _n_blocks(t: int, target: int = 16) -> int:
    n = min(target, t)
    while t % n:
        n -= 1
    return n


def _top_k(gates: torch.Tensor, k: int):
    """The k largest gates and their experts, the lower expert first among
    equal gates (``lax.top_k``'s order)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_fwd(p, x: torch.Tensor, cfg, capacity_factor: float = 1.25):
    """x (B,S,D) -> (B,S,D).  Block-parallel dispatch, capacity per
    (block, expert)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    nblk = _n_blocks(t)
    tb = t // nblk
    cap = max(1, int(tb * k / e * capacity_factor))
    act = _act(cfg.act)
    dev = x.device

    xt = x.reshape(nblk, tb, d)
    logits = f32_einsum("ntd,de->nte", xt, p["router"])
    gates = torch.softmax(logits, dim=-1)                    # (nblk, tb, e)
    topg, topi = _top_k(gates, k)                            # (nblk, tb, k)
    topg = topg / torch.clamp(topg.sum(-1, keepdim=True), min=1e-9)

    flat_e = topi.reshape(nblk, tb * k)
    flat_g = topg.reshape(nblk, tb * k)
    flat_t = torch.arange(tb, device=dev).repeat_interleave(k)[None].expand(
        nblk, tb * k)

    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(-1, order)
    st = flat_t.gather(-1, order)
    sg = flat_g.gather(-1, order)

    # rank within (block, expert): position - start offset of the expert
    counts = torch.nn.functional.one_hot(flat_e, e).sum(dim=1)   # (nblk, e)
    start = torch.cumsum(counts, dim=-1) - counts
    pos = torch.arange(tb * k, device=dev)[None] - start.gather(-1, se)
    slot = torch.where(pos < cap, se * cap + pos, e * cap)   # overflow slot

    def rows(idx):
        return idx[..., None].expand(*idx.shape, d)

    gathered = xt.gather(1, rows(st))
    disp = torch.zeros((nblk, e * cap + 1, d), dtype=x.dtype, device=dev)
    disp = disp.scatter(1, rows(slot), gathered)  # only the overflow slot repeats
    h = disp[:, :-1].reshape(nblk, e, cap, d)

    hi = f32_einsum("necd,edf->necf", h, p["wi"]).to(x.dtype)
    gate, up = hi.chunk(2, dim=-1)
    ho = f32_einsum("necf,efd->necd", act(gate) * up, p["wo"]).to(x.dtype)

    y_slots = torch.cat([ho.reshape(nblk, e * cap, d),
                         torch.zeros((nblk, 1, d), dtype=x.dtype, device=dev)],
                        dim=1)
    contrib = y_slots.gather(1, rows(slot)) * sg[..., None].to(x.dtype)
    y = torch.zeros((nblk, tb, d), dtype=x.dtype, device=dev)
    y = y.scatter_add(1, rows(st), contrib)

    if cfg.n_shared_experts:
        hs = matmul(xt, p["shared_wi"])
        g2, u2 = hs.chunk(2, dim=-1)
        y = y + matmul(act(g2) * u2, p["shared_wo"])

    return y.reshape(b, s, d)


def moe_aux_loss(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Switch load-balance loss: E · Σ_e f_e · P_e (optional trainer term)."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    gates = torch.softmax(f32_einsum("td,de->te", xt, p["router"]), dim=-1)
    _, topi = _top_k(gates, cfg.top_k)
    hard = torch.zeros_like(gates).scatter(-1, topi, 1.0)
    f = torch.mean(hard, dim=0)
    pm = torch.mean(gates, dim=0)
    return cfg.n_experts * torch.sum(f * pm)
