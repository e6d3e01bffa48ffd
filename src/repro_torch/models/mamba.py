"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) block (the port of
``repro.models.mamba``).

Chunked SSD: the sequence is split into chunks of Q; within a chunk the
output is an attention-like masked contraction, and across chunks a small
(H, P, N) state is carried by a loop (the reference's ``lax.scan``).
Decode is O(1): one state update per token.

Under a sequence-sharded decode the states are cut over the same group
(``cache_specs``: ``ssm`` by heads, ``conv`` by channels): each step
gathers the whole state (:func:`gather_state`), runs the one-device
update, and keeps this rank's shard (:func:`shard_state`), so every rank
computes what one device would.

All decays stay in log space until the last moment and are bounded above by
0 (A < 0), so every exp() is <= 1 — no overflow at any chunk size.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.layers import Init, dense_init, matmul, norm_fwd

__all__ = ["mamba_init", "mamba_cache_init", "mamba_fwd", "mamba_decode",
           "gather_state", "shard_state"]

# the sharded dimension of each state: conv (B, K-1, C) by channels, ssm
# (B, H, P, N) by heads
_STATE_DIM = {"conv": 2, "ssm": 1}


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    h = d_inner // cfg.ssm_head_dim
    return d_inner, h, cfg.ssm_state, cfg.ssm_head_dim


def mamba_init(init: Init, cfg) -> dict:
    d_inner, h, n, p_ = _dims(cfg)
    conv_ch = d_inner + 2 * n                     # x, B, C go through conv
    f32 = torch.float32
    return {
        "in_proj": dense_init(init, cfg.d_model, 2 * d_inner + 2 * n + h),
        "conv_w": init.normal((cfg.conv_dim, conv_ch),
                              1.0 / math.sqrt(cfg.conv_dim)),
        "conv_b": init.full((conv_ch,), 0.0),
        "A_log": init.full((h,), 0.0, f32),       # A = -exp(A_log) = -1
        "D": init.full((h,), 1.0, f32),
        "dt_bias": init.full((h,), 0.0, f32),
        "norm_scale": init.full((d_inner,), 1.0),
        "out_proj": dense_init(init, d_inner, cfg.d_model),
    }


def _causal_conv(xbc, w, b, conv_state=None):
    """Depthwise causal conv along S as a sum of shifted products, in the
    reference's order (not ``F.conv1d``: another summation order, and TF32
    by default on cuDNN).  xbc (B,S,C); w (K,C)."""
    k = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state                          # (B, K-1, C)
    xp = torch.cat([pad, xbc], dim=1)
    out = sum(xp[:, i:i + xbc.shape[1]] * w[i] for i in range(k))
    new_state = xp[:, xp.shape[1] - (k - 1):] if k > 1 else pad
    return F.silu(out + b), new_state


def mamba_cache_init(cfg, batch: int, dtype, device) -> dict:
    d_inner, h, n, p_ = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_dim - 1, d_inner + 2 * n),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, h, p_, n), dtype=torch.float32,
                           device=device),
    }


def _split_proj(proj, cfg):
    d_inner, h, n, p_ = _dims(cfg)
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:2 * d_inner + 2 * n]
    dt = proj[..., 2 * d_inner + 2 * n:]
    return z, xbc, dt


def mamba_fwd(p, u: torch.Tensor, cfg, cache=None):
    """Train/prefill path.  u (B,S,D) -> (y, new_cache)."""
    d_inner, h, n, p_ = _dims(cfg)
    b, s, _ = u.shape
    q = min(cfg.ssm_chunk, s)
    while s % q:
        q -= 1
    nc = s // q
    f32 = torch.float32

    proj = matmul(u, p["in_proj"])
    z, xbc, dt = _split_proj(proj, cfg)
    xbc, conv_state = _causal_conv(
        xbc, p["conv_w"], p["conv_b"],
        None if cache is None else cache["conv"])
    x = xbc[..., :d_inner].reshape(b, s, h, p_)
    bmat = xbc[..., d_inner:d_inner + n]                    # (B,S,N)
    cmat = xbc[..., d_inner + n:]                           # (B,S,N)

    a = -torch.exp(p["A_log"])                              # (H,) < 0
    dt = F.softplus(dt.to(f32) + p["dt_bias"])              # (B,S,H)
    da = dt * a                                             # (B,S,H) <= 0

    # ---- chunked SSD ------------------------------------------------------
    xc = x.reshape(b, nc, q, h, p_).to(f32)
    bc = bmat.reshape(b, nc, q, n).to(f32)
    cc = cmat.reshape(b, nc, q, n).to(f32)
    dtc = dt.reshape(b, nc, q, h)
    dac = da.reshape(b, nc, q, h)
    cum = torch.cumsum(dac, dim=2)                          # (B,nc,Q,H)
    cum_last = cum[:, :, -1:, :]                            # (B,nc,1,H)

    # per-chunk input state: sum_q exp(cum_last - cum_q) * dt_q * B_q ⊗ x_q
    wgt = torch.exp(cum_last - cum) * dtc                   # (B,nc,Q,H)
    chunk_state = torch.einsum("bcqh,bcqn,bcqhp->bchpn", wgt, bc, xc)

    # inter-chunk recurrence (sequential over nc chunks)
    chunk_decay = torch.exp(cum_last[:, :, 0, :])           # (B,nc,H)
    st = (torch.zeros((b, h, p_, n), dtype=f32, device=u.device)
          if cache is None else cache["ssm"])
    prev = []
    for c in range(nc):
        prev.append(st)                                     # state BEFORE chunk
        st = st * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    final_state = st
    prev_states = torch.stack(prev, dim=1)                  # (B,nc,H,P,N)

    # inter-chunk output: C_q · (prev_state decayed to q)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cc, prev_states) \
        * torch.exp(cum)[..., None]

    # intra-chunk (attention-like, causal within chunk)
    l = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])  # (B,nc,Q,Q,H)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=u.device))
    scores = torch.einsum("bcqn,bcsn->bcqs", cc, bc)        # (B,nc,Q,Q)
    scores = torch.where(causal[None, None], scores, 0.0)
    y_intra = torch.einsum("bcqs,bcqsh,bcsh,bcshp->bcqhp",
                           scores, torch.where(causal[None, None, :, :, None],
                                               l, 0.0),
                           dtc, xc)

    y = (y_inter + y_intra).reshape(b, s, h, p_)
    y = y + p["D"][None, None, :, None] * x.to(f32)
    y = y.reshape(b, s, d_inner).to(u.dtype)

    y = y * F.silu(z)
    y = norm_fwd({"scale": p["norm_scale"]}, y, "rmsnorm", cfg.norm_eps)
    y = matmul(y, p["out_proj"])
    new_cache = None if cache is None else {"conv": conv_state,
                                            "ssm": final_state}
    return y, new_cache


def mamba_decode(p, u: torch.Tensor, cfg, cache):
    """Single-token decode: O(1) state update.  u (B,1,D)."""
    d_inner, h, n, p_ = _dims(cfg)
    b = u.shape[0]
    f32 = torch.float32
    proj = matmul(u, p["in_proj"])
    z, xbc, dt = _split_proj(proj, cfg)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                   cache["conv"])
    x = xbc[:, 0, :d_inner].reshape(b, h, p_).to(f32)
    bvec = xbc[:, 0, d_inner:d_inner + n].to(f32)
    cvec = xbc[:, 0, d_inner + n:].to(f32)

    a = -torch.exp(p["A_log"])
    dt = F.softplus(dt[:, 0].to(f32) + p["dt_bias"])       # (B,H)
    decay = torch.exp(dt * a)                               # (B,H)

    st = cache["ssm"] * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, x, bvec)
    y = torch.einsum("bn,bhpn->bhp", cvec, st)
    y = y + p["D"][None, :, None] * x
    y = y.reshape(b, 1, d_inner).to(u.dtype)
    y = y * F.silu(z)
    y = norm_fwd({"scale": p["norm_scale"]}, y, "rmsnorm", cfg.norm_eps)
    y = matmul(y, p["out_proj"])
    return y, {"conv": conv_state, "ssm": st}


def _full_sizes(cfg) -> dict:
    d_inner, h, n, _ = _dims(cfg)
    return {"conv": d_inner + 2 * n, "ssm": h}


def gather_state(cache, cfg, group) -> dict:
    """The whole state from this rank's shards (a state the cache specs
    left whole stays as it is)."""
    from repro_torch.sharding.fsdp import all_gather_stack
    full = _full_sizes(cfg)
    out = {}
    for k, t in cache.items():
        d = _STATE_DIM[k]
        if t.shape[d] != full[k]:
            t = all_gather_stack(t, group).movedim(0, d).flatten(d, d + 1)
        out[k] = t
    return out


def shard_state(new, like, group) -> dict:
    """This rank's shard of each whole state, as ``like`` holds it."""
    r = dist.get_rank(group)
    out = {}
    for k, t in new.items():
        d, size = _STATE_DIM[k], like[k].shape[_STATE_DIM[k]]
        out[k] = t.narrow(d, r * size, size).contiguous() \
            if size != t.shape[d] else t
    return out
