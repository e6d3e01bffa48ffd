"""Attention: GQA (full / sliding-window) and MLA, with memory-bounded
chunked-flash prefill/train paths and one-device flash decode (the port
of ``repro.models.attention``).

* **Prefill/train** is plain PyTorch chunked flash attention: a loop over
  KV chunks with an online softmax (running max ``m``, sum ``l`` and
  accumulator, ``l`` floored at 1e-30), so long contexts never hold S×S
  scores.  Sliding-window layers slice one (window + chunk) KV band per
  query chunk.  Chunks are the reference's (``_divisor_chunk``), so the
  fold order, and with it the rounding, is the reference's.
* **Decode** attends one token to the cache.  Sliding-window caches are
  ring buffers of size W.  With ``decode_axis`` (a process group, or the
  name of a dimension of the ambient mesh) the cache a rank holds is its
  sequence shard, in group-rank order: rank r holds global rows
  [r·S, (r+1)·S) of a cache (or ring) of n·S rows.  Only the rank that
  owns the new token's row writes it; each rank's partial (m, ℓ, o) is
  merged with one all-gather, as the reference does across its mesh axis.
  Prefill with ``decode_axis`` writes each rank's own rows.
* **MLA** caches the compressed latent (c_kv, k_rope) and decodes in
  absorbed form through W_UK / W_UV.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (Init, apply_rope, dense_init,
                                       f32_einsum, matmul, norm_fwd)

NEG_INF = -1e30

__all__ = ["flash_attention", "decode_attention", "gqa_init", "gqa_fwd",
           "gqa_cache_init", "mla_init", "mla_fwd", "mla_cache_init",
           "cross_attn_init", "cross_attn_fwd"]


def _divisor_chunk(s: int, target: int) -> int:
    """Largest divisor of s that is <= target."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def _seq_shard(decode_axis):
    """(group, n, r): the process group that shards the cache's sequence,
    its size and this rank's place in it; (None, 1, 0) unsharded."""
    from repro_torch.sharding.fsdp import resolve_group
    group = resolve_group(decode_axis)
    if group is None:
        return None, 1, 0
    return group, dist.get_world_size(group), dist.get_rank(group)


def _write_rows(cache, rows, start: int, total: int):
    """Global rows ``rows`` (from global row 0) into this rank's shard of
    a cache of ``total`` rows whose shard begins at global row ``start``."""
    if rows.shape[1] > total:
        raise ValueError(f"prefill of {rows.shape[1]} positions: the cache "
                         f"holds {total}")
    part = rows[:, start:start + cache.shape[1]]
    if part.shape[1] == 0:
        return cache
    return torch.slice_scatter(cache, part, 1, 0, part.shape[1])


def _write_slot(cache, row, slot: int, start: int):
    """The new token's row at global ``slot``, written only by the shard
    that holds it."""
    if not start <= slot < start + cache.shape[1]:
        return cache
    return torch.slice_scatter(cache, row, 1, slot - start, slot - start + 1)


def _merge(m, l, o, group):
    """Flash partials of every shard merged (the reference's all-gather of
    o, m, ℓ, in one collective): the unnormalized output and its sum."""
    from repro_torch.core.distributed import all_gather_rows
    ms, ls, os_ = all_gather_rows([m[None], l[None], o[None]], group=group)
    m_g = torch.amax(ms, dim=0)
    corr = torch.exp(ms - m_g[None])
    return torch.sum(os_ * corr[..., None], dim=0), torch.sum(ls * corr, dim=0)


def _cache_slot(cur_len: int, max_len: int) -> int:
    """The cache row of the token at ``cur_len``.  The reference clamps a
    write past the end onto the last row; the port refuses it."""
    if not 0 <= cur_len < max_len:
        raise ValueError(f"decode at position {cur_len}: the cache holds "
                         f"{max_len} positions")
    return cur_len


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def gqa_init(init: Init, cfg) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(init, d, h * hd),
        "wk": dense_init(init, d, kvh * hd),
        "wv": dense_init(init, d, kvh * hd),
        "wo": dense_init(init, h * hd, d),
    }


def mla_init(init: Init, cfg) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    r, nope, rope, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                         cfg.v_head_dim)
    return {
        "wq": dense_init(init, d, h * (nope + rope)),
        "w_dkv": dense_init(init, d, r + rope),
        "w_uk": init.normal((r, h, nope), 1.0 / math.sqrt(r)),
        "w_uv": init.normal((r, h, vd), 1.0 / math.sqrt(r)),
        "wo": dense_init(init, h * vd, d),
        "kv_norm": init.full((r,), 1.0),
    }


# ---------------------------------------------------------------------------
# chunked flash attention (prefill / train)
# ---------------------------------------------------------------------------

def _block_attn(qb, kb, qpos, kpos, *, causal, window, cap, scale, kv_len,
                kv_start=None):
    """One (Cq, Ckv) block of masked scores (B,KVH,G,Cq,Ckv), f32."""
    s = f32_einsum("bqkgd,bskd->bkgqs", qb, kb) * scale
    if cap:
        s = cap * torch.tanh(s / cap)
    mask = kpos[None, :] < kv_len
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    mask = mask[None, None, None]
    if kv_start is not None:      # left-padded serving batches
        mask = mask & (kpos[None, :] >= kv_start[:, None])[:, None, None, None]
    return torch.where(mask, s, NEG_INF)


def flash_attention(q, k, v, *, causal=True, window=0, cap=0.0,
                    q_offset=0, kv_len=None, chunk_q=512, chunk_kv=1024,
                    scale=None, kv_start=None):
    """Memory-bounded attention.

    q (B,Sq,H,hd); k,v (B,Skv,KVH,hd).  ``q_offset`` is the global position
    of q[0] (prefill continuation); ``kv_len`` masks cache padding.
    """
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kv_len = skv if kv_len is None else kv_len
    cq = _divisor_chunk(sq, chunk_q)
    ckv = _divisor_chunk(skv, chunk_kv)
    nq, nkv = sq // cq, skv // ckv
    dev = q.device

    qr = q.reshape(b, nq, cq, kvh, g, hd)
    dtype = q.dtype

    # q, k and v reach a chunk as arguments, never closed over: inside the
    # stack's per-unit checkpoint, which drops every tensor saved in its
    # forward (the chunks' checkpointed inputs too), a tensor that the
    # chunk's function holds stays alive until the backward, and every
    # unit's remat carry would hold its q, k and v beside its input
    def q_chunk(qi, qb, k, v):
        qpos = q_offset + qi * cq + torch.arange(cq, device=dev)

        if window > 0:
            # one KV band of width (window + cq) covers the whole chunk
            band = min(window + cq, skv)
            start = min(max(q_offset + qi * cq - window + 1, 0), skv - band)
            kb = k[:, start:start + band]
            vb = v[:, start:start + band]
            kpos = start + torch.arange(band, device=dev)
            s = _block_attn(qb, kb, qpos, kpos, causal=causal, window=window,
                            cap=cap, scale=scale, kv_len=kv_len,
                            kv_start=kv_start)
            m = torch.amax(s, dim=-1)
            p = torch.exp(s - m[..., None])
            l = torch.sum(p, dim=-1)
            acc = f32_einsum("bkgqs,bskd->bqkgd", p.to(dtype), vb)
            out = acc / torch.clamp(l.permute(0, 3, 1, 2), min=1e-30)[..., None]
            return out.to(dtype)

        m = torch.full((b, kvh, g, cq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kvh, g, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kvh, g, cq, hd), dtype=torch.float32,
                          device=dev)
        for ki in range(nkv):
            kb = k[:, ki * ckv:(ki + 1) * ckv]
            vb = v[:, ki * ckv:(ki + 1) * ckv]
            kpos = ki * ckv + torch.arange(ckv, device=dev)
            s = _block_attn(qb, kb, qpos, kpos, causal=causal, window=0,
                            cap=cap, scale=scale, kv_len=kv_len,
                            kv_start=kv_start)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = f32_einsum("bkgqs,bskd->bkgqd", p.to(dtype), vb)
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]    # (b,kvh,g,cq,hd)
        return out.permute(0, 3, 1, 2, 4).to(dtype)

    # recompute each q chunk in the backward, as the reference does: without
    # it the backward keeps every score block, the full S×S matrix
    remat = nq > 1 and torch.is_grad_enabled()
    outs = [checkpoint(q_chunk, qi, qr[:, qi], k, v, use_reentrant=False)
            if remat else q_chunk(qi, qr[:, qi], k, v) for qi in range(nq)]
    return torch.stack(outs, dim=1).reshape(b, sq, h, hd)


# ---------------------------------------------------------------------------
# decode attention (single new token against a cache)
# ---------------------------------------------------------------------------

def decode_attention(q, k, v, kpos, cur_len, *, cap=0.0, window=0,
                     scale=None, axis_name=None, kv_start=None):
    """q (B,1,H,hd); k,v (B,S,KVH,hd) — this rank's cache shard with
    ``axis_name`` (a process group or an ambient mesh dimension's name),
    else the whole cache; kpos (S,) are the global positions of the cache
    rows.  Flash partials merge across shards with one small all-gather."""
    from repro_torch.sharding.fsdp import resolve_group
    group = resolve_group(axis_name)
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)

    qr = q.reshape(b, kvh, g, hd)
    s = f32_einsum("bkgd,bskd->bkgs", qr, k) * scale
    if cap:
        s = cap * torch.tanh(s / cap)
    valid = kpos < cur_len
    if window > 0:
        valid = valid & (kpos > cur_len - 1 - window)
    valid = valid & (kpos >= 0)                  # unwritten ring slots
    valid = valid[None, None, None]
    if kv_start is not None:
        valid = valid & (kpos[None, :] >= kv_start[:, None])[:, None, None]
    s = torch.where(valid, s, NEG_INF)

    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = f32_einsum("bkgs,bskd->bkgd", p.to(q.dtype), v)
    if group is not None:
        o, l = _merge(m, l, o, group)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, 1, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA layer forward (train/prefill & decode), cache management
# ---------------------------------------------------------------------------

def gqa_cache_init(cfg, spec, batch: int, max_len: int, dtype,
                   device) -> dict:
    s = min(max_len, spec.window) if spec.attn == "window" else max_len
    shape = (batch, s, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_fwd(p, x, spec, cfg, *, positions, cache=None, cur_len=None,
            decode_axis=None, kv_start=None):
    """Returns (y, new_cache).  Train/prefill when cache is None or being
    filled; decode when x has one token and ``cur_len`` (an int) is set.
    The cache is never written in place: the new one is returned."""
    b, s, d = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = matmul(x, p["wq"]).reshape(b, s, h, hd)
    k = matmul(x, p["wk"]).reshape(b, s, kvh, hd)
    v = matmul(x, p["wv"]).reshape(b, s, kvh, hd)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    window = spec.window if spec.attn == "window" else 0
    causal = getattr(spec, "causal", True)

    if cache is None or s > 1:                    # train, or prefill
        y = flash_attention(q, k, v, causal=causal, window=window,
                            cap=cfg.softcap_attn, kv_start=kv_start)
        new_cache = None
        if cache is not None:
            _, n, r = _seq_shard(decode_axis)
            local = cache["k"].shape[1]
            cs = local * n
            if window > 0 and s > cs:
                # ring buffer: keep the last cs positions, each at slot p % cs
                k = torch.roll(k[:, -cs:], s % cs, dims=1)
                v = torch.roll(v[:, -cs:], s % cs, dims=1)
            new_cache = {"k": _write_rows(cache["k"], k, r * local, cs),
                         "v": _write_rows(cache["v"], v, r * local, cs)}
    else:                                         # decode step
        group, n, r = _seq_shard(decode_axis)
        cur_len = int(cur_len)
        local = cache["k"].shape[1]
        cs, start = local * n, r * local
        slot = (cur_len % cs) if window > 0 else _cache_slot(cur_len, cs)
        ck = _write_slot(cache["k"], k, slot, start)
        cv = _write_slot(cache["v"], v, slot, start)
        idx = start + torch.arange(local, device=x.device)
        if window > 0:
            # ring buffer: reconstruct global positions of each slot
            wraps = (cur_len + 1 + cs - 1) // cs
            kpos = torch.where(idx <= slot, idx + (wraps - 1) * cs,
                               idx + (wraps - 2) * cs)
            kpos = torch.where(idx == slot, cur_len, kpos)
        else:
            kpos = idx
        y = decode_attention(q, ck, cv, kpos, cur_len + 1,
                             cap=cfg.softcap_attn, window=window,
                             axis_name=group, kv_start=kv_start)
        new_cache = {"k": ck, "v": cv}

    y = matmul(y.reshape(b, s, h * hd), p["wo"])
    return y, new_cache


# ---------------------------------------------------------------------------
# MLA layer forward
# ---------------------------------------------------------------------------

def mla_cache_init(cfg, batch: int, max_len: int, dtype, device) -> dict:
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
    }


def _mla_expand(p, c_kv, k_rope, cfg):
    """Latent -> per-head K/V (prefill path)."""
    k_nope = torch.einsum("bsr,rhn->bshn", c_kv, p["w_uk"])
    v = torch.einsum("bsr,rhn->bshn", c_kv, p["w_uv"])
    k_r = k_rope[:, :, None, :].expand(*k_nope.shape[:3], cfg.qk_rope_dim)
    k = torch.cat([k_nope, k_r], dim=-1)
    return k.to(c_kv.dtype), v.to(c_kv.dtype)


def mla_fwd(p, x, spec, cfg, *, positions, cache=None, cur_len=None,
            decode_axis=None, kv_start=None):
    b, s, d = x.shape
    h = cfg.n_heads
    nope, rope, r, vd = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank,
                         cfg.v_head_dim)
    qd = nope + rope
    scale = 1.0 / math.sqrt(qd)

    q = matmul(x, p["wq"]).reshape(b, s, h, qd)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    dkv = matmul(x, p["w_dkv"])
    c_kv, k_rope = dkv[..., :r], dkv[..., r:]
    c_kv = norm_fwd({"scale": p["kv_norm"]}, c_kv, "rmsnorm", cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]

    if cache is None or s > 1:                    # train / prefill: expand
        new_cache = None
        if cache is not None:
            _, n, r = _seq_shard(decode_axis)
            local = cache["c_kv"].shape[1]
            new_cache = {
                "c_kv": _write_rows(cache["c_kv"], c_kv, r * local, n * local),
                "k_rope": _write_rows(cache["k_rope"], k_rope, r * local,
                                      n * local)}
        k, v = _mla_expand(p, c_kv, k_rope, cfg)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        # pad V up to the qk head dim so every block has one head width
        y = flash_attention(qq, k, F.pad(v, (0, qd - vd)), causal=True,
                            cap=0.0, scale=scale, kv_start=kv_start)
        y = y[..., :vd]
    else:                                         # absorbed decode
        group, n, rk = _seq_shard(decode_axis)
        local = cache["c_kv"].shape[1]
        start = rk * local
        cur_len = _cache_slot(int(cur_len), local * n)
        c = _write_slot(cache["c_kv"], c_kv, cur_len, start)
        kr = _write_slot(cache["k_rope"], k_rope, cur_len, start)
        new_cache = {"c_kv": c, "k_rope": kr}
        # fold q through W_UK: (b,1,h,nope) @ (r,h,nope) -> (b,1,h,r)
        q_eff = torch.einsum("bqhn,rhn->bqhr", q_nope, p["w_uk"])
        kpos = start + torch.arange(local, device=x.device)
        s_lat = f32_einsum("bqhr,bsr->bhqs", q_eff, c)
        s_rope = f32_einsum("bqhn,bsn->bhqs", q_rope, kr)
        sc = (s_lat + s_rope) * scale
        valid = (kpos < (cur_len + 1))[None, None, None]
        if kv_start is not None:
            valid = valid & (kpos[None, :] >= kv_start[:, None])[:, None, None]
        sc = torch.where(valid, sc, NEG_INF)
        m = torch.amax(sc, dim=-1)
        pr = torch.exp(sc - m[..., None])
        l = torch.sum(pr, dim=-1)
        o_lat = f32_einsum("bhqs,bsr->bhqr", pr.to(x.dtype), c)
        if group is not None:
            o_lat, l = _merge(m, l, o_lat, group)
        o_lat = o_lat / torch.clamp(l, min=1e-30)[..., None]
        y = torch.einsum("bhqr,rhn->bqhn", o_lat.to(x.dtype), p["w_uv"])

    y = matmul(y.reshape(b, s, h * vd), p["wo"])
    return y, new_cache


# ---------------------------------------------------------------------------
# cross attention (whisper decoder)
# ---------------------------------------------------------------------------

def cross_attn_init(init: Init, cfg) -> dict:
    return gqa_init(init, cfg)


def cross_attn_fwd(p, x, enc, cfg):
    b, s, d = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = matmul(x, p["wq"]).reshape(b, s, h, hd)
    k = matmul(enc, p["wk"]).reshape(b, enc.shape[1], kvh, hd)
    v = matmul(enc, p["wv"]).reshape(b, enc.shape[1], kvh, hd)
    y = flash_attention(q, k, v, causal=False, chunk_q=min(512, s),
                        chunk_kv=min(1024, enc.shape[1]))
    return matmul(y.reshape(b, s, h * hd), p["wo"])
