"""Top-level models: decoder LM, encoder-decoder (whisper), VLM (internvl)
(the port of ``repro.models.transformer``).

All share one API (see registry.ModelAPI):

  init(gen, cfg, dtype, device)                  -> model (nn.Module)
  forward(model, batch, cfg)                     -> logits           (train)
  init_cache(cfg, batch, max_len, dtype, device) -> cache
  prefill(model, batch, cache, cfg)              -> (last_logits, cache)
  decode_step(model, token, cache, cur_len, cfg) -> (logits, cache)

``batch`` is a dict: tokens (B,S) int [+ vis_embed (B,Tv,Dv) for vlm,
audio_embed (B,F,D) for audio, start (B,) left-pad offsets for serving].
``cur_len`` is a Python int: the number of tokens already in the cache.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.device import resolve_device
from repro_torch.models.layers import (Init, Params, dense_init, embed_init,
                                       matmul, norm_fwd, norm_init,
                                       sinusoidal_position_at,
                                       sinusoidal_positions, softcap)
from repro_torch.models.stack import stack_cache_init, stack_fwd, stack_init
from repro_torch.sharding.util import maybe_constrain


def _init(gen: torch.Generator, dtype, device) -> Init:
    return Init(gen, dtype, resolve_device(device))


# ---------------------------------------------------------------------------
# decoder-only LM (phi, gemma, granite, deepseek, mamba, jamba)
# ---------------------------------------------------------------------------

def _lm_tree(init: Init, cfg: ArchConfig) -> dict:
    p = {
        "embed": embed_init(init, cfg.vocab, cfg.d_model),
        "stack": stack_init(init, cfg, cfg.layers()),
        "final_norm": norm_init(init, cfg.d_model, cfg.norm),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(init, cfg.d_model, cfg.vocab)
    return p


def lm_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
            device=None) -> Params:
    return Params(_lm_tree(_init(gen, dtype, device), cfg))


def _logits(p, x, cfg: ArchConfig):
    x = norm_fwd(p["final_norm"], x, cfg.norm, cfg.norm_eps)
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    logits = maybe_constrain(torch.matmul(x.float(), w.float()),
                             "data", None, "model")
    return softcap(logits, cfg.softcap_final)


def lm_forward(p, batch, cfg: ArchConfig, *, remat=True):
    tokens = batch["tokens"]
    x = maybe_constrain(p["embed"][tokens], "data", None, None)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, _ = stack_fwd(p["stack"], x, cfg, cfg.layers(), positions=positions,
                     remat=remat)
    return _logits(p, x, cfg)


def lm_cache_init(cfg: ArchConfig, batch: int, max_len: int,
                  dtype=torch.float32, device=None) -> dict:
    return stack_cache_init(cfg, cfg.layers(), batch, max_len, dtype,
                            resolve_device(device))


def lm_prefill(p, batch, cache, cfg: ArchConfig, decode_axis=None):
    """``decode_axis``: the cache is this rank's sequence shard over that
    group (see ``models.attention``)."""
    tokens = batch["tokens"]
    x = p["embed"][tokens]
    start = batch.get("start")          # (B,) left-pad offsets (serving)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    if start is not None:
        positions = torch.clamp(positions[None, :] - start[:, None], min=0)
    x, cache = stack_fwd(p["stack"], x, cfg, cfg.layers(),
                         positions=positions, cache=cache, cur_len=0,
                         decode_axis=decode_axis, kv_start=start)
    return _logits(p, x[:, -1:], cfg), cache


def lm_decode_step(p, token, cache, cur_len, cfg: ArchConfig,
                   decode_axis=None, kv_start=None):
    """token (B,1) int; cur_len = #tokens already in the cache."""
    x = p["embed"][token]
    if kv_start is not None:
        positions = torch.clamp(cur_len - kv_start, min=0)[:, None]
    else:
        positions = torch.full(token.shape, int(cur_len), dtype=torch.int64,
                               device=token.device)
    x, cache = stack_fwd(p["stack"], x, cfg, cfg.layers(),
                         positions=positions, cache=cache, cur_len=cur_len,
                         decode=True, decode_axis=decode_axis,
                         kv_start=kv_start)
    return _logits(p, x, cfg), cache


# ---------------------------------------------------------------------------
# encoder-decoder (whisper): conv/mel frontend is a stub — the batch carries
# precomputed frame embeddings (B, F, d_model).
# ---------------------------------------------------------------------------

def _enc_layers(cfg) -> tuple[LayerSpec, ...]:
    return (LayerSpec(mixer="attn", attn="full", causal=False),) * cfg.enc_layers


def _dec_layers(cfg) -> tuple[LayerSpec, ...]:
    return (LayerSpec(mixer="attn", attn="full", cross=True),) * cfg.n_layers


def _with_pattern(cfg: ArchConfig, layers):
    pat = (layers[0],) if layers else (LayerSpec(),)   # 0-layer cost probes
    return dataclasses.replace(cfg, pattern=pat, n_layers=len(layers))


def encdec_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
                device=None) -> Params:
    init = _init(gen, dtype, device)
    enc_cfg = _with_pattern(cfg, _enc_layers(cfg))
    dec_cfg = _with_pattern(cfg, _dec_layers(cfg))
    return Params({
        "frontend_proj": dense_init(init, cfg.d_model, cfg.d_model),
        "embed": embed_init(init, cfg.vocab, cfg.d_model),
        "enc_stack": stack_init(init, enc_cfg, _enc_layers(cfg)),
        "enc_norm": norm_init(init, cfg.d_model, cfg.norm),
        "stack": stack_init(init, dec_cfg, _dec_layers(cfg)),
        "final_norm": norm_init(init, cfg.d_model, cfg.norm),
        "lm_head": dense_init(init, cfg.d_model, cfg.vocab),
    })


def encode(p, batch, cfg: ArchConfig):
    frames = batch["audio_embed"].to(p["embed"].dtype)
    x = matmul(frames, p["frontend_proj"])
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(x.dtype)
    enc_cfg = _with_pattern(cfg, _enc_layers(cfg))
    x, _ = stack_fwd(p["enc_stack"], x, enc_cfg, _enc_layers(cfg),
                     positions=torch.arange(x.shape[1], device=x.device))
    return norm_fwd(p["enc_norm"], x, cfg.norm, cfg.norm_eps)


def _dec_embed(p, tokens, cfg):
    x = p["embed"][tokens]
    return x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                    x.device).to(x.dtype)


def _head(p, x, cfg):
    x = norm_fwd(p["final_norm"], x, cfg.norm, cfg.norm_eps)
    return torch.matmul(x.float(), p["lm_head"].float())


def encdec_forward(p, batch, cfg: ArchConfig, *, remat=True):
    enc = encode(p, batch, cfg)
    tokens = batch["tokens"]
    dec_cfg = _with_pattern(cfg, _dec_layers(cfg))
    x, _ = stack_fwd(p["stack"], _dec_embed(p, tokens, cfg), dec_cfg,
                     _dec_layers(cfg),
                     positions=torch.arange(tokens.shape[1],
                                            device=tokens.device),
                     enc=enc, remat=remat)
    return _head(p, x, cfg)


def encdec_cache_init(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.float32, device=None) -> dict:
    device = resolve_device(device)
    dec_cfg = _with_pattern(cfg, _dec_layers(cfg))
    return {"dec": stack_cache_init(dec_cfg, _dec_layers(cfg), batch,
                                    max_len, dtype, device),
            "enc_out": torch.zeros((batch, cfg.enc_frames, cfg.d_model),
                                   dtype=dtype, device=device)}


def encdec_prefill(p, batch, cache, cfg: ArchConfig, decode_axis=None):
    enc = encode(p, batch, cfg)
    tokens = batch["tokens"]
    dec_cfg = _with_pattern(cfg, _dec_layers(cfg))
    x, dec_cache = stack_fwd(p["stack"], _dec_embed(p, tokens, cfg), dec_cfg,
                             _dec_layers(cfg),
                             positions=torch.arange(tokens.shape[1],
                                                    device=tokens.device),
                             enc=enc, cache=cache["dec"], cur_len=0,
                             decode_axis=decode_axis)
    return _head(p, x[:, -1:], cfg), {"dec": dec_cache, "enc_out": enc}


def encdec_decode_step(p, token, cache, cur_len, cfg: ArchConfig,
                       decode_axis=None):
    x = p["embed"][token]
    x = x + sinusoidal_position_at(cur_len, cfg.d_model,
                                   x.device)[None, None, :].to(x.dtype)
    dec_cfg = _with_pattern(cfg, _dec_layers(cfg))
    x, dec_cache = stack_fwd(p["stack"], x, dec_cfg, _dec_layers(cfg),
                             positions=torch.full(token.shape, int(cur_len),
                                                  device=token.device),
                             enc=cache["enc_out"], cache=cache["dec"],
                             cur_len=cur_len, decode=True,
                             decode_axis=decode_axis)
    return _head(p, x, cfg), {"dec": dec_cache, "enc_out": cache["enc_out"]}


# ---------------------------------------------------------------------------
# VLM (internvl): ViT frontend is a stub — batch carries precomputed patch
# embeddings (B, Tv, vis_dim), projected and prepended to the token stream.
# ---------------------------------------------------------------------------

def vlm_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
             device=None) -> Params:
    init = _init(gen, dtype, device)
    p = _lm_tree(init, cfg)
    p["vis_proj"] = dense_init(init, cfg.vis_dim, cfg.d_model)
    return Params(p)


def _vlm_embed(p, batch, cfg):
    tok = p["embed"][batch["tokens"]]
    vis = matmul(batch["vis_embed"].to(tok.dtype), p["vis_proj"])
    return torch.cat([vis, tok], dim=1)


def vlm_forward(p, batch, cfg: ArchConfig, *, remat=True):
    x = _vlm_embed(p, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = stack_fwd(p["stack"], x, cfg, cfg.layers(), positions=positions,
                     remat=remat)
    return _logits(p, x, cfg)


def vlm_prefill(p, batch, cache, cfg: ArchConfig, decode_axis=None):
    x = _vlm_embed(p, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x, cache = stack_fwd(p["stack"], x, cfg, cfg.layers(),
                         positions=positions, cache=cache, cur_len=0,
                         decode_axis=decode_axis)
    return _logits(p, x[:, -1:], cfg), cache
