"""Model registry: dispatch an ArchConfig to its model API, plus parameter
counting (total & active) (the port of ``repro.models.registry``)."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf

__all__ = ["ModelAPI", "get_model", "param_shapes", "count_params"]


class ModelAPI(NamedTuple):
    init: Callable          # (gen, cfg, dtype, device) -> model
    forward: Callable       # (model, batch, cfg, remat=) -> logits
    init_cache: Callable    # (cfg, batch_size, max_len, dtype, device) -> cache
    prefill: Callable       # (model, batch, cache, cfg, ...) -> (logits, cache)
    decode_step: Callable | None  # (model, token, cache, cur_len, cfg, ...)


def get_model(cfg: ArchConfig) -> ModelAPI:
    if cfg.family == "audio":
        return ModelAPI(tf.encdec_init, tf.encdec_forward,
                        tf.encdec_cache_init, tf.encdec_prefill,
                        tf.encdec_decode_step)
    if cfg.family == "vlm":
        return ModelAPI(tf.vlm_init, tf.vlm_forward, tf.lm_cache_init,
                        tf.vlm_prefill, tf.lm_decode_step)
    return ModelAPI(tf.lm_init, tf.lm_forward, tf.lm_cache_init,
                    tf.lm_prefill, tf.lm_decode_step)


def param_shapes(cfg: ArchConfig, dtype=torch.bfloat16) -> torch.nn.Module:
    """The model on the ``meta`` device: every parameter's name, shape and
    dtype, and no storage."""
    return get_model(cfg).init(torch.Generator(), cfg, dtype, "meta")


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    total = 0
    expert = 0
    for name, leaf in param_shapes(cfg).named_parameters():
        n = leaf.numel()
        total += n
        keys = name.split(".")
        # routed-expert weights: (E, ...) stacks inside moe ffn params.  The
        # reference tests the rank of its leaf, which carries one more axis
        # inside the scanned units; the same test is made here.
        ndim = leaf.ndim + ("units" in keys)
        if (cfg.n_experts and "ffn" in keys and keys[-1] in ("wi", "wo")
                and ndim >= 3):
            expert += n
    if not active_only or not cfg.n_experts:
        return total
    active_expert = expert * cfg.top_k // cfg.n_experts
    return total - expert + active_expert
