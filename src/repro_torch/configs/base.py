"""Architecture / shape configuration system (a copy of
``repro.configs.base``: the port imports nothing of the reference).

One ``ArchConfig`` per assigned architecture (exact public configs), plus
reduced smoke variants for CPU tests.  ``LayerSpec`` describes one layer of a
possibly heterogeneous stack (local/global attention interleaves, Mamba:attn
hybrids, dense-then-MoE stacks); the model groups layers into the smallest
repeating unit and loops over units (the reference ``lax.scan``s them).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Literal, Sequence

AttnKind = Literal["full", "window", "mla", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of the stack."""

    mixer: Literal["attn", "mamba"] = "attn"
    attn: AttnKind = "full"
    window: int = 0                  # sliding-window size when attn == 'window'
    moe: bool = False                # MoE FFN instead of dense
    causal: bool = True              # False for encoder stacks
    cross: bool = False              # add cross-attention (whisper decoder)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # layer pattern: unit repeated; remainder unrolled (see models/stack.py)
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    window: int = 4096
    rope_theta: float = 10_000.0
    softcap_attn: float = 0.0        # gemma2 logit soft-capping
    softcap_final: float = 0.0
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0                # expert hidden size (d_ff of one expert)
    n_shared_experts: int = 0        # deepseek shared experts
    first_k_dense: int = 0           # deepseek: first k layers dense
    # --- MLA (deepseek) ---
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- Mamba2 ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    conv_dim: int = 4
    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_frames: int = 0              # precomputed frame embeddings (stub)
    # --- VLM stub (internvl) ---
    vis_tokens: int = 0              # precomputed patch embeddings (stub)
    vis_dim: int = 0
    # --- misc ---
    norm_eps: float = 1e-6
    act: str = "silu"
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    pos: str = "rope"                # rope | sinusoidal (whisper)
    mlp: str = "gated"               # gated (SwiGLU/GeGLU) | plain (whisper)
    sub_quadratic: bool = False      # eligible for long_500k
    source: str = ""

    # ---- derived ---------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layers(self) -> tuple[LayerSpec, ...]:
        reps = -(-self.n_layers // len(self.pattern))
        out = list((self.pattern * reps)[: self.n_layers])
        # deepseek-style: first k layers use a dense FFN instead of MoE
        for i in range(min(self.first_k_dense, len(out))):
            out[i] = dataclasses.replace(out[i], moe=False)
        return tuple(out)

    def n_params(self) -> int:
        """Total parameter count (embedding included)."""
        from repro_torch.models.registry import count_params
        return count_params(self)

    def n_active_params(self) -> int:
        from repro_torch.models.registry import count_params
        return count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# The paper's own workload is the only registered config; the LM substrate
# stays usable with ad-hoc ArchConfigs (see examples/train_lm.py).
_ARCH_MODULES = [
    "graphhp_paper",
]


def list_archs() -> list[str]:
    out = []
    for m in _ARCH_MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{m}")
        out.append(mod.CONFIG.name if hasattr(mod, "CONFIG") else m)
    return out


def get_config(name: str, smoke: bool = False):
    """Load an arch config by id (e.g. 'gemma2-9b'), or its reduced smoke
    variant (same family/pattern, tiny dims) when ``smoke=True``."""
    key = name.replace("-", "_").replace(".", "p")
    for m in _ARCH_MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{m}")
        cfg = getattr(mod, "CONFIG", None)
        if cfg is not None and (cfg.name == name or m == key):
            return mod.SMOKE if smoke else cfg
    raise KeyError(f"unknown arch {name!r}; have {list_archs()}")
