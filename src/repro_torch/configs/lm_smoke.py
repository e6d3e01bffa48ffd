"""The LM substrate's configurations that the port's checks drive.

``DEMO_100M`` is the LM that ``examples/train_lm.py`` trains (its
``small_lm``: 14 × 640 with a 32k tied vocab, about 100 M parameters).
``SMOKE_FAMILIES`` holds one tiny configuration per family and layer
variant the substrate supports, sized for a CPU test: each runs forward,
prefill and decode and a train step in a second.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig, LayerSpec

__all__ = ["DEMO_100M", "SMOKE_FAMILIES"]

DEMO_100M = ArchConfig(
    name="demo-100m", family="dense", n_layers=14, d_model=640,
    n_heads=10, n_kv_heads=5, head_dim=64, d_ff=2304, vocab=32_768,
    pattern=(LayerSpec(),), tie_embeddings=True)

_TINY = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
             vocab=256)

SMOKE_FAMILIES: dict[str, ArchConfig] = {
    "dense_gqa": ArchConfig(
        name="dense-gqa-smoke", family="dense", n_layers=2,
        tie_embeddings=True, **_TINY),
    # one (window, full) unit and a window tail; window 8 < the prompts,
    # so prefill wraps the ring buffer
    "window_softcap": ArchConfig(
        name="window-softcap-smoke", family="dense", n_layers=3,
        pattern=(LayerSpec(attn="window", window=8), LayerSpec()),
        softcap_attn=20.0, softcap_final=15.0, norm="layernorm",
        act="gelu", **_TINY),
    "mla": ArchConfig(
        name="mla-smoke", family="dense", n_layers=2,
        pattern=(LayerSpec(attn="mla"),), kv_lora_rank=32, qk_nope_dim=16,
        qk_rope_dim=8, v_head_dim=12, **_TINY),
    # a dense head layer, then two MoE units; capacity overflows at the
    # smoke batch (4 experts, top 2)
    "moe": ArchConfig(
        name="moe-smoke", family="moe", n_layers=3,
        pattern=(LayerSpec(moe=True),), n_experts=4, top_k=2, d_expert=32,
        n_shared_experts=1, first_k_dense=1, **_TINY),
    "mamba": ArchConfig(
        name="mamba-smoke", family="ssm", n_layers=2,
        pattern=(LayerSpec(mixer="mamba"),), ssm_state=16, ssm_head_dim=16,
        ssm_chunk=8, **dict(_TINY, d_ff=0)),
    "hybrid": ArchConfig(
        name="hybrid-smoke", family="hybrid", n_layers=3,
        pattern=(LayerSpec(mixer="mamba"), LayerSpec(attn="full")),
        ssm_state=16, ssm_head_dim=16, ssm_chunk=8, **_TINY),
    "encdec": ArchConfig(
        name="encdec-smoke", family="audio", n_layers=2, enc_layers=2,
        enc_frames=24, pos="sinusoidal", mlp="plain", act="gelu",
        norm="layernorm", **_TINY),
    "vlm": ArchConfig(
        name="vlm-smoke", family="vlm", n_layers=2, vis_tokens=6,
        vis_dim=40, **_TINY),
}
