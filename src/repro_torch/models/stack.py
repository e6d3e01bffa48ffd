"""Heterogeneous layer stacks as units (the port of ``repro.models.stack``).

A stack's layer list is grouped into a head (leading layers that differ
from the repeating unit: deepseek's first-k-dense), repetitions of the
``pattern`` unit, and a tail (the remainder).  The reference ``lax.scan``s
over unit parameters stacked on a leading axis; here each unit is its own
node of an ``nn.ModuleList`` (``stack.units.<i>.layer_<j>``, the
reference's ``stack.units.layer_<j>[i]``), run in a loop, and
``remat=True`` recomputes each unit in the backward through
``torch.utils.checkpoint``.  Caches follow the same layout: a list of
per-unit caches where the reference stacks them.
"""

from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (Init, mlp_fwd, mlp_init, norm_fwd,
                                       norm_init)
from repro_torch.sharding.fsdp import resolve_group
from repro_torch.sharding.util import maybe_constrain

__all__ = ["layer_init", "layer_cache_init", "layer_fwd", "stack_init",
           "stack_cache_init", "stack_fwd"]


def _unit_specs(cfg: ArchConfig, layers: tuple[LayerSpec, ...]):
    """Split the layer list into (head, pattern, n_units, tail): ``head``
    holds leading layers that differ from the repeating unit (deepseek's
    first-k-dense), units cover the homogeneous middle, ``tail`` the
    trailing remainder (gemma3's final locals)."""
    u = len(cfg.pattern)
    head = tuple(layers[: cfg.first_k_dense]) if cfg.first_k_dense else ()
    rest = layers[len(head):]
    n_units = len(rest) // u
    tail = rest[n_units * u:]
    return head, cfg.pattern, n_units, tail


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------

def layer_init(init: Init, cfg: ArchConfig, spec: LayerSpec) -> dict:
    p = {"norm1": norm_init(init, cfg.d_model, cfg.norm)}
    if spec.mixer == "attn":
        if spec.attn == "mla":
            p["mixer"] = attn_mod.mla_init(init, cfg)
        else:
            p["mixer"] = attn_mod.gqa_init(init, cfg)
    else:
        p["mixer"] = mamba_mod.mamba_init(init, cfg)
    if spec.cross:
        p["norm_x"] = norm_init(init, cfg.d_model, cfg.norm)
        p["cross"] = attn_mod.cross_attn_init(init, cfg)
    if spec.moe:
        p["norm2"] = norm_init(init, cfg.d_model, cfg.norm)
        p["ffn"] = moe_mod.moe_init(init, cfg)
    elif cfg.d_ff > 0:
        p["norm2"] = norm_init(init, cfg.d_model, cfg.norm)
        p["ffn"] = mlp_init(init, cfg.d_model, cfg.d_ff, cfg.mlp)
    return p


def layer_cache_init(cfg: ArchConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype, device) -> dict:
    if spec.mixer == "mamba":
        return {"mamba": mamba_mod.mamba_cache_init(cfg, batch, dtype,
                                                     device)}
    if spec.attn == "mla":
        return {"mla": attn_mod.mla_cache_init(cfg, batch, max_len, dtype,
                                               device)}
    return {"kv": attn_mod.gqa_cache_init(cfg, spec, batch, max_len, dtype,
                                          device)}


def layer_fwd(p, x, cfg: ArchConfig, spec: LayerSpec, *, positions,
              cache=None, cur_len=None, enc=None, decode=False,
              decode_axis=None, kv_start=None):
    # the residual stream over data on the batch dim (the reference's
    # sequence-parallel option, model on the seq dim, is not ported)
    x = maybe_constrain(x, "data", None, None)
    h = norm_fwd(p["norm1"], x, cfg.norm, cfg.norm_eps)
    if spec.mixer == "attn":
        fwd = attn_mod.mla_fwd if spec.attn == "mla" else attn_mod.gqa_fwd
        key = "mla" if spec.attn == "mla" else "kv"
        sub = None if cache is None else cache[key]
        y, new_sub = fwd(p["mixer"], h, spec, cfg, positions=positions,
                         cache=sub, cur_len=cur_len, decode_axis=decode_axis,
                         kv_start=kv_start)
        new_cache = None if cache is None else {key: new_sub}
    else:
        sub = None if cache is None else cache["mamba"]
        group = resolve_group(decode_axis) if sub is not None else None
        if group is not None:
            sub = mamba_mod.gather_state(sub, cfg, group)
        if decode:
            y, new_sub = mamba_mod.mamba_decode(p["mixer"], h, cfg, sub)
        else:
            y, new_sub = mamba_mod.mamba_fwd(p["mixer"], h, cfg, cache=sub)
        if group is not None:
            new_sub = mamba_mod.shard_state(new_sub, cache["mamba"], group)
        new_cache = None if cache is None else {"mamba": new_sub}
    x = x + y

    if spec.cross and enc is not None:
        hx = norm_fwd(p["norm_x"], x, cfg.norm, cfg.norm_eps)
        x = x + attn_mod.cross_attn_fwd(p["cross"], hx, enc, cfg)

    if "ffn" in p:
        h2 = norm_fwd(p["norm2"], x, cfg.norm, cfg.norm_eps)
        if spec.moe:
            y2 = moe_mod.moe_fwd(p["ffn"], h2, cfg)
        else:
            y2 = mlp_fwd(p["ffn"], h2, cfg.mlp, cfg.act)
        x = x + y2
    return x, new_cache


# ---------------------------------------------------------------------------
# stack: head, units, tail
# ---------------------------------------------------------------------------

def stack_init(init: Init, cfg: ArchConfig,
               layers: tuple[LayerSpec, ...]) -> dict:
    head, pattern, n_units, tail = _unit_specs(cfg, layers)
    p = {"head": [layer_init(init, cfg, s) for s in head]}
    if n_units:
        p["units"] = [{f"layer_{i}": layer_init(init, cfg, s)
                       for i, s in enumerate(pattern)}
                      for _ in range(n_units)]
    p["tail"] = [layer_init(init, cfg, s) for s in tail]
    return p


def stack_cache_init(cfg: ArchConfig, layers, batch, max_len, dtype,
                     device) -> dict:
    head, pattern, n_units, tail = _unit_specs(cfg, layers)
    c = {"head": [layer_cache_init(cfg, s, batch, max_len, dtype, device)
                  for s in head]}
    if n_units:
        c["units"] = [{f"layer_{i}": layer_cache_init(cfg, s, batch, max_len,
                                                      dtype, device)
                       for i, s in enumerate(pattern)}
                      for _ in range(n_units)]
    c["tail"] = [layer_cache_init(cfg, s, batch, max_len, dtype, device)
                 for s in tail]
    return c


def stack_fwd(p, x, cfg: ArchConfig, layers, *, positions, cache=None,
              cur_len=None, enc=None, decode=False, decode_axis=None,
              remat: bool = False, kv_start=None):
    head, pattern, n_units, tail = _unit_specs(cfg, layers)
    kw = dict(positions=positions, cur_len=cur_len, enc=enc, decode=decode,
              decode_axis=decode_axis, kv_start=kv_start)

    def unit_fwd(x, unit_p, unit_c):
        new_c = {} if unit_c is not None else None
        for i, spec in enumerate(pattern):
            sub_c = None if unit_c is None else unit_c[f"layer_{i}"]
            x, nc = layer_fwd(unit_p[f"layer_{i}"], x, cfg, spec,
                              cache=sub_c, **kw)
            if new_c is not None:
                new_c[f"layer_{i}"] = nc
        return x, new_c

    new_cache = None if cache is None else {"head": [], "tail": []}
    for i, spec in enumerate(head):
        x, nc = layer_fwd(p["head"][i], x, cfg, spec,
                          cache=None if cache is None else cache["head"][i],
                          **kw)
        if new_cache is not None:
            new_cache["head"].append(nc)

    if n_units:
        new_units = []
        for u in range(n_units):
            unit_c = None if cache is None else cache["units"][u]
            if remat and x.requires_grad:
                x, nc = checkpoint(unit_fwd, x, p["units"][u], unit_c,
                                   use_reentrant=False)
            else:
                x, nc = unit_fwd(x, p["units"][u], unit_c)
            new_units.append(nc)
        if new_cache is not None:
            new_cache["units"] = new_units

    for i, spec in enumerate(tail):
        x, nc = layer_fwd(p["tail"][i], x, cfg, spec,
                          cache=None if cache is None else cache["tail"][i],
                          **kw)
        if new_cache is not None:
            new_cache["tail"].append(nc)
    return x, new_cache
