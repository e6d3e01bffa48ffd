"""Dry-run cell construction (the port of ``repro.launch.specs``): for an
(arch × input-shape × mesh), the step function, its arguments as ``meta``
tensors (shapes and dtypes, no storage) and each argument's
:class:`~repro_torch.sharding.util.NamedSharding`.

Cells:
  train_4k     -> the sharded train step (single pod), or the hybrid-sync
                  inner step on a multi-pod mesh: the same step with the
                  pods on the mesh's ``pod`` dimension (each pod's replica
                  on its own ranks; gradients reduce inside the pod)
  prefill_32k  -> prefill      (batch over data [+pod])
  decode_32k   -> decode_step  (one token against a seq_len KV cache;
                  cache sequence-sharded over model where every KV
                  cache divides, ``sharding.util.decode_layout``)
  long_500k    -> decode_step for sub-quadratic archs only

:func:`place_args` puts a cell's arguments on their mesh (this rank's
shards, as DTensors); ``cell.fn(*placed)`` runs the step.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.registry import count_params, get_model, param_shapes
from repro_torch.optim.adamw import AdamWState
from repro_torch.sharding.rules import P, batch_spec, param_specs
from repro_torch.sharding.util import (axis_sizes, decode_layout,
                                       local_nbytes, named, place,
                                       place_tree, sanitize_specs)

__all__ = ["Cell", "token_shapes", "runnable", "opt_moment_dtype",
           "build_cell", "place_args", "arg_bytes", "shard_module"]

BF16 = torch.bfloat16


class Cell(NamedTuple):
    label: str
    fn: Callable                 # fn(*place_args(cell))
    args: tuple                  # meta-tensor trees (a model, dicts, ...)
    in_shardings: tuple          # NamedSharding trees, None: not placed
    arg_names: tuple             # what each argument is, for byte counts


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def token_shapes(cfg: ArchConfig, shape: ShapeConfig, with_labels: bool):
    """Batch meta tensors for this arch (modality stubs included)."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "vlm":
        s = s - cfg.vis_tokens          # patches + text = nominal seq_len
    batch = {"tokens": _meta((b, s), torch.int32)}
    if with_labels:
        batch["labels"] = _meta((b, s), torch.int32)
    if cfg.family == "vlm":
        batch["vis_embed"] = _meta((b, cfg.vis_tokens, cfg.vis_dim), BF16)
    if cfg.family == "audio":
        batch["audio_embed"] = _meta((b, cfg.enc_frames, cfg.d_model), BF16)
    return batch


def runnable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is this (arch, shape) cell runnable?"""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention stack: 500k-token decode requires "
                       "sub-quadratic attention (run for ssm/hybrid/"
                       "sliding-window archs only)")
    return True, ""


def opt_moment_dtype(cfg: ArchConfig):
    """bf16 moments above 50B params so the optimizer state fits."""
    return BF16 if count_params(cfg) > 50e9 else torch.float32


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, multi_pod: bool,
               microbatches: int = 1, param_dtype=BF16) -> Cell:
    """``param_dtype``: the parameters' storage, bf16 as in the
    reference's dry run."""
    api = get_model(cfg)
    model = param_shapes(cfg, param_dtype)
    pshard = named(sanitize_specs(param_specs(model), model, mesh), mesh)
    data = ("pod", "data") if multi_pod else "data"
    if shape.kind == "train":
        return _train_cell(cfg, api, shape, mesh, model, pshard, data,
                           microbatches)
    if shape.kind == "prefill":
        return _prefill_cell(cfg, api, shape, mesh, model, pshard, data)
    return _decode_cell(cfg, api, shape, mesh, model, pshard, data)


def _specs(tree, mesh, specs):
    return named(sanitize_specs(specs, tree, mesh), mesh)


def _train_cell(cfg, api, shape, mesh, model, pshard, data, microbatches):
    from repro_torch.train.trainer import make_train_step
    mdt = opt_moment_dtype(cfg)
    params = dict(model.named_parameters())
    moments = {k: _meta(p.shape, mdt) for k, p in params.items()}
    opt = AdamWState(mu=moments, nu=dict(moments),
                     step=_meta((), torch.int32))
    batch = token_shapes(cfg, shape, with_labels=True)
    bshard = _specs(batch, mesh, batch_spec(batch, data=data))
    return Cell(f"{cfg.name}:{shape.name}",
                make_train_step(cfg, api, microbatches=microbatches),
                (model, opt, batch, 0),
                (pshard, AdamWState(mu=pshard, nu=pshard, step=None),
                 bshard, None),
                ("params", "moments", "batch", "step"))


def _serve_fn(api, cfg, mesh, kind):
    """The prefill or decode step on placed arguments: the model read
    through gathers, the batch split over the data ranks."""
    from repro_torch.sharding.fsdp import local_of, unsharded
    from repro_torch.sharding.util import split_batch
    data_ranks = math.prod(v for k, v in axis_sizes(mesh).items()
                           if k in ("pod", "data"))

    def local(tree):
        if isinstance(tree, dict):
            return {k: local(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [local(v) for v in tree]
        return local_of(tree)

    def fn(model, batch, cache, *rest):
        from repro_torch.launch.mesh import set_mesh
        axis = rest[-1]
        with set_mesh(mesh), split_batch(data_ranks):
            if kind == "prefill":
                return api.prefill(unsharded(model), local(batch),
                                   local(cache), cfg, decode_axis=axis)
            return api.decode_step(unsharded(model), local(batch["tokens"]),
                                   local(cache), rest[0], cfg,
                                   decode_axis=axis)
    return fn


def _cache(api, cfg, batch: int, seq: int):
    return api.init_cache(cfg, batch, seq, BF16, "meta")


def _prefill_cell(cfg, api, shape, mesh, model, pshard, data):
    batch = token_shapes(cfg, shape, with_labels=False)
    bshard = _specs(batch, mesh, batch_spec(batch, data=data))
    cache = _cache(api, cfg, shape.global_batch, shape.seq_len)
    specs, axis = decode_layout(cache, mesh, data)
    cshard = named(specs, mesh)
    return Cell(f"{cfg.name}:{shape.name}", _serve_fn(api, cfg, mesh,
                                                      "prefill"),
                (model, batch, cache, axis),
                (pshard, bshard, cshard, None),
                ("params", "batch", "cache", "decode_axis"))


def _decode_cell(cfg, api, shape, mesh, model, pshard, data):
    b = shape.global_batch
    cache = _cache(api, cfg, b, shape.seq_len)
    specs, axis = decode_layout(cache, mesh, data)
    cshard = named(specs, mesh)
    tok = {"tokens": _meta((b, 1), torch.int32)}
    tshard = _specs(tok, mesh, {"tokens": P(data, None)})
    return Cell(f"{cfg.name}:{shape.name}", _serve_fn(api, cfg, mesh,
                                                      "decode"),
                (model, tok, cache, shape.seq_len - 1, axis),
                (pshard, tshard, cshard, None, None),
                ("params", "batch", "cache", "cur_len", "decode_axis"))


# ---------------------------------------------------------------------------
# placing and counting
# ---------------------------------------------------------------------------

def shard_module(model: torch.nn.Module, shardings: dict,
                 device=None) -> torch.nn.Module:
    """Replace each parameter of ``model`` by a DTensor parameter holding
    this rank's shard (``shardings``: name -> NamedSharding), in place."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, torch.nn.Parameter(
            place(p.detach(), shardings[name], device),
            requires_grad=p.requires_grad))
    return model


def _place(arg, sh, device):
    if sh is None:
        return arg
    if isinstance(arg, torch.nn.Module):
        return shard_module(arg, sh, device)
    if isinstance(arg, AdamWState):
        return AdamWState(mu=place_tree(arg.mu, sh.mu, device),
                          nu=place_tree(arg.nu, sh.nu, device),
                          step=arg.step if device is None
                          else arg.step.to(device))
    return place_tree(arg, sh, device)


def place_args(cell: Cell, device=None) -> tuple:
    """A cell's arguments placed on their mesh (meta stays meta)."""
    return tuple(_place(a, s, device)
                 for a, s in zip(cell.args, cell.in_shardings))


def _leaf_bytes(arg, sh) -> int:
    if isinstance(arg, torch.nn.Module):
        return sum(local_nbytes(p.shape, p.dtype, sh[k])
                   for k, p in arg.named_parameters())
    if isinstance(arg, AdamWState):
        return _leaf_bytes(arg.mu, sh.mu) + _leaf_bytes(arg.nu, sh.nu)
    if isinstance(arg, torch.Tensor):
        return local_nbytes(arg.shape, arg.dtype, sh)
    if isinstance(arg, dict):
        return sum(_leaf_bytes(v, sh[k]) for k, v in arg.items())
    if isinstance(arg, (list, tuple)):
        return sum(_leaf_bytes(v, s) for v, s in zip(arg, sh))
    return 0


def arg_bytes(cell: Cell) -> dict[str, int]:
    """Bytes of each placed argument one rank holds, from the shapes and
    the placements alone."""
    return {name: _leaf_bytes(a, s) for name, a, s in
            zip(cell.arg_names, cell.args, cell.in_shardings)
            if s is not None}

