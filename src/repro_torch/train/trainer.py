"""Training step construction: loss, microbatch gradient accumulation,
optimizer, metrics — the single-pod step that hybrid_sync runs per pod
(the port of ``repro.train.trainer``).

Gradients come from autograd over the plain PyTorch model; the update is
the port's AdamW (``repro_torch.optim.adamw``), written back into the
model's parameters.

One step serves a model on one device and a model whose parameters are
DTensors (placed by the sharding rules); on the latter it keeps the
one-device step's meaning as GSPMD keeps the reference's: each rank runs its row-slice of the batch (placed over
``data``, and ``pod`` for a multi-pod mesh) through the model read by
``sharding.fsdp.unsharded`` (each unit's weights gathered at use); the
token-mean loss divides by the token count of the whole batch (of the
pod); gradients are summed over ``data`` back onto each parameter's shard;
the clipping norm is taken over every shard once; AdamW updates the local
shards and moments.  The ranks along ``model`` repeat the same compute.
On one device there is no group to reduce over, the leaves are the
parameters themselves and the norm is ``global_norm``'s.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.registry import ModelAPI
from repro_torch.optim.adamw import (AdamWState, adamw_update, global_norm,
                                     named)
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.sharding.util import maybe_constrain

__all__ = ["token_nll", "cross_entropy", "make_loss_fn", "make_train_step"]


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token NLL in f32: logsumexp minus the label logit (taken by a
    compare against the vocab index, as the reference does).  logits
    (B,S,V), labels (B,S)."""
    logits = maybe_constrain(logits.float(), "data", None, "model")
    logz = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    onehot = labels[..., None] == vocab
    label_logit = torch.sum(torch.where(onehot, logits, 0.0), dim=-1)
    return logz - label_logit


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean NLL in f32 (see :func:`token_nll`)."""
    nll = token_nll(logits, labels)
    if mask is not None:
        denom = torch.clamp(torch.sum(mask), min=1.0)
        return torch.sum(nll * mask) / denom
    return torch.mean(nll)


def _logits(cfg, api, model, batch):
    logits = api.forward(model, batch, cfg, remat=True)
    return logits[:, -batch["labels"].shape[1]:]     # vlm prepends patches


def make_loss_fn(cfg: ArchConfig, api: ModelAPI) -> Callable:
    def loss_fn(model, batch):
        return cross_entropy(_logits(cfg, api, model, batch),
                             batch["labels"], batch.get("mask"))
    return loss_fn


def make_train_step(cfg: ArchConfig, api: ModelAPI, *,
                    microbatches: int = 1,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000,
                    weight_decay: float = 0.1,
                    clip_norm: float = 1.0) -> Callable:
    """-> train_step(model, opt, batch, step) -> (model, opt, metrics).

    The model's parameters are updated in place; ``opt`` is replaced.
    ``microbatches > 1`` accumulates float32 gradients over leading batch
    splits (activation memory / global-batch decoupling).  A model with
    DTensor parameters is stepped on its shards (module docstring); its
    batch leaves are DTensors placed by ``batch_spec``.
    """

    def split(batch):
        if microbatches == 1:
            return [batch]
        return [{k: v.reshape((microbatches, v.shape[0] // microbatches)
                              + v.shape[1:])[i] for k, v in batch.items()}
                for i in range(microbatches)]

    def update(params, grads, opt, step, grad_norm):
        lr = cosine_schedule(step, warmup, total_steps, peak_lr)
        new, opt = adamw_update(params, grads, opt, lr,
                                weight_decay=weight_decay,
                                clip_norm=clip_norm, grad_norm=grad_norm)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new[k])
        return opt, lr

    def train_step(model, opt: AdamWState, batch, step):
        from repro_torch.sharding import fsdp
        from repro_torch.sharding.util import split_batch
        params = named(model)
        group, n, mesh = None, 1, None
        if fsdp.is_sharded(model):
            mesh = next(iter(params.values())).device_mesh
            group = fsdp.data_group(mesh)
            n = 1 if group is None else torch.distributed.get_world_size(group)
            leaves = {k: fsdp.local_of(p).detach().requires_grad_()
                      for k, p in params.items()}
            view, batch = fsdp.unsharded(model, leaves), _local_batch(batch)
        else:
            leaves, view = params, model
        loss_sum, g_sum = 0.0, None
        with split_batch(n):
            for mb in split(batch):
                nll = token_nll(_logits(cfg, api, view, mb), mb["labels"])
                mask = mb.get("mask")
                num = torch.sum(nll if mask is None else nll * mask)
                cnt = torch.tensor(float(nll.numel()), device=nll.device) \
                    if mask is None else torch.sum(mask).float()
                den = torch.clamp(_reduce(cnt, group), min=1.0)
                # a parameter the loss does not reach (a dry run's probe
                # without decoder layers) has a zero gradient
                grads = [torch.zeros_like(x) if g is None else g
                         for x, g in zip(leaves.values(), torch.autograd.grad(
                             num / den, list(leaves.values()),
                             allow_unused=True))]
                loss_sum = loss_sum + _reduce(num.detach(), group) / den
                if microbatches == 1:
                    g_sum = grads
                else:
                    g_sum = [g.float() for g in grads] if g_sum is None \
                        else [a + g.float() for a, g in zip(g_sum, grads)]
        inv = 1.0 / microbatches
        grads = {k: g * inv if microbatches > 1 else g
                 for k, g in zip(leaves, g_sum)}
        gn = global_norm(grads) if mesh is None else \
            _sharded_norm(grads, params, mesh)
        local = {k: fsdp.local_of(p) for k, p in params.items()}
        local_opt = AdamWState(
            mu={k: fsdp.local_of(v) for k, v in opt.mu.items()},
            nu={k: fsdp.local_of(v) for k, v in opt.nu.items()},
            step=opt.step)
        new_opt, lr = update(local, grads, local_opt, step, gn)
        opt = AdamWState(
            mu={k: fsdp.like_placed(t, opt.mu[k])
                for k, t in new_opt.mu.items()},
            nu={k: fsdp.like_placed(t, opt.nu[k])
                for k, t in new_opt.nu.items()}, step=new_opt.step)
        loss = loss_sum * inv if microbatches > 1 else loss_sum
        return model, opt, {"loss": loss, "grad_norm": gn, "lr": lr}

    return train_step


def _local_batch(batch) -> dict:
    from torch.distributed.tensor import DTensor
    out = {}
    for k, v in batch.items():
        if not isinstance(v, DTensor):
            raise TypeError(f"batch[{k!r}]: a sharded step takes DTensors "
                            f"placed by batch_spec, not {type(v)}")
        out[k] = v.to_local()
    return out


def _reduce(t: torch.Tensor, group) -> torch.Tensor:
    from repro_torch.sharding.fsdp import all_reduce
    return t if group is None else all_reduce(t, group)


def _sharded_norm(grads: dict, params: dict, mesh) -> torch.Tensor:
    """The clipping norm of a pod's gradients from every rank's shards: each
    shard's sum of squares counted by one rank of those that hold it (the
    first along each replicated dimension but ``pod``), one all-reduce
    over the world with a row per pod."""
    from repro_torch.sharding.fsdp import all_reduce
    from repro_torch.sharding.util import axis_sizes, mesh_coords
    coords, names = mesh_coords(mesh), mesh.mesh_dim_names
    n_pods = axis_sizes(mesh).get("pod", 1)
    first = next(iter(grads.values()))
    parts = torch.zeros((n_pods, len(grads)), dtype=torch.float32,
                        device=first.device)
    for j, (k, g) in enumerate(grads.items()):
        owner = all(coords[names[i]] == 0
                    for i, pl in enumerate(params[k].placements)
                    if not pl.is_shard() and names[i] != "pod")
        if owner:
            parts[coords.get("pod", 0), j] = torch.sum(torch.square(g.float()))
    tot = all_reduce(parts, None)[coords.get("pod", 0)]
    return torch.sqrt(torch.sum(tot))
