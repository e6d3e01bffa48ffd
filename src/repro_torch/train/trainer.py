"""Training step construction: loss, microbatch gradient accumulation,
optimizer, metrics — the single-pod step that hybrid_sync runs per pod
(the port of ``repro.train.trainer``).

Gradients come from autograd over the plain PyTorch model; the update is
the port's AdamW (``repro_torch.optim.adamw``), written back into the
model's parameters.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.registry import ModelAPI
from repro_torch.optim.adamw import (AdamWState, adamw_update, global_norm,
                                     named)
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["cross_entropy", "make_loss_fn", "make_train_step"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean NLL in f32: logsumexp minus the label logit (taken by a
    compare against the vocab index, as the reference does).  logits
    (B,S,V), labels (B,S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    onehot = labels[..., None] == vocab
    label_logit = torch.sum(torch.where(onehot, logits, 0.0), dim=-1)
    nll = logz - label_logit
    if mask is not None:
        denom = torch.clamp(torch.sum(mask), min=1.0)
        return torch.sum(nll * mask) / denom
    return torch.mean(nll)


def make_loss_fn(cfg: ArchConfig, api: ModelAPI) -> Callable:
    def loss_fn(model, batch):
        logits = api.forward(model, batch, cfg, remat=True)
        s = batch["labels"].shape[1]
        logits = logits[:, -s:]                  # vlm prepends patch tokens
        return cross_entropy(logits, batch["labels"], batch.get("mask"))
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
    splits (activation memory / global-batch decoupling).
    """
    loss_fn = make_loss_fn(cfg, api)

    def grads_of(model, params, batch):
        def vg(mb):
            loss = loss_fn(model, mb)
            return loss.detach(), dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))

        if microbatches == 1:
            return vg(batch)
        micro = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                              + v.shape[1:]) for k, v in batch.items()}
        loss_sum = 0.0
        g_sum = {k: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for k, p in params.items()}
        for i in range(microbatches):
            loss, g = vg({k: v[i] for k, v in micro.items()})
            loss_sum = loss_sum + loss
            g_sum = {k: a + g[k].float() for k, a in g_sum.items()}
        inv = 1.0 / microbatches
        return loss_sum * inv, {k: g * inv for k, g in g_sum.items()}

    def train_step(model, opt: AdamWState, batch, step):
        params = named(model)
        loss, grads = grads_of(model, params, batch)
        lr = cosine_schedule(step, warmup, total_steps, peak_lr)
        new, opt = adamw_update(params, grads, opt, lr,
                                weight_decay=weight_decay,
                                clip_norm=clip_norm)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new[k])
        metrics = {"loss": loss, "grad_norm": global_norm(grads), "lr": lr}
        return model, opt, metrics

    return train_step
