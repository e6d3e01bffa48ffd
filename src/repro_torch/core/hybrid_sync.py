"""GraphHP's hybrid execution model lifted to multi-pod training (the port
of ``repro.core.hybrid_sync``).

Mapping: pod = graph partition; one optimizer step = one pseudo-superstep;
the cross-pod exchange = the global phase.  Each pod runs H *inner* steps
on its own replica — no cross-pod traffic, as the local phase runs on
in-memory messages — then the *global phase* exchanges the accumulated
parameter deltas once, through an error-feedback int8 combiner (the
``Combine()`` before the wire), and an outer Nesterov step (DiLoCo-style)
advances the shared anchor.

Layout: each pod's replica is its own model and its own ``AdamWState``,
in a list where the reference stacks a leading pod axis (a module's
parameters cannot carry one), and :func:`inner_steps` loops over them, so
each pod's gradients are its own by construction.  What crosses pods — the
deltas, their int8 codes and the error-feedback residuals — is stacked on
a leading pod axis as in the reference.  The int8 codes are taken over the
reference's leaves: a scanned unit's parameter ``<stack>.units.<i>.<rest>``
is row ``i`` of the reference's one stacked leaf ``<stack>.units.<rest>``,
so the units' deltas are stacked on axis 1 before compression and one int8
scale covers the leaf's every pod and every unit, as in the reference.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from collections.abc import Mapping, Sequence
from typing import Any, Callable

import torch
from torch import nn

from repro_torch.optim.adamw import named
from repro_torch.optim.compression import (ErrorFeedbackState,
                                           ef_int8_compress,
                                           ef_int8_decompress)

__all__ = ["OuterState", "stack_pods", "outer_init", "inner_steps",
           "global_sync"]


@dataclasses.dataclass
class OuterState:
    """Outer (cross-pod) optimizer state: shared anchor + Nesterov momentum
    + per-pod error-feedback residuals, by parameter name."""

    anchor: dict                    # synchronized parameters (no pod axis)
    momentum: dict                  # outer Nesterov buffer (no pod axis)
    ef: ErrorFeedbackState          # residuals, stacked per pod


_UNIT = re.compile(r"(?:^|\.)units\.(\d+)\.")


def _reference_leaves(names) -> dict[str, list[str]]:
    """The reference's leaf of every parameter name -> the names it stacks,
    in unit order (a name outside any ``units`` list is its own leaf)."""
    groups: dict[str, list[tuple[int, str]]] = {}
    for k in names:
        m = _UNIT.search(k)
        leaf = k if m is None else k[:m.start(1)] + k[m.end(1) + 1:]
        groups.setdefault(leaf, []).append((0 if m is None
                                            else int(m.group(1)), k))
    return {leaf: [k for _, k in sorted(v)] for leaf, v in groups.items()}


def _compress_by_leaf(delta_pods: Mapping, ef: ErrorFeedbackState
                      ) -> tuple[dict, ErrorFeedbackState]:
    """``ef_int8_compress`` then ``ef_int8_decompress`` over the reference's
    leaves (units stacked on axis 1, after the pod axis), returned by
    parameter name."""
    leaves = _reference_leaves(delta_pods)

    def stack(tree):
        return {leaf: torch.stack([tree[k] for k in ks], dim=1)
                for leaf, ks in leaves.items()}

    def unstack(tree):
        return {k: tree[leaf][:, i] for leaf, ks in leaves.items()
                for i, k in enumerate(ks)}

    q, scales, new = ef_int8_compress(
        stack(delta_pods), ErrorFeedbackState(residual=stack(ef.residual)))
    return (unstack(ef_int8_decompress(q, scales)),
            ErrorFeedbackState(residual=unstack(new.residual)))


def stack_pods(tree: Any, n_pods: int):
    """One replica per pod.  A mapping of tensors gains a leading pod axis
    (the reference's layout); a model or an optimizer state, which each
    pod updates on its own, becomes a list of ``n_pods`` independent
    copies."""
    if isinstance(tree, Mapping):
        return {k: t.detach()[None].expand((n_pods,) + t.shape).clone()
                for k, t in tree.items()}
    return [copy.deepcopy(tree) for _ in range(n_pods)]


def outer_init(params: nn.Module | Mapping, n_pods: int) -> OuterState:
    params = {k: p.detach() for k, p in named(params).items()}
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    return OuterState(
        anchor={k: p.clone() for k, p in params.items()},
        momentum=zeros,
        ef=ErrorFeedbackState(residual=stack_pods(zeros, n_pods)))


def inner_steps(train_step: Callable, params_pods: Sequence[nn.Module],
                opt_pods: Sequence, batch_pods: Mapping, step):
    """The local phase: one pod-independent inner step on every pod.

    ``train_step(model, opt, batch, step) -> (model, opt, metrics)`` is the
    single-pod step; ``batch_pods`` carries a leading pod axis.  Returns
    the pods' models and states as lists and their metrics stacked on a
    leading pod axis.
    """
    models, opts, metrics = [], [], []
    for i, (model, opt) in enumerate(zip(params_pods, opt_pods)):
        model, opt, m = train_step(model, opt,
                                   {k: v[i] for k, v in batch_pods.items()},
                                   step)
        models.append(model)
        opts.append(opt)
        metrics.append(m)
    return models, opts, {k: torch.stack([torch.as_tensor(m[k])
                                          for m in metrics])
                          for k in metrics[0]}


@torch.no_grad()
def global_sync(params_pods: Sequence[nn.Module], outer: OuterState, *,
                outer_lr: float = 0.7, outer_momentum: float = 0.9,
                compress: bool = True,
                gathered_specs=None) -> tuple[list, OuterState]:
    """The global phase: one cross-pod exchange per H inner steps.

    Per-pod delta vs. the anchor -> int8 error-feedback compression (one
    scale per reference leaf over all pods and units; the residual rides
    the next exchange) ->
    pod-mean -> outer Nesterov update of the anchor -> written back into
    every pod's model.  ``gathered_specs`` pins the reference's cross-pod
    gather to the quantized tensors on a GSPMD mesh; it waits for the
    sharding slice, so only ``None`` is taken.
    """
    if gathered_specs is not None:
        raise NotImplementedError(
            "gathered_specs pins a GSPMD gather; it belongs to the sharding "
            "slice of the port")
    pods = [named(m) for m in params_pods]
    delta_pods = {k: torch.stack([pod[k].float() for pod in pods])
                  - a.float()[None] for k, a in outer.anchor.items()}

    if compress:
        delta_pods, ef = _compress_by_leaf(delta_pods, outer.ef)
    else:
        ef = outer.ef
    delta = {k: torch.mean(d, dim=0) for k, d in delta_pods.items()}

    # outer Nesterov (DiLoCo): v <- mu v + delta; anchor += lr (mu v + delta)
    momentum = {k: outer_momentum * v + delta[k]
                for k, v in outer.momentum.items()}
    anchor = {k: (a.float() + outer_lr * (outer_momentum * momentum[k]
                                          + delta[k])).to(a.dtype)
              for k, a in outer.anchor.items()}

    for pod in pods:
        for k, p in pod.items():
            p.copy_(anchor[k])
    return list(params_pods), OuterState(anchor=anchor, momentum=momentum,
                                         ef=ef)
