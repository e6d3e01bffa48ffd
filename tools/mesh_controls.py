#!/usr/bin/env python3
"""Controls for the smoke's sharded train check (``chip_smoke.py``'s
``mesh`` phase, part (a)), one NVIDIA GPU.

    python3 tools/mesh_controls.py

Draws ``demo-100m``'s weights and the phase's batches as the smoke does,
runs the single-device steps on the card, then four gloo ranks on the
card on the smoke's (data 2, model 2) mesh, which run the sharded steps
four times from the same weights:

* ``none``: the step as it is (the smoke's own reading);
* ``skip_update``: every step computes its gradients and norm, then puts
  the weights and the AdamW state back as they were;
* ``no_data_reduce``: the gathered weights' backward keeps this rank's own
  gradient, without the sum over ``data``;
* ``norm_every_rank``: the clipping norm counts each shard on every rank
  that holds it, not once (a replicated shard is counted once per copy).

It prints one ``[controls]`` line per run with the readings the smoke
holds (each step's loss and clipping norm relative to the single-device
run's, each leaf's first moment against its largest |mu|, each leaf's
weights against its largest move), whether the smoke's check passes, and
writes them to ``chiprun_out/mesh_controls.json``.  A check that cannot
fail on the broken steps is no check.  Its command took 134.6 s on an
NVIDIA H100 80GB HBM3 at a 700.00 W power limit.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

CONTROLS = ("none", "skip_update", "no_data_reduce",
            "norm_every_rank")


@contextlib.contextmanager
def _control(name):
    """The step broken as ``name`` says, for the block."""
    import torch
    from repro_torch.sharding import fsdp
    from repro_torch.sharding.util import local_chunk
    if name == "skip_update":
        make = cs._mesh_step

        def skipping(cfg, train):
            step = make(cfg, train)

            def run(model, opt, batch, s):
                before = {k: fsdp.local_of(p).clone()
                          for k, p in model.named_parameters()}
                model, _, m = step(model, opt, batch, s)
                with torch.no_grad():
                    for k, p in model.named_parameters():
                        fsdp.local_of(p).copy_(before[k])
                return model, opt, m
            return run

        cs._mesh_step = skipping
        try:
            yield
        finally:
            cs._mesh_step = make
    elif name == "no_data_reduce":
        backward = fsdp._Gather.backward

        def own_grad(ctx, grad):
            return local_chunk(grad, ctx.sharding).contiguous(), None

        fsdp._Gather.backward = staticmethod(own_grad)
        try:
            yield
        finally:
            fsdp._Gather.backward = backward
    elif name == "norm_every_rank":
        from repro_torch.train import trainer
        norm = trainer._sharded_norm

        def every_rank(grads, params, mesh):
            parts = torch.stack([torch.sum(torch.square(g.float()))
                                 for g in grads.values()])
            return torch.sqrt(torch.sum(fsdp.all_reduce(parts, None)))

        trainer._sharded_norm = every_rank
        try:
            yield
        finally:
            trainer._sharded_norm = norm
    else:
        yield


def _rank(rank, world, group, device, cfg, train, state, batches, want):
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_host_mesh(cs.MESH_DATA, cs.MESH_MODEL,
                          device_type=device.type)
    out = {}
    for name in CONTROLS:
        with _control(name):
            out[name] = cs.mesh_train_rank(mesh, device, cfg, train, state,
                                           batches, want)
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    from repro_torch.core.distributed import spawn_ranks
    smi = cs.phase_device()
    device = torch.device(cs.LM_DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cs.LM_CFG
    inp = cs.mesh_inputs(cfg)
    want = cs.mesh_train_single(cfg, inp["state"], inp["batches"], device)
    ranks = spawn_ranks(_rank, cs.MESH_WORLD, "gloo", cs.MESH_DEVICE,
                        args=(cfg, dict(cs.LM_TRAIN), inp["state"],
                              inp["batches"], want),
                        deadline_s=600.0)
    rows = {}
    for name in CONTROLS:
        got = cs.mesh_train_readings(ranks[0][name], want, inp["state"])
        got["check_passes"] = cs.mesh_train_ok(got)
        rows[name] = got
        cs.say("controls", control=name, card=json.dumps(smi),
               **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                  for k, v in got.items()})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "mesh_controls.json"),
              "w") as f:
        json.dump(dict(card=smi, tolerances=dict(
            loss=cs.MESH_LOSS_RTOL, grad_norm=cs.MESH_NORM_RTOL,
            mu=cs.MESH_MU_RTOL, weights=cs.MESH_UPDATE_RTOL),
            runs=rows), f, indent=1)
    ok = rows["none"]["check_passes"] and not any(
        rows[n]["check_passes"] for n in CONTROLS[1:])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
