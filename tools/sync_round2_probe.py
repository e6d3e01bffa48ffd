"""Where the card's hybrid sync leaves the host's (card only).

``chip_smoke.py``'s ``lm_hybrid_sync`` runs two rounds of
``global_sync(compress=True)`` from the same pods and outer state on the
host and on the card.  This tool rebuilds those inputs (the dense smoke
family, two pods, two inner steps each on the host, round 1 on the host),
hands round 1's result to both sides, and runs round 2 op by op as
``core.hybrid_sync`` and ``optim.compression`` do: the pod deltas, the
error-feedback sum, each reference leaf's largest |value|, the int8
scale, the codes, the residual, the dequantized pod mean, the momentum
and the anchor.  For each op it prints the number of leaves whose card
result differs from the host's in any bit and the first of them.  The
scale is taken two ways: divided by the Python number 127.0 (a CPU
scalar, which PyTorch's CUDA division replaces by a multiply with its
reciprocal) and by a tensor of 127.0 on the operand's device.  It also
counts, over 10^6 values, how often the CUDA division by the Python
number differs from the host's.  Last, the port's own ``global_sync``
round 2 on both sides, anchor, momentum and residuals bit for bit.

    python3 tools/sync_round2_probe.py     # exit 0: round 2 bit for bit

Writes ``chiprun_out/sync_round2_probe.json`` when run from the repo.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def _differs(a, b) -> bool:
    import torch
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype.is_floating_point:
        return not torch.equal(a.view(torch.int32), b.view(torch.int32))
    return not torch.equal(a, b)


def round2_ops(pods, outer, scale_div):
    """Round 2 of ``global_sync(compress=True)`` op by op (one process,
    the pods stacked): each op's result by reference leaf."""
    import torch
    from repro_torch.core.hybrid_sync import _by_leaf
    from repro_torch.optim.adamw import named
    params = [{k: p.detach() for k, p in named(m).items()} for m in pods]
    anchor = outer.anchor
    delta_pods = {k: torch.stack([p[k].float() for p in params])
                  - a.float()[None] for k, a in anchor.items()}
    stack, unstack = _by_leaf(delta_pods)
    ops = {"delta": stack(delta_pods)}
    ops["xf"] = {k: x + r for (k, x), r in zip(
        ops["delta"].items(), stack(outer.ef.residual).values())}
    ops["absmax"] = {k: torch.amax(torch.abs(x)) for k, x in
                     ops["xf"].items()}
    ops["scale"] = {k: scale_div(torch.clamp(m, min=1e-12))
                    for k, m in ops["absmax"].items()}
    ops["codes"] = {k: torch.clamp(torch.round(x / ops["scale"][k]), -127,
                                   127).to(torch.int8)
                    for k, x in ops["xf"].items()}
    ops["residual"] = {k: x - ops["codes"][k].float() * ops["scale"][k]
                       for k, x in ops["xf"].items()}
    deq = {k: q.float() * ops["scale"][k] for k, q in ops["codes"].items()}
    delta = {k: torch.mean(d, dim=0) for k, d in unstack(deq).items()}
    ops["mean"] = stack({k: d[None] for k, d in delta.items()})
    momentum = {k: 0.9 * v + delta[k] for k, v in outer.momentum.items()}
    ops["momentum"] = stack({k: v[None] for k, v in momentum.items()})
    ops["anchor"] = stack({k: (a.float() + 0.7 * (0.9 * momentum[k]
                                                   + delta[k])).to(a.dtype)[
        None] for k, a in anchor.items()})
    return ops


def compare(host, card) -> list:
    rows = []
    for op in host:
        bad = [k for k in host[op] if _differs(host[op][k], card[op][k])]
        rows.append(dict(op=op, leaves=len(host[op]), differing=len(bad),
                         first=bad[0] if bad else None))
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this probe compares the card with the host",
              file=sys.stderr)
        return 2
    report = run(torch.device("cuda"))
    report["card"] = torch.cuda.get_device_name(0)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "sync_round2_probe.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0 if report["bit_identical"] else 1


def run(dev) -> dict:
    """The probe with ``dev`` as the card's side."""
    import torch
    import chip_smoke as cs
    from repro_torch.configs.lm_smoke import SMOKE_FAMILIES
    from repro_torch.core.hybrid_sync import (global_sync, inner_steps,
                                              outer_init, stack_pods)
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.trainer import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = SMOKE_FAMILIES["dense_gqa"]
    api = get_model(cfg)
    step_fn = make_train_step(cfg, api, peak_lr=cs.LM_FAMILY_LR, warmup=1)
    model = api.init(torch.Generator().manual_seed(6), cfg, torch.float32,
                     "cpu")
    pods, opts = stack_pods(model, 2), stack_pods(adamw_init(model), 2)
    for step in range(2):
        b = [cs._lm_batch(cfg, 4, 16, 10 * pod + step, "cpu")
             for pod in range(2)]
        pods, opts, _ = inner_steps(step_fn, pods, opts,
                                    {k: torch.stack([x[k] for x in b])
                                     for k in b[0]}, step)
    pods, outer = global_sync(pods, outer_init(model, 2), compress=True)

    def to_card(outer):
        mv = {k: v.to(dev) for k, v in outer.momentum.items()}
        return dataclasses.replace(
            outer, anchor={k: v.to(dev) for k, v in outer.anchor.items()},
            momentum=mv, ef=dataclasses.replace(outer.ef, residual={
                k: v.to(dev) for k, v in outer.ef.residual.items()}))
    card_pods = [copy.deepcopy(p).to(dev) for p in pods]
    card_outer = to_card(outer)

    divs = {"python_scalar": lambda m: m / 127.0,
            "device_tensor": lambda m: m / torch.full_like(m, 127.0)}
    report, host_ops = {}, {}
    for name, div in divs.items():
        host_ops[name] = round2_ops(pods, outer, div)
        rows = compare(host_ops[name],
                       round2_ops(card_pods, card_outer, div))
        report[name] = rows
        for r in rows:
            print(f"[probe] scale={name} op={r['op']} leaves={r['leaves']} "
                  f"differing={r['differing']} first={r['first']}")

    x = torch.rand(1_000_000, generator=torch.Generator().manual_seed(0))
    host = x / 127.0
    for name, div in divs.items():
        n = int((div(x.to(dev)).cpu().view(torch.int32)
                 != host.view(torch.int32)).sum())
        report[f"isolated_{name}"] = n
        print(f"[probe] isolated x/127 scale={name}: {n} of 1000000 "
              f"values differ from the host's division")

    ho = global_sync(pods, outer, compress=True)[1]
    # the op-by-op replica is the library's round 2 on the host
    from repro_torch.core.hybrid_sync import _by_leaf
    stack = _by_leaf(ho.momentum)[0]
    report["replica_is_library"] = not any(
        _differs(host_ops[name][op][k], want[k])
        for name in divs for op, want in (
            ("momentum", stack({k: v[None] for k, v in
                                ho.momentum.items()})),
            ("anchor", stack({k: v[None] for k, v in ho.anchor.items()})))
        for k in want)
    print(f"[probe] the replica's host round 2 is global_sync's: "
          f"{report['replica_is_library']}")
    co = global_sync(card_pods, card_outer, compress=True)[1]
    same = {part: [k for k in getattr(ho, part) if _differs(
        getattr(ho, part)[k], getattr(co, part)[k])]
        for part in ("anchor", "momentum")}
    same["residual"] = [k for k in ho.ef.residual if _differs(
        ho.ef.residual[k], co.ef.residual[k])]
    report["global_sync_round2_differing"] = same
    report["bit_identical"] = ok = not any(same.values())
    print(f"[probe] global_sync round 2 card vs host: bit_identical={ok} "
          f"differing={json.dumps(same)}")
    return report


if __name__ == "__main__":
    sys.exit(main())
