"""Multi-pod dry run (the port of ``repro.launch.dryrun``): run every
(architecture × input shape) cell once on the single-pod (16×16) and
multi-pod (2×16×16) production meshes, as rank 0 of a ``fake`` process
group of 256 or 512 ranks, on ``meta`` tensors — nothing is allocated and
no card is needed — and record per rank: FLOPs (``FlopCounterMode``; the
port's compute is on local tensors, so these are this rank's), argument
bytes (from the placements), collective calls (``CommDebugMode``) and
bytes (the port's own counter, ``core.distributed.COMM``), and peak bytes
(arguments plus what ``MemTracker`` sees allocated on ``meta``).

Ops on ``meta`` run their Python reference implementations (~0.3 ms
each), and a 32k prefill runs 2,048 flash blocks a layer, so each LM cell
runs twice as probes, as the reference's dry run does: with no repeating
unit (C0) and with one (C1).  FLOPs and collectives are then C0 + n_units
× (C1 − C0), exact for a stack of identical units (head layers are in
C0; a tail after the units is left out, as in the reference).  The
temporaries' peak is the one-unit probe's.  A train cell also runs with
two units (C2): C2 − C1 is what each unit adds to the peak
(``peak_bytes_per_unit``: its remat carry, and the unit's gradients where
the peak is the update's), and ``stack_peak_bytes`` the whole stack's
peak, C1's plus n_units − 1 such units.  Prefill and decode run without
grad, keep no unit's activations and are not probed so.

``--seq-parallel`` turns on sequence parallelism (``sharding.util.
seq_parallel``) for the sweep and tags the records ``-sp`` unless
``--variant`` names another tag: the residual stream between units, and
with it each unit's remat carry, is then sharded over ``model``.  The
stack shards only around its units, so the 0-unit probe has none of the
stretch's own collectives: with the switch on, every cell runs C2
in place of C0 and extrapolates C1 + (n_units − 1) × (C2 − C1).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch X]
        [--shape Y] [--mesh single|multi|both] [--seq-parallel]
        [--out build/dryrun]

Each cell writes its JSON as it ends, so a long sweep is resumable
(--skip-done).  Failures are recorded: they are bugs in the system.  The
reference's lowering reads XLA's HLO; nothing here does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig,
                                      get_config)
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_F32,
                                     make_production_mesh, set_mesh)
from repro_torch.launch.specs import (BF16, arg_bytes, build_cell,
                                      place_args, runnable)
from repro_torch.sharding.util import seq_axis, seq_parallel

__all__ = ["ARCHS", "run_cell", "run_graphhp_cell", "run_sync_cell",
           "fake_world", "main"]

# LM cells dry-run only via an explicit --arch (or an ArchConfig); the
# default sweep is the paper's own graph workload (--graphhp).
ARCHS: list[str] = []


def _lm_config(arch) -> ArchConfig:
    if isinstance(arch, ArchConfig):
        return arch
    from repro_torch.configs.lm_smoke import DEMO_100M, SMOKE_FAMILIES
    for cfg in (DEMO_100M, *SMOKE_FAMILIES.values()):
        if cfg.name == arch:
            return cfg
    return get_config(arch)


def fake_world(size: int) -> None:
    """This process as rank 0 of a ``fake`` group of ``size`` ranks (a
    group of another size is replaced)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _mesh(multi_pod: bool):
    fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def _measure(fn, *args) -> dict:
    """Run ``fn(*args)`` once under the FLOP counter, the collective
    counter and the memory tracker."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.distributed import COMM, reset_comm
    reset_comm()
    mt, temp, why = MemTracker(), None, None
    with FlopCounterMode(display=False) as fc, CommDebugMode() as cm, mt:
        fn(*args)
    try:
        temp = int(mt.get_tracker_snapshot("peak")[torch.device("meta")]
                   ["Total"])
    except (KeyError, RuntimeError) as e:
        why = f"MemTracker: {type(e).__name__}: {e}"
    return dict(flops=float(fc.get_total_flops()),
                collective_calls={str(k): int(v) for k, v in
                                  cm.get_comm_counts().items()},
                collectives=int(COMM["collectives"]),
                collective_bytes=int(COMM["wire_bytes"]),
                temp_peak_bytes=temp, temp_peak_note=why)


def _terms(flops: float, bytes_: int, coll: int) -> dict:
    """Least times on one H100 SXM at 700 W: FLOPs at the float32 rate
    (the port's matmuls accumulate in float32 from any storage dtype),
    argument bytes at the HBM rate, collective bytes at NVLink's."""
    t = {"t_compute_s": flops / PEAK_FLOPS_F32,
         "t_memory_s": bytes_ / HBM_BW,
         "t_collective_s": coll / NVLINK_BW}
    t["dominant"] = max(("compute", "memory", "collective"),
                        key=lambda k: t[f"t_{k}_s"])
    return t


def _probe_cfg(cfg, k_units: int):
    """Same arch with k repeating units (a tail is dropped)."""
    n = (cfg.first_k_dense or 0) + k_units * len(cfg.pattern)
    repl = {"n_layers": n}
    if cfg.family == "audio":
        repl["enc_layers"] = k_units
    return dataclasses.replace(cfg, **repl)


def _n_units(cfg) -> int:
    return (cfg.n_layers - (cfg.first_k_dense or 0)) // len(cfg.pattern)


def _probe(cfg, shape, mesh, multi_pod, mb, param_dtype=BF16) -> dict:
    """The cell's FLOPs and collectives from its probes, and what a unit
    adds to a train cell's peak.  With sequence parallelism on, the stack
    shards its stream only around units, so the 0-unit probe lacks the
    stretch's own collectives: the cell then extrapolates from the 1- and
    2-unit probes."""
    n = _n_units(cfg)
    a = 1 if seq_axis() is not None and n else 0       # the base probe
    cs = {k: _run(build_cell(_probe_cfg(cfg, k), shape, mesh, multi_pod,
                             microbatches=mb, param_dtype=param_dtype), mesh)
          for k in range(a, 3 if shape.kind == "train" else a + 2)}
    base, unit = cs[a], cs[a + 1]
    out = {k: base[k] + (n - a) * (unit[k] - base[k])
           for k in ("flops", "collectives", "collective_bytes")}
    out["collective_calls"] = {k: base["collective_calls"].get(k, 0)
                               + (n - a) * (v - base["collective_calls"].get(
                                   k, 0))
                               for k, v in unit["collective_calls"].items()}
    out["extrapolation"] = {"n_units": n, "from_probes": [a, a + 1],
                            "unit_flops": unit["flops"] - base["flops"],
                            "unit_coll_bytes": unit["collective_bytes"]
                            - base["collective_bytes"]}
    c1 = cs[1]
    out["temp_peak_bytes"] = c1["temp_peak_bytes"]
    out["temp_peak_note"] = c1["temp_peak_note"]
    out["peak_bytes_per_unit"] = out["stack_temp_peak_bytes"] = None
    peaks = [cs[k]["temp_peak_bytes"] for k in (1, 2) if k in cs]
    if shape.kind == "train" and None not in peaks:
        out["peak_bytes_per_unit"] = peaks[1] - peaks[0]
        out["stack_temp_peak_bytes"] = peaks[0] + (n - 1) * (peaks[1]
                                                             - peaks[0])
    return out


def _run(cell, mesh) -> dict:
    with set_mesh(mesh):
        return _measure(cell.fn, *place_args(cell))


def run_cell(arch, shape_name, multi_pod: bool, out_dir: str,
             verbose: bool = True, variant: str = "",
             microbatches: int = 1) -> dict:
    """``arch``: a config name or an ``ArchConfig``; ``shape_name``: a key
    of ``SHAPES`` or a ``ShapeConfig``."""
    mesh_tag = ("multi" if multi_pod else "single") + \
        (f"-{variant}" if variant else "")
    name = arch.name if isinstance(arch, ArchConfig) else arch
    if isinstance(shape_name, ShapeConfig):
        shape_name, shape = shape_name.name, shape_name
    else:
        shape = None
    rec = {"arch": name, "shape": shape_name, "mesh": mesh_tag,
           "status": "unknown"}
    try:
        cfg = _lm_config(arch)
        shape = shape or SHAPES[shape_name]
    except KeyError as e:
        rec.update(status="fail", error=f"unknown arch/shape: {e}")
        return _write(rec, out_dir)

    ok, why = runnable(cfg, shape)
    if not ok:
        rec.update(status="skip", reason=why)
        return _write(rec, out_dir)

    t0 = time.time()
    try:
        mesh = _mesh(multi_pod)
        mb = microbatches if shape.kind == "train" else 1
        args = arg_bytes(build_cell(cfg, shape, mesh, multi_pod,
                                    microbatches=mb))
        m = _probe(cfg, shape, mesh, multi_pod, mb)
        total = sum(args.values())
        stack = m["stack_temp_peak_bytes"]
        rec.update(
            status="ok", elapsed_s=round(time.time() - t0, 2),
            devices=int(mesh.size()),
            memory=dict(argument_bytes=total, arguments=args,
                        peak_bytes=(None if m["temp_peak_bytes"] is None
                                    else total + m["temp_peak_bytes"]),
                        peak_note=m["temp_peak_note"] or (
                            "arguments plus MemTracker's peak on meta of "
                            "the one-unit probe"),
                        peak_bytes_per_unit=m["peak_bytes_per_unit"],
                        stack_temp_peak_bytes=stack,
                        stack_peak_bytes=(None if stack is None
                                          else total + stack)),
            extrapolation=m["extrapolation"],
            flops=m["flops"], collectives=m["collectives"],
            collective_calls=m["collective_calls"],
            collective_bytes=m["collective_bytes"],
            roofline=_terms(m["flops"], total, m["collective_bytes"]))
        if verbose:
            print(f"[ok] {name} {shape_name} {mesh_tag}: "
                  f"args/rank={total / 2**30:.3f}GiB "
                  f"peak/unit={m['peak_bytes_per_unit']} "
                  f"flops/rank={m['flops']:.3e} "
                  f"coll={m['collective_bytes']:.3e}B "
                  f"dom={rec['roofline']['dominant']} "
                  f"({time.time() - t0:.1f}s)", flush=True)
    except Exception as e:          # a failing cell is recorded, not fatal
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[FAIL] {name} {shape_name} {mesh_tag}: {e}", flush=True)
    return _write(rec, out_dir)


def _nbytes(tree) -> int:
    from repro_torch.core.distributed import _tree_leaves
    return sum(t.numel() * t.element_size() for t in _tree_leaves(tree))


def run_graphhp_cell(multi_pod: bool, out_dir: str, smoke: bool = False,
                     wire_bf16: bool = False, variant: str = "") -> dict:
    """The paper's own workload, one partition per rank: the bytes of a
    rank's block of the graph and the engine state, and one global
    iteration's exchange (its all-gather of the export tables, run on
    ``meta``).  FLOPs are not counted: the hybrid step reads the host
    inside its local loop, so it does not run on ``meta``."""
    from functools import partial

    from repro_torch.configs.graphhp_paper import CONFIG, SMOKE
    from repro_torch.core.apps.sssp import SSSP
    from repro_torch.core.distributed import (COMM, all_gather_rows,
                                              block_graph_shapes,
                                              engine_state_shapes,
                                              reset_comm)
    from repro_torch.core.runtime import exchange

    gcfg = SMOKE if smoke else CONFIG
    mesh_tag = ("multi" if multi_pod else "single") + \
        (f"-{variant}" if variant else "")
    rec = {"arch": gcfg.name, "shape": "hybrid_iteration", "mesh": mesh_tag,
           "status": "unknown"}
    t0 = time.time()
    try:
        mesh = _mesh(multi_pod)
        block = block_graph_shapes(
            1, gcfg.vertices_per_partition, gcfg.edges_per_partition,
            gcfg.exports_per_partition, gcfg.halo_per_partition)
        es = engine_state_shapes(SSSP(source=0), block)
        reset_comm()
        exchange(block, es, gather_table=partial(all_gather_rows, group=None),
                 wire_dtype=torch.bfloat16 if wire_bf16 else None)
        gb, eb = _nbytes(block), _nbytes(es)
        rec.update(status="ok", devices=int(mesh.size()),
                   partitions=int(mesh.size()),
                   memory=dict(graph_bytes=gb, state_bytes=eb,
                               argument_bytes=gb + eb),
                   flops=None,
                   flops_note="the hybrid step reads the host inside its "
                              "local loop: it does not run on meta",
                   collectives=int(COMM["collectives"]),
                   exchange_bytes=int(COMM["wire_bytes"]),
                   wire_bf16=wire_bf16,
                   elapsed_s=round(time.time() - t0, 2))
        print(f"[ok] graphhp {mesh_tag}: graph+state/rank="
              f"{(gb + eb) / 2**20:.2f}MiB exchange="
              f"{rec['exchange_bytes']:.3e}B", flush=True)
    except Exception as e:          # a failing cell is recorded, not fatal
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[FAIL] graphhp {mesh_tag}: {e}", flush=True)
    return _write(rec, out_dir)


def run_sync_cell(arch, out_dir: str, compress: bool = True,
                  variant: str = "") -> dict:
    """The hybrid-sync global phase on the multi-pod mesh: the pods on the
    ``pod`` dimension, each rank's shard of its pod's parameters, one
    exchange over the pod group.  Records the bytes of the int8 all-gather
    (with ``compress``) against the float32 deltas'."""
    from repro_torch.core.hybrid_sync import global_sync, outer_init
    from repro_torch.launch.specs import shard_module
    from repro_torch.models.registry import param_shapes
    from repro_torch.sharding.rules import param_specs
    from repro_torch.sharding.util import named, sanitize_specs

    name = arch.name if isinstance(arch, ArchConfig) else arch
    tag = "multi" + (f"-{variant}" if variant else "")
    rec = {"arch": name, "shape": "global_sync", "mesh": tag,
           "status": "unknown", "compress": compress}
    t0 = time.time()
    try:
        cfg = _lm_config(arch)
        mesh = _mesh(True)
        model = param_shapes(cfg, torch.bfloat16)
        shard_module(model, named(sanitize_specs(param_specs(model), model,
                                                 mesh), mesh))
        outer = outer_init(model, 1)
        with set_mesh(mesh):
            m = _measure(lambda: global_sync([model], outer,
                                             compress=compress,
                                             group=mesh.get_group("pod")))
        f32 = sum(p._local_tensor.numel() * 4 for p in model.parameters())
        rec.update(status="ok", devices=int(mesh.size()),
                   collectives=m["collectives"],
                   collective_calls=m["collective_calls"],
                   collective_bytes=m["collective_bytes"],
                   f32_delta_gather_bytes=f32 * mesh.size(0),
                   flops=m["flops"],
                   elapsed_s=round(time.time() - t0, 2))
        print(f"[ok] {name} global_sync {tag} compress={compress}: "
              f"coll={m['collective_bytes']:.3e}B (float32 deltas "
              f"{f32 * mesh.size(0):.3e}B)", flush=True)
    except Exception as e:          # a failing cell is recorded, not fatal
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[FAIL] {name} global_sync: {e}", flush=True)
    return _write(rec, out_dir)


def _write(rec: dict, out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    fn = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(out_dir, fn), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default=os.path.join("build", "dryrun"))
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--graphhp", action="store_true",
                    help="also dry-run the paper's graph engine")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="shard the residual stream between units over "
                         "model (sequence parallelism); tags the records "
                         "'sp' unless --variant is given")
    ap.add_argument("--variant", default="",
                    help="tag appended to the mesh name in output JSONs")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="grad-accumulation microbatches for train cells")
    ap.add_argument("--graphhp-wire-bf16", action="store_true",
                    help="quantize graph-engine exchange payloads to bf16")
    args = ap.parse_args(argv)

    if args.seq_parallel and not args.variant:
        args.variant = "sp"
    with seq_parallel(args.seq_parallel):
        archs = [args.arch] if args.arch else ARCHS
        shapes = [args.shape] if args.shape else list(SHAPES)
        meshes = {"single": [False], "multi": [True],
                  "both": [False, True]}[args.mesh]

        n_fail = 0
        for multi in meshes:
            tag = "multi" if multi else "single"
            for arch in archs:
                for shape in shapes:
                    vtag = tag + (f"-{args.variant}" if args.variant else "")
                    fn = os.path.join(args.out,
                                      f"{arch}__{shape}__{vtag}.json")
                    if args.skip_done and os.path.exists(fn):
                        with open(fn) as f:
                            if json.load(f).get("status") in ("ok", "skip"):
                                continue
                    rec = run_cell(arch, shape, multi, args.out,
                                   variant=args.variant,
                                   microbatches=args.microbatches)
                    n_fail += rec["status"] == "fail"
            if args.graphhp:
                rec = run_graphhp_cell(multi, args.out,
                                       wire_bf16=args.graphhp_wire_bf16,
                                       variant=args.variant)
                n_fail += rec["status"] == "fail"
        print(f"dry-run complete; failures: {n_fail}", flush=True)
        return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
