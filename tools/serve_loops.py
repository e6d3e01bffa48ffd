#!/usr/bin/env python3
"""Serving's K = 16 grid batch under the device loop and stepped wholly
from the host, on one NVIDIA GPU.

    python3 tools/serve_loops.py [--iters 4] [--profile-iters 1]

Builds the smoke's 2048 x 2048 grid (``chip_smoke.grid_sssp_graph``) and
its 16 serving sources, then drains them twice over as two K = 16 SSSP
batches through one ``ServeEngine.run`` with ``max_iters=--iters``, four
times, in the order device, host, host, device.  "device" is the default
dispatch: one CUDA graph per (program, K) entry and drain, built by the
first batch and replayed by the second.  "host" is the same drain inside
``repro_torch.exec.device_loop.host_loops()``: every loop a host loop,
one kernel launch at a time, one host read a loop condition.  Every
drain must give the first one's lanes bit for bit.  Prints, per drain,
the seconds (the device drains' graph build included, and printed
apart), the local steps (``min_step`` launches), ms a local step, host
reads and loops built.

Then one batch of ``--profile-iters`` iterations each way runs under
``torch.profiler`` (the device loop's graph built inside the window, so
its build is in the wall time): the device-busy share of the wall time
and the device time of the kernels grouped as copies (device-to-device
memcpys: the device loop copies each carry leaf a trip produces back into
its static buffer), casts, ``min_step``, ``ell_spmv``, the loop's
set-condition kernel and the rest, and the ten kernels that took the most
device time.  The last line is one JSON object holding every number,
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

#: kernel-name groups of the profile, first match wins: ``copies`` are
#: device-to-device memcpys (a same-dtype ``copy_``; in a captured graph a
#: memcpy node), ``casts`` PyTorch's elementwise copy kernel (dtype casts)
GROUPS = (("copies", ("memcpy", "Memcpy")),
          ("casts", ("direct_copy_kernel",)),
          ("min_step", ("min_step",)),
          ("pr_step", ("pr_step",)),
          ("ell_spmv_wide", ("ell_warp_rows_kernel", "ell_block_rows_kernel")),
          ("ell_spmv", ("graphhp::ell_",)),
          ("set_condition", ("graphhp_set_condition",)))


def kernel_group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def _batch(eng, sources, host: bool, batches: int = 1):
    """``batches`` K-lane batches of ``sources`` through one
    ``eng.run()``; returns the lanes (numpy) and the drain's numbers."""
    import contextlib

    import torch
    from repro_torch.exec.device_loop import BUILDS, host_loops, \
        reset_builds
    from repro_torch.exec.syncs import host_reads, reset_host_reads
    from repro_torch.kernels.common import LAUNCHES, reset_launches

    for _ in range(batches):
        for s in sources:
            eng.submit("sssp", s)
    torch.cuda.synchronize()
    reset_launches()
    reset_host_reads()
    reset_builds()
    t = time.perf_counter()
    with host_loops() if host else contextlib.nullcontext():
        qs = eng.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    steps = LAUNCHES["min_step"]
    return [q.result for q in qs], dict(
        loop="host" if host else "device", seconds=secs, local_steps=steps,
        ms_per_step=secs / max(steps, 1) * 1e3,
        iterations=qs[0].iterations, host_reads=host_reads(),
        loops_built=BUILDS["loops"],
        build_s=BUILDS["capture_s"] + BUILDS["instantiate_s"])


def _profile(graph, sources, iters: int, host: bool) -> dict:
    """One batch of a fresh engine under ``torch.profiler``: wall and
    device-busy seconds and device ms by kernel group.  The device loop's
    graph is built inside the profiled window: the kernels of a graph
    instantiated before the profiler started do not show in its trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(graph, lane_widths=(len(sources),), max_iters=iters)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        _, row = _batch(eng, sources, host)
        wall = time.perf_counter() - t
    groups: dict[str, float] = {}
    calls: dict[str, int] = {}
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    for e in rows:
        g = kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
        calls[g] = calls.get(g, 0) + e.count
    busy = sum(groups.values()) / 1e3
    top = [dict(kernel=e.key[:90], calls=e.count,
                device_ms=e.self_device_time_total / 1e3)
           for e in sorted(rows, key=lambda e: e.self_device_time_total,
                           reverse=True)[:10]]
    return dict(loop=row["loop"], wall_s=wall, device_busy_s=busy,
                idle_share=1 - busy / wall, local_steps=row["local_steps"],
                device_ms=groups, calls=calls, top_kernels=top)


def measure(graph, sources, iters: int, profile_iters: int) -> dict:
    """The four drains and the two profiles on ``graph``."""
    import numpy as np
    from repro_torch.serve import ServeEngine

    K = len(sources)
    eng = ServeEngine(graph, lane_widths=(K,), max_iters=iters)
    rows, first = [], None
    for host in (False, True, True, False):
        lanes, row = _batch(eng, sources, host, batches=2)
        if first is None:
            first = lanes
        row["bit_identical"] = all(np.array_equal(a, b)
                                   for a, b in zip(lanes, first))
        rows.append(row)
        print("[serve_loops]", " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()), flush=True)
    del eng
    profiles = [_profile(graph, sources, profile_iters, host)
                for host in (False, True)]
    for p in profiles:
        print("[serve_loops] profile", json.dumps(p), flush=True)
    return dict(K=K, iters=iters, batches=rows, profile_iters=profile_iters,
                profiles=profiles, ok=all(r["bit_identical"] for r in rows))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--profile-iters", type=int, default=1)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    graph, _, _ = chip_smoke.grid_sssp_graph()
    out = measure(graph, chip_smoke.serve_sources(), args.iters,
                  args.profile_iters)
    print(json.dumps(dict(card=smi, **out)))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
