"""What the card says: a profiled window's busy and idle time, the device
time of the port's kernels against the rest (the glue), the longest idle
gaps by what the host was doing, and the device time of one kernel call on
cold operands (a replayed CUDA graph).

Copied from ``chip_smoke.py`` (``device_ms``, ``_profiled``) and rewritten
here, so that a later change to the program cannot move the yardstick.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

__all__ = ["COLD_BYTES", "power_limit", "device_ms", "profile_window",
           "is_port_kernel"]

# operand bytes a timed run of graph-replayed calls cycles through: three
# times the H100's 50 MB L2, so no call finds its operands there
COLD_BYTES = 150_000_000
# a session that loses its device records is run again, up to this many
PROFILE_TRIES = 4


def power_limit() -> str | None:
    """``nvidia-smi``'s name and power limit of the first card, or None
    where it does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def is_port_kernel(name: str) -> bool:
    """A device operation built from the port's ``csrc/``: the kernels of
    the ``graphhp`` namespace and the device loop's ``graphhp_set_condition``."""
    return "graphhp" in name


def _clone(t):
    return t.clone() if isinstance(t, torch.Tensor) else t


def device_ms(call, ops, nbytes: int, reps: int = 20,
              windows: int = 5) -> float:
    """Device ms per call of ``call(*ops)``: a run of calls captured once
    into a CUDA graph and replayed ``windows`` times (the median of the
    windows' mean), so the host's launch path does not count.  The calls
    cycle through copies of ``ops`` whose bytes read (``nbytes`` a call)
    add up to at least ``COLD_BYTES``, so every call reads its operands
    from HBM.  Raises if the calls cannot be captured."""
    uniq = {id(t): t for t in ops}
    copies = max(1, -(-COLD_BYTES // max(nbytes, 1)))
    sets = [tuple(ops)]
    for _ in range(copies - 1):
        memo = {k: _clone(t) for k, t in uniq.items()}
        sets.append(tuple(memo[id(t)] for t in ops))
    reps = max(reps, copies)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call(*ops)
        call(*ops)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            call(*sets[i % copies])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph, sets
    return statistics.median(times)


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_label(cpu_events, t: float, label: str) -> str:
    """The innermost host range open at ``t`` (us), under ``label``."""
    best = None
    for e in cpu_events:
        r = e.time_range
        if r.start <= t <= r.end and e.name != label and (
                best is None or r.end - r.start <
                best.time_range.end - best.time_range.start):
            best = e
    return label if best is None else f"{label}>{best.name}"


def profile_window(fn, label: str, top: int = 10):
    """``fn()`` under ``torch.profiler`` inside a ``record_function(label)``
    range, which is the traced window.  Returns ``(fn's result, trace)``;
    ``trace`` holds ``window_s``, ``busy_s`` (the union of device activity
    in the window), ``glue_s`` and ``port_s`` (device seconds outside and
    inside the port's kernels), ``ops`` (the ``top`` device operations by
    seconds) and ``gaps`` (the ``top`` longest idle gaps, each named by the
    host range open in its middle).  A session that returns no device
    records is run again, up to ``PROFILE_TRIES`` sessions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(label):
                out = fn()
                torch.cuda.synchronize()
        events = list(prof.events())
        # device kernels, copies and fills; not the device side of the
        # host's record_function ranges
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and e.name != label]
        if dev:
            break
    else:
        raise RuntimeError(f"{PROFILE_TRIES} profiler sessions returned no "
                           f"device records")
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    win = [e for e in cpu if e.name == label]
    w0 = min(e.time_range.start for e in win)
    w1 = max(e.time_range.end for e in win)
    spans, by_name = [], {}
    glue = port = 0.0
    for e in dev:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        spans.append((s, t))
        d = (t - s) / 1e6
        by_name[e.name] = by_name.get(e.name, 0.0) + d
        if is_port_kernel(e.name):
            port += d
        else:
            glue += d
    merged = _union(spans)
    busy = sum(t - s for s, t in merged) / 1e6
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    trace = {
        "window_s": (w1 - w0) / 1e6, "busy_s": busy, "glue_s": glue,
        "port_s": port,
        "ops": [[n, s] for n, s in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:top]],
        "gaps": [[_host_label(cpu, g0 + d / 2, label), d / 1e6]
                 for d, g0 in gaps],
    }
    return out, trace

