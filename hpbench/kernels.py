"""The port's kernels at this graph's shapes: one row per (kernel, bin)
with its launches a job in the measured window, its device ms on cold
operands and its bound (``hpbench.roofline``).

Each call goes through the port's public kernel ops (``fused_min_step``,
``ell_spmv``) on the graph's own ELL tiles.  The frontiers are drawn from
the run's seed: the first job's final state as values, half the sources
sending (the smoke's choice).  ``ell_spmv`` launches are counted by bin
shape, so two bins of one shape (a local and a remote base bin) share
their count evenly.
"""

from __future__ import annotations

import torch

from hpbench.profiling import device_ms
from hpbench.roofline import bound_ms, work_bytes

__all__ = ["kernel_rows"]

_IDENTITY = {"min_add": float("inf")}


def _bins(graph, prog):
    """(side, bin index, slice, idx, val, msk, plan) of every ELL bin."""
    from repro_torch.core.runtime import ell_plans, slice_flat
    ch = prog.channels[0]
    for side in ("local", "remote"):
        slices = graph.local_ell if side == "local" else graph.remote_ell
        plans = ell_plans(graph, side)
        for b, s in enumerate(slices):
            _, idx, msk = slice_flat(s, graph, graph.n_partitions)
            val = prog.ell_edge_values(ch, s.val).reshape(-1, s.kb)
            yield side, b, s, idx, val, msk, plans[b]


def _row(kernel, label, launches, call, ops, nbytes, nnz, ops_per):
    ms = device_ms(call, ops, nbytes)
    return {"kernel": kernel, "bin": label, "launches": launches,
            "device_ms": ms, "bytes": nbytes,
            "bound_ms": bound_ms(nbytes, nnz, ops_per)}


def kernel_rows(graph, prog, x, launches: dict, bin_launches: dict,
                gen: torch.Generator) -> list[dict]:
    """Rows for every kernel a run of ``prog`` launched on ``graph``:
    ``launches`` is ``LAUNCHES`` and ``bin_launches`` ``BIN_LAUNCHES`` over
    the window, each a job; ``x`` the (P, Vp) values of a finished job."""
    from repro_torch.kernels.ell_spmv import ell_spmv
    from repro_torch.kernels.min_step import fused_min_step

    dev = graph.vertex_gid.device
    sr = prog.channels[0].semiring
    ident = _IDENTITY[sr]
    rows = []

    def send(n):
        return torch.rand(n, generator=gen, device=dev) < 0.5

    def values(n):
        v = x.reshape(-1).float().to(dev)
        return v.repeat(-(-n // v.numel()))[:n].contiguous()

    bins = list(_bins(graph, prog))
    by_shape = {}
    for _, _, _, idx, _, _, _ in bins:
        key = f"ell_spmv {idx.shape[0]}x{idx.shape[1]}"
        by_shape[key] = by_shape.get(key, 0) + 1

    # the fused local step over the local base bin
    side, b, s, idx, val, msk, _ = bins[0]
    n = idx.shape[0]
    fused = getattr(prog, "fused_kernel", None)
    if fused == "min_step" and launches.get(fused):
        v = values(n)
        ops = (idx, val, msk, v, send(n), v, torch.full((n,), ident,
                                                         device=dev))
        nbytes = work_bytes(msk, idx, 17, flag=ops[4], x_is_row=True)
        rows.append(_row("min_step", f"local bin0 {tuple(idx.shape)}",
                         launches[fused], fused_min_step, ops, nbytes,
                         int(msk.sum()), 2))

    # ell_spmv over every bin of both sides
    for side, b, s, idx, val, msk, plan in bins:
        key = f"ell_spmv {idx.shape[0]}x{idx.shape[1]}"
        count = bin_launches.get(key, 0) / by_shape[key]
        if not count:
            continue
        n_src = graph.n_partitions * s.stride
        xs = torch.where(send(n_src), values(n_src), ident).contiguous()
        rows.append(_row(
            "ell_spmv", f"{side} bin{b} {tuple(idx.shape)}", count,
            lambda *a, plan=plan: ell_spmv(*a, semiring=sr, plan=plan),
            (idx, val, msk, xs), work_bytes(msk, idx, 4), int(msk.sum()), 2))
        del xs
    return rows
