"""The executor's device -> host control reads, counted.

The host-driven loops (the outer ``quiescent`` check of ``run_engine``
with ``device_loop=False``, the serving layer's lane masks) steer on values
that live on the device; each read waits for the device.  Every such read
goes through :func:`host_read` (a () flag), :func:`host_read_int` (a ()
count) or :func:`host_read_mask` (a per-lane mask), so a run can report
how many it made.  A device-resident loop
(:mod:`repro_torch.exec.device_loop`) makes none until it ends.

Each read also carries home, in the same transfer, the trip counters of
the loops launched since the previous one, which is where their kernels'
launches are counted (:func:`repro_torch.kernels.common.settle_launches`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import settle_launches, unsettled

__all__ = ["host_read", "host_read_int", "host_read_mask", "host_reads",
           "reset_host_reads"]

_READS = [0]


def _fetch(t: torch.Tensor) -> torch.Tensor:
    """``t`` (bool or integer) on the host, counted as one host sync."""
    _READS[0] += 1
    counts = unsettled(t.device)
    if not counts:
        return t.cpu()
    flat = torch.cat([t.reshape(-1).to(torch.int64)]
                     + [c.trips.reshape(1) for c in counts]).cpu()
    settle_launches(counts, flat[t.numel():].tolist())
    return flat[:t.numel()].reshape(t.shape).to(t.dtype)


def host_read(flag: torch.Tensor) -> bool:
    """``bool(flag)`` for a () bool tensor, counted as one host sync."""
    return bool(_fetch(flag))


def host_read_int(count: torch.Tensor) -> int:
    """``int(count)`` for a () integer tensor, counted as one host sync."""
    return int(_fetch(count))


def host_read_mask(mask: torch.Tensor) -> np.ndarray:
    """A bool tensor as a numpy array, counted as one host sync."""
    return _fetch(mask).numpy()


def host_reads() -> int:
    return _READS[0]


def reset_host_reads() -> None:
    _READS[0] = 0
