"""The executor's device -> host control reads, counted.

The host-driven loops (the outer ``quiescent`` check, the local phase's
``running.any()`` per pseudo-superstep) steer on values that live on the
device; each read waits for the device.  Every such read goes through
:func:`host_read` (a () flag) or :func:`host_read_mask` (a per-lane mask:
the serving layer's lane-convergence check), so a run can report how many
it made.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["host_read", "host_read_mask", "host_reads", "reset_host_reads"]

_READS = [0]


def host_read(flag: torch.Tensor) -> bool:
    """``bool(flag)`` for a () bool tensor, counted as one host sync."""
    _READS[0] += 1
    return bool(flag)


def host_read_mask(mask: torch.Tensor) -> np.ndarray:
    """A bool tensor as a numpy array, counted as one host sync."""
    _READS[0] += 1
    return mask.cpu().numpy()


def host_reads() -> int:
    return _READS[0]


def reset_host_reads() -> None:
    _READS[0] = 0
