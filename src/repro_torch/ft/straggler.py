"""Straggler mitigation.

Two mechanisms, one per workload kind:

* serving: deadline-based re-dispatch — a request batch stuck past the
  p99-derived deadline is re-enqueued to another replica slot; first result
  wins (duplicate suppression by request id).
* training (hybrid sync): pods vote — the global phase proceeds when a
  quorum of pods delivered deltas; laggard deltas ride the next exchange via
  the error-feedback residual (gradient-skip voting, DESIGN.md §7).

A copy of ``repro.ft.straggler``, less its metrics-registry input.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.obs import clock as obs_clock


@dataclasses.dataclass
class PendingWork:
    work_id: int
    issued_at: float
    replica: int
    attempts: int = 1
    done: bool = False


class StragglerMitigator:
    def __init__(self, deadline_factor: float = 3.0, min_deadline: float = 0.5,
                 clock: Callable | None = None):
        # default: the installable obs clock (an explicit clock= still wins)
        self.clock = clock if clock is not None else obs_clock.monotonic
        self.deadline_factor = deadline_factor
        self.min_deadline = min_deadline
        self._lat_ewma: float | None = None
        self.pending: dict[int, PendingWork] = {}
        self.duplicates_suppressed = 0
        self.redispatches = 0

    # -- latency model ----------------------------------------------------
    def observe_latency(self, dt: float) -> None:
        self._lat_ewma = dt if self._lat_ewma is None else \
            0.9 * self._lat_ewma + 0.1 * dt

    @property
    def deadline(self) -> float:
        base = self._lat_ewma if self._lat_ewma is not None else self.min_deadline
        return max(self.min_deadline, self.deadline_factor * base)

    # -- dispatch ----------------------------------------------------------
    def issue(self, work_id: int, replica: int) -> None:
        self.pending[work_id] = PendingWork(work_id, self.clock(), replica)

    def complete(self, work_id: int) -> bool:
        """Returns False if this was a duplicate (already completed)."""
        w = self.pending.get(work_id)
        if w is None or w.done:
            self.duplicates_suppressed += 1
            return False
        self.observe_latency(self.clock() - w.issued_at)
        w.done = True
        return True

    def overdue(self) -> list[PendingWork]:
        now = self.clock()
        out = [w for w in self.pending.values()
               if not w.done and now - w.issued_at > self.deadline]
        for w in out:
            w.issued_at = now
            w.attempts += 1
            self.redispatches += 1
        return out


def quorum_ready(delivered: int, total: int, quorum: float = 0.75) -> bool:
    """Training: global phase proceeds when >= quorum of pods delivered."""
    return delivered >= max(1, int(total * quorum))


# ---------------------------------------------------------------------------
# graph-engine stragglers: slow shards, from the paper's own counters
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardFlag:
    """One flagged slow shard.  ``cause`` separates the two remedies: a
    shard slow *because it is oversized* ('skew' — re-partition it, the
    ladder's job) from one slow on balanced data ('straggler' — the node is
    the problem, re-dispatch / reassign)."""

    partition: int
    pseudo_supersteps: int
    ratio: float               # vs the median shard
    cause: str                 # 'skew' | 'straggler'


def flag_slow_shards(pseudo_supersteps=None, balance: float | None = None,
                     factor: float = 1.5) -> list[ShardFlag]:
    """Flag shards whose local phase runs long, from the per-partition
    ``Counters.pseudo_supersteps`` the hybrid engine already keeps.

    GraphHP's local phase iterates each partition to its own convergence,
    so a partition's pseudo-superstep count *is* its work clock — a shard
    running ``factor``x past the median is holding the next exchange
    hostage.  ``balance`` (``PartitionReport.balance`` — max partition
    size over the even share) classifies the flag: when the labeling
    itself is skewed past the same factor the remedy is re-partitioning,
    not failover, so the cause reads 'skew'.

    The reference also reads both inputs off a metrics registry; the port
    has no metrics registry yet, so the counters are passed in."""
    import numpy as np

    if pseudo_supersteps is None:
        return []
    counts = np.asarray(pseudo_supersteps)
    if counts.ndim != 1 or not counts.size:
        return []
    med = float(np.median(counts))
    floor = max(med, 1.0)
    flags = []
    for p in np.flatnonzero(counts > factor * floor):
        cause = ("skew" if balance is not None and balance > factor
                 else "straggler")
        flags.append(ShardFlag(int(p), int(counts[p]),
                               float(counts[p] / floor), cause))
    return flags
