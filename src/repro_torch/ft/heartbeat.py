"""Master-side worker health tracking (the paper's §5.3 ping mechanism).

The master pings workers; a worker silent past the deadline is marked FAILED
and its partitions / shards are reassigned, to be reloaded from the most
recent checkpoint.  Here the transport is injected (in-process for tests; a
real deployment plugs RPC in) — the state machine and reassignment logic is
what the framework owns.

A copy of ``repro.ft.heartbeat`` (stdlib only).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

from repro_torch.obs import clock as obs_clock


class WorkerState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    FAILED = "failed"


@dataclasses.dataclass
class WorkerInfo:
    worker_id: int
    last_seen: float
    state: WorkerState = WorkerState.HEALTHY
    assignments: list = dataclasses.field(default_factory=list)


class HeartbeatMonitor:
    def __init__(self, n_workers: int, suspect_after: float = 5.0,
                 fail_after: float = 15.0, clock: Callable | None = None):
        # default: the installable obs clock (an explicit clock= still wins)
        self.clock = clock if clock is not None else obs_clock.monotonic
        now = self.clock()
        self.workers = {i: WorkerInfo(i, now) for i in range(n_workers)}
        self.suspect_after = suspect_after
        self.fail_after = fail_after
        self.epoch = 0          # bumped on every reassignment

    def beat(self, worker_id: int) -> None:
        w = self.workers[worker_id]
        w.last_seen = self.clock()
        if w.state is WorkerState.SUSPECT:
            w.state = WorkerState.HEALTHY

    def assign(self, worker_id: int, item) -> None:
        self.workers[worker_id].assignments.append(item)

    def sweep(self) -> list[int]:
        """Advance states; returns newly-failed worker ids."""
        now = self.clock()
        failed = []
        for w in self.workers.values():
            if w.state is WorkerState.FAILED:
                continue
            dt = now - w.last_seen
            if dt > self.fail_after:
                w.state = WorkerState.FAILED
                failed.append(w.worker_id)
            elif dt > self.suspect_after:
                w.state = WorkerState.SUSPECT
        return failed

    def reassign_failed(self) -> dict[int, list]:
        """Move failed workers' assignments to the least-loaded healthy ones
        (the paper: 'the master reassigns its graph partitions to another
        currently available worker').  Returns {worker: regained items}."""
        healthy = [w for w in self.workers.values()
                   if w.state is not WorkerState.FAILED]
        if not healthy:
            raise RuntimeError("no healthy workers left")
        moved: dict[int, list] = {}
        for w in self.workers.values():
            if w.state is WorkerState.FAILED and w.assignments:
                for item in w.assignments:
                    tgt = min(healthy, key=lambda h: len(h.assignments))
                    tgt.assignments.append(item)
                    moved.setdefault(tgt.worker_id, []).append(item)
                w.assignments = []
        if moved:
            # one epoch per reassignment *event*: every worker adopting the
            # new assignment table in the same sweep must agree on a single
            # epoch id, however many workers failed at once
            self.epoch += 1
        return moved
