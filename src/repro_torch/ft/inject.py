"""Deterministic fault injection for the fault-tolerant driver.

A :class:`FaultPlan` scripts, per driver *tick* (one tick = one global
iteration of the outer loop, monotonically increasing across recoveries —
NOT the engine's iteration counter, which rewinds on restore), which
simulated worker is killed or delayed.  The driver advances an injected
logical clock one ``tick_seconds`` per tick and forwards each live worker's
heartbeat through :meth:`FaultInjector.beating`; a killed worker goes
silent forever, a delayed worker goes silent for ``n`` ticks and then
resumes (exercising the monitor's healthy -> suspect -> healthy path
without a failover).

Nothing here touches wall-clock time or randomness — the same plan against
the same graph/program replays the same recovery sequence bit-for-bit,
which is what lets the kill-and-resume tests assert exact state equality
instead of sleeping.

A copy of ``repro.ft.inject`` (stdlib only).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

__all__ = ["FaultPlan", "FaultInjector"]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """``kill[t] = worker`` kills that worker at tick ``t`` (permanent);
    ``delay[t] = (worker, n_ticks)`` silences it for ``n_ticks`` ticks."""

    kill: Mapping[int, int] = dataclasses.field(default_factory=dict)
    delay: Mapping[int, tuple[int, int]] = dataclasses.field(
        default_factory=dict)

    @staticmethod
    def kill_at(tick: int, worker: int = 0) -> "FaultPlan":
        return FaultPlan(kill={int(tick): int(worker)})


class FaultInjector:
    """Replays a :class:`FaultPlan` against ``n_workers`` simulated workers."""

    def __init__(self, plan: FaultPlan, n_workers: int):
        self.plan = plan
        self.n_workers = n_workers
        self.killed: set[int] = set()
        self.silent_until: dict[int, int] = {}    # worker -> first loud tick
        self.tick = -1

    def beating(self, tick: int) -> Sequence[int]:
        """Advance to ``tick`` and return the workers that heartbeat now."""
        if tick <= self.tick:
            raise ValueError(f"ticks must advance: {tick} after {self.tick}")
        self.tick = tick
        if tick in self.plan.kill:
            self.killed.add(self.plan.kill[tick])
        if tick in self.plan.delay:
            w, n = self.plan.delay[tick]
            self.silent_until[w] = tick + int(n)
        return [w for w in range(self.n_workers)
                if w not in self.killed
                and tick >= self.silent_until.get(w, 0)]
