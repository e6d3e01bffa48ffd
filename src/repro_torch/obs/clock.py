"""The one injectable clock.

``ft/heartbeat.py``, ``ft/straggler.py``, ``checkpoint/ckpt.py`` and
``serve/engine.py`` all need wall time — heartbeat deadlines, straggler
deadlines, checkpoint snapshot billing, request inter-arrival gaps.  Each
used to grab ``time.monotonic`` / ``time.perf_counter`` directly, so a
deterministic test had to monkeypatch (or thread a ``clock=`` kwarg into)
every module separately.  They now all read *this* module's
:func:`monotonic` / :func:`perf_counter`, which dispatch through one
installable backend:

    with obs.clock.fake() as fc:
        mon = HeartbeatMonitor(4)      # reads the fake transparently
        fc.advance(30.0)
        assert mon.sweep() == [0, 1, 2, 3]

The per-call indirection is one global read + one call — nothing on any
hot loop.  Explicit ``clock=`` parameters on the consuming classes remain
(and win over the installed backend) for callers that want two clocks in
one process.

A copy of ``repro.obs.clock`` (stdlib only).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator

__all__ = ["monotonic", "perf_counter", "install", "reset", "FakeClock",
           "fake"]

_monotonic: Callable[[], float] = time.monotonic
_perf_counter: Callable[[], float] = time.perf_counter


def monotonic() -> float:
    """The installed monotonic clock (wall ``time.monotonic`` by default)."""
    return _monotonic()


def perf_counter() -> float:
    """The installed high-resolution timer (``time.perf_counter`` by
    default).  Span durations and save-time billing read this one."""
    return _perf_counter()


def install(monotonic_fn: Callable[[], float] | None = None,
            perf_fn: Callable[[], float] | None = None,
            ) -> tuple[Callable[[], float], Callable[[], float]]:
    """Swap the backend(s); returns the previous ``(monotonic, perf)`` pair
    so callers can restore them (prefer the :func:`fake` context manager)."""
    global _monotonic, _perf_counter
    prev = (_monotonic, _perf_counter)
    if monotonic_fn is not None:
        _monotonic = monotonic_fn
    if perf_fn is not None:
        _perf_counter = perf_fn
    return prev


def reset() -> None:
    """Back to the real ``time`` clocks."""
    global _monotonic, _perf_counter
    _monotonic = time.monotonic
    _perf_counter = time.perf_counter


class FakeClock:
    """A deterministic test clock: calling it reads the current fake time,
    :meth:`advance` moves it.  One instance can back both the monotonic
    and the perf clock."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


@contextlib.contextmanager
def fake(start: float = 0.0) -> Iterator[FakeClock]:
    """Install one :class:`FakeClock` as both clocks for the duration of
    the block; always restores the previous backends."""
    fc = FakeClock(start)
    prev = install(fc, fc)
    try:
        yield fc
    finally:
        install(*prev)
