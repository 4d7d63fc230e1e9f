"""Clock abstraction for the port's serving tier (the counterpart of
:mod:`repro.serve.clock`).

Every time the server reads — admission stamps, deadline checks, latency
accounting — goes through one injected callable, so the same batcher
code runs under two regimes:

* :class:`SystemClock` — ``time.perf_counter``; what a deployment
  uses;
* :class:`SimulatedClock` — a manually-advanced virtual time.  Tests
  drive an open-loop arrival process by interleaving ``advance()`` with
  ``submit()``/``step()`` and never sleep, so deadline expiry, latency
  percentiles and queue traces are exactly reproducible.

A clock is just ``() -> float`` seconds; anything callable works.
"""

from __future__ import annotations

import time


class SimulatedClock:
    """Deterministic virtual time: only :meth:`advance` moves it."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> float:
        """Move time forward (never backward) and return the new time."""
        if seconds < 0:
            raise ValueError(f"time cannot run backward ({seconds=})")
        self._now += float(seconds)
        return self._now

    def __call__(self) -> float:
        return self._now


class SystemClock:
    """Monotonic wall clock (``time.perf_counter``)."""

    def now(self) -> float:
        return time.perf_counter()

    def __call__(self) -> float:
        return time.perf_counter()
