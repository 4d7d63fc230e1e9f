"""Serving metrics of the port (the counterpart of
:mod:`repro.serve.metrics`): counters + gauges + a latency reservoir.

One :class:`Metrics` instance instruments the whole serving path
(admission, batching, caches) and exports everything as a plain dict
(:meth:`Metrics.snapshot`) so tests, benchmarks and operators consume
the *same* numbers — there is no second bookkeeping path to drift.
The definitions are the reference's (docs/serving.md); the port's tests
hold its snapshot equal to the reference's on the same request streams.

Percentiles use the nearest-rank method (the p-th percentile is an
*observed* latency, never an interpolation) — with a simulated clock the
p50/p99 of a hand-built trace are then exact.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional


def percentile(values, p: float) -> Optional[float]:
    """Nearest-rank percentile (``p`` in [0, 100]); None when empty."""
    if not values:
        return None
    if not 0 <= p <= 100:
        raise ValueError(f"percentile must be in [0, 100], got {p}")
    ordered = sorted(values)
    if p == 0:
        return ordered[0]
    rank = max(1, -(-len(ordered) * p // 100))      # ceil(n * p / 100)
    return ordered[int(rank) - 1]


class Metrics:
    """Counters (monotone), gauges (last value), latency observations."""

    def __init__(self):
        self.counters: Counter = Counter()
        self.gauges: dict = {}
        self.latencies: list = []

    def inc(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def gauge(self, name: str, value) -> None:
        self.gauges[name] = value

    def observe_latency(self, seconds: float) -> None:
        self.latencies.append(float(seconds))

    # -- derived ----------------------------------------------------------

    def _ratio(self, num: str, *denoms: str) -> Optional[float]:
        total = sum(self.counters[d] for d in denoms)
        if total == 0:
            return None
        return self.counters[num] / total

    def snapshot(self) -> dict:
        """Everything, as one flat dict (the reference's keys).

        Counters and gauges appear under their own names; derived values:

        * ``batch_occupancy`` — ``lanes_busy / lanes_dispatched`` over all
          batches so far (1.0 = every padded lane carried a real request);
        * ``result_cache_hit_rate`` — distance-cache hits over lookups;
        * ``exec_cache_hit_rate`` — executable-cache hits over lookups;
        * ``latency_p50`` / ``latency_p99`` / ``latency_max`` /
          ``latency_mean`` / ``latency_count`` — over completed-request
          latencies (None while nothing has completed).
        """
        snap = dict(self.counters)
        snap.update(self.gauges)
        snap["batch_occupancy"] = self._ratio("lanes_busy",
                                              "lanes_dispatched")
        snap["result_cache_hit_rate"] = self._ratio(
            "result_cache_hits", "result_cache_hits", "result_cache_misses")
        snap["exec_cache_hit_rate"] = self._ratio(
            "exec_cache_hits", "exec_cache_hits", "exec_cache_misses")
        lat = self.latencies
        snap["latency_count"] = len(lat)
        snap["latency_p50"] = percentile(lat, 50)
        snap["latency_p99"] = percentile(lat, 99)
        snap["latency_max"] = max(lat) if lat else None
        snap["latency_mean"] = (sum(lat) / len(lat)) if lat else None
        return snap
