"""Serving caches of the port (the counterpart of
:mod:`repro.serve.cache`): distance/landmark results + batch-shape reuse.

Two caches, one LRU core, following the pin-vs-recompute framing of
"A Graph-based Model for GPU Caching Problems" (arXiv:1605.02043): a
bounded budget holds the artifacts whose recompute cost × reuse
frequency is highest, everything else is recomputed on demand.

* :class:`DistanceCache` — full distance rows keyed on
  ``(graph, epoch, source, op)``.  A hit returns the *stored array* of a
  previous traversal, so hits are bit-identical to a cold traversal by
  construction.  ``epoch`` is the resident graph's swap
  counter: the key changes when the graph changes, so a stale entry can
  never hit, and :meth:`invalidate_graph` additionally drops every entry
  of a swapped graph eagerly (full invalidation — partial reuse across
  graph versions is unsound for distances).  Hot sources ("landmarks")
  can be **pinned**: pinned entries never age out of the LRU
  (:meth:`repro_torch.serve.server.GraphServer.warm` precomputes +
  pins).

* :class:`ExecutableCache` — the K-buckets the server has dispatched,
  keyed on ``(graph, epoch, op, schedule, delta, K-bucket)``, with the
  reference's hit/miss/eviction accounting and bound on how many it keeps.
  In the reference each entry stands for a jit executable; the port
  compiles nothing per shape (one kernel library, built once), so an
  entry records a dispatched batch shape.  What the reference gates as
  "no recompile" is here "one fused launch per dispatched batch", read
  from ``repro_torch.kernels._build.LAUNCHES``.

Both caches report into one :class:`repro_torch.serve.metrics.Metrics` under
``result_cache_*`` / ``exec_cache_*`` counter prefixes.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np

from repro_torch.serve.metrics import Metrics


class LRUCache:
    """Ordered-dict LRU with pinning.

    ``capacity`` bounds the number of *unpinned* entries; pinned entries
    (landmarks) are exempt — pinning is an explicit operator decision to
    spend budget on a hot key (arXiv:1605.02043's "pin" class), so it is
    accounted separately rather than silently squeezing the LRU."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._data: OrderedDict = OrderedDict()
        self._pinned: set = set()

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def keys(self):
        return list(self._data.keys())

    def get(self, key):
        """Return the value (refreshing recency) or None."""
        if key not in self._data:
            return None
        self._data.move_to_end(key)
        return self._data[key]

    def put(self, key, value) -> list:
        """Insert/overwrite; return the list of evicted (key, value)."""
        self._data[key] = value
        self._data.move_to_end(key)
        evicted = []
        while len(self._data) - len(self._pinned) > self.capacity:
            victim = next(k for k in self._data if k not in self._pinned)
            evicted.append((victim, self._data.pop(victim)))
        return evicted

    def pin(self, key) -> None:
        if key not in self._data:
            raise KeyError(f"cannot pin absent key {key!r}")
        self._pinned.add(key)

    def unpin(self, key) -> None:
        self._pinned.discard(key)

    def pop_matching(self, pred) -> list:
        """Drop every entry whose key satisfies ``pred``; return them."""
        victims = [k for k in self._data if pred(k)]
        for k in victims:
            self._pinned.discard(k)
        return [(k, self._data.pop(k)) for k in victims]


class DistanceCache:
    """Distance/landmark rows keyed ``(graph, epoch, source, op)``."""

    def __init__(self, capacity: int, metrics: Optional[Metrics] = None):
        self._lru = LRUCache(capacity)
        self.metrics = metrics if metrics is not None else Metrics()

    @staticmethod
    def key(graph: str, epoch: int, source: int, op: str) -> tuple:
        return (graph, int(epoch), int(source), op)

    def __len__(self) -> int:
        return len(self._lru)

    def lookup(self, graph: str, epoch: int, source: int,
               op: str) -> Optional[np.ndarray]:
        row = self._lru.get(self.key(graph, epoch, source, op))
        if row is None:
            self.metrics.inc("result_cache_misses")
            return None
        self.metrics.inc("result_cache_hits")
        return row

    def insert(self, graph: str, epoch: int, source: int, op: str,
               dist: np.ndarray, pin: bool = False) -> None:
        k = self.key(graph, epoch, source, op)
        # store a read-only copy: served responses must stay bit-identical
        # even if a caller mutates the row it was handed
        row = np.array(dist, copy=True)
        row.setflags(write=False)
        evicted = self._lru.put(k, row)
        self.metrics.inc("result_cache_evictions", len(evicted))
        if pin:
            self._lru.pin(k)
            self.metrics.inc("result_cache_pins")

    def invalidate_graph(self, graph: str) -> int:
        """Drop every entry of ``graph`` (any epoch); returns the count."""
        dropped = self._lru.pop_matching(lambda k: k[0] == graph)
        self.metrics.inc("result_cache_invalidations", len(dropped))
        return len(dropped)


@dataclasses.dataclass
class ExecutableEntry:
    """One dispatched (graph, knobs, K-bucket) batch shape."""

    key: tuple
    k_bucket: int
    hits: int = 0            # batches served after the admitting one
    batches: int = 0         # total batches dispatched through this entry


class ExecutableCache:
    """LRU over dispatched batch shapes (see module docstring)."""

    def __init__(self, capacity: int, metrics: Optional[Metrics] = None):
        self._lru = LRUCache(capacity)
        self.metrics = metrics if metrics is not None else Metrics()

    @staticmethod
    def key(graph: str, epoch: int, op: str, schedule: str,
            delta: Optional[int], k_bucket: int) -> tuple:
        return (graph, int(epoch), op, schedule, delta, int(k_bucket))

    def __len__(self) -> int:
        return len(self._lru)

    def admit(self, key: tuple) -> ExecutableEntry:
        """Look up (hit) or create (miss, possibly evicting) the entry."""
        entry = self._lru.get(key)
        if entry is not None:
            self.metrics.inc("exec_cache_hits")
            entry.hits += 1
        else:
            self.metrics.inc("exec_cache_misses")
            entry = ExecutableEntry(key=key, k_bucket=key[-1])
            evicted = self._lru.put(key, entry)
            self.metrics.inc("exec_cache_evictions", len(evicted))
        entry.batches += 1
        return entry

    def invalidate_graph(self, graph: str) -> int:
        dropped = self._lru.pop_matching(lambda k: k[0] == graph)
        self.metrics.inc("exec_cache_invalidations", len(dropped))
        return len(dropped)

    def resident_keys(self) -> list:
        return self._lru.keys()
