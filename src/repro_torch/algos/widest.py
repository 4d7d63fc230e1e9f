"""Widest path (maximum bottleneck width): :data:`operators.widest_path`,
``message = min(val_src, w)``, ``combine = max``, identity 0
(unreachable), the source seeded at ``INF``.  Every strategy applies
unchanged."""

from __future__ import annotations

import heapq

import numpy as np

from repro_torch.core.engine import RunResult, make_strategy, run
from repro_torch.core.graph import CSRGraph, INF


def widest_path(graph: CSRGraph, source: int = 0, strategy: str = "WD",
                record_degrees: bool = False, mode: str = "stepped",
                shards=None, partition: str = "degree",
                schedule: str = "bsp", delta=None,
                async_shards: bool = False, device="cuda",
                **strategy_kwargs) -> RunResult:
    """Max-min bottleneck width from ``source`` to every node under
    ``strategy`` (any of the six), on the card unless ``device="cpu"``.
    ``result.dist[v]`` is the largest width over all source→v paths (0 =
    unreachable, INF = the source itself).  ``schedule="delta"`` settles
    the widest buckets first (the max monoid reflects the rank).
    ``shards``, ``partition`` and ``async_shards`` as in ``sssp``."""
    strat = make_strategy(strategy, **strategy_kwargs)
    return run(graph, source, strat, op="widest_path",
               record_degrees=record_degrees, mode=mode, shards=shards,
               partition=partition, schedule=schedule, delta=delta,
               async_shards=async_shards, device=device)


def reference_widest(graph: CSRGraph, source: int) -> np.ndarray:
    """Host-side widest-path oracle for correctness tests: Dijkstra with
    a max-heap on path width."""
    row_ptr = graph.row_ptr.cpu().numpy()
    col = graph.col.cpu().numpy()
    wt = (np.ones(graph.num_edges, np.int64) if graph.wt is None
          else graph.wt.cpu().numpy().astype(np.int64))
    width = np.zeros(graph.num_nodes, np.int64)
    width[source] = INF
    heap = [(-int(INF), source)]
    while heap:
        c, u = heapq.heappop(heap)
        c = -c
        if c < width[u]:
            continue
        for e in range(row_ptr[u], row_ptr[u + 1]):
            v = col[e]
            nc = min(c, wt[e])
            if nc > width[v]:
                width[v] = nc
                heapq.heappush(heap, (-int(nc), v))
    return width.astype(np.int32)
