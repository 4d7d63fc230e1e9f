"""Breadth-first search as level propagation (paper §IV): the
``shortest_path`` operator on the unweighted graph (every edge counts 1)."""

from __future__ import annotations

from repro_torch.core.engine import RunResult, make_strategy, run, run_batch
from repro_torch.core.graph import CSRGraph
from repro_torch.core.multi_source import BatchRunResult


def bfs(graph: CSRGraph, source: int = 0, strategy: str = "WD",
        record_degrees: bool = False, mode: str = "stepped",
        shards=None, partition: str = "degree", schedule: str = "bsp",
        delta=None, async_shards: bool = False, device="cuda",
        **strategy_kwargs) -> RunResult:
    """BFS levels from ``source`` under ``strategy`` (BS, EP, WD, NS, HP
    or AD; EP takes ``chunked=``), on the card unless ``device="cpu"``.
    ``schedule="delta"`` settles level buckets in order (every unit
    weight is light, so a bucket is Δ levels wide).  ``shards``,
    ``partition`` and ``async_shards`` as in ``sssp``."""
    strat = make_strategy(strategy, **strategy_kwargs)
    return run(graph.unweighted(), source, strat,
               record_degrees=record_degrees, mode=mode, shards=shards,
               partition=partition, schedule=schedule, delta=delta,
               async_shards=async_shards, device=device)


def bfs_batch(graph: CSRGraph, sources, mode: str = "stepped",
              schedule: str = "bsp", delta=None, device="cuda",
              **batch_kwargs) -> BatchRunResult:
    """BFS levels from K sources at once (dist is ``[K, N]``) on the
    unweighted view, on the card unless ``device="cpu"``; ``batch_kwargs``
    go to ``run_batch``."""
    return run_batch(graph.unweighted(), sources, mode=mode,
                     schedule=schedule, delta=delta, device=device,
                     **batch_kwargs)
