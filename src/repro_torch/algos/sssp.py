"""Single-source shortest paths (Bellman-Ford relaxation to a fixed point,
paper Fig. 2): the ``shortest_path`` operator on a weighted graph."""

from __future__ import annotations

from repro_torch.core.engine import RunResult, make_strategy, run, run_batch
from repro_torch.core.graph import CSRGraph
from repro_torch.core.multi_source import BatchRunResult


def sssp(graph: CSRGraph, source: int = 0, strategy: str = "WD",
         record_degrees: bool = False, mode: str = "stepped",
         shards=None, partition: str = "degree", schedule: str = "bsp",
         delta=None, async_shards: bool = False, device="cuda",
         **strategy_kwargs) -> RunResult:
    """Shortest-path distances from ``source`` under ``strategy`` (BS, EP,
    WD, NS, HP or AD; EP takes ``chunked=``), on the card unless
    ``device="cpu"``.  ``schedule="delta"`` settles distance buckets in
    priority order (delta-stepping; ``delta=`` overrides the auto
    width).  ``shards=S`` (fused; BS, WD, NS, HP) partitions the graph
    into S shards (``partition``), ``async_shards=True`` lets them run
    ahead between folds (``engine.run``)."""
    if graph.wt is None:
        raise ValueError("SSSP needs a weighted graph")
    strat = make_strategy(strategy, **strategy_kwargs)
    return run(graph, source, strat, record_degrees=record_degrees,
               mode=mode, shards=shards, partition=partition,
               schedule=schedule, delta=delta, async_shards=async_shards,
               device=device)


def sssp_batch(graph: CSRGraph, sources, mode: str = "stepped",
               schedule: str = "bsp", delta=None, device="cuda",
               **batch_kwargs) -> BatchRunResult:
    """Shortest paths from K sources at once (dist is ``[K, N]``), on the
    card unless ``device="cpu"``; ``schedule="delta"`` (fused) runs each
    row as a delta-stepping traversal; ``batch_kwargs`` go to
    ``run_batch``."""
    if graph.wt is None:
        raise ValueError("SSSP needs a weighted graph")
    return run_batch(graph, sources, mode=mode, schedule=schedule,
                     delta=delta, device=device, **batch_kwargs)
