"""Breadth-first search as level propagation (paper §IV): the
``shortest_path`` operator on the unweighted graph (every edge counts 1)."""

from __future__ import annotations

from repro_torch.core.engine import RunResult, make_strategy, run
from repro_torch.core.graph import CSRGraph


def bfs(graph: CSRGraph, source: int = 0, strategy: str = "WD",
        record_degrees: bool = False, mode: str = "stepped",
        device="cuda", **strategy_kwargs) -> RunResult:
    """BFS levels from ``source`` under ``strategy`` (BS, EP, WD, NS, HP
    or AD; EP takes ``chunked=``), on the card unless ``device="cpu"``."""
    strat = make_strategy(strategy, **strategy_kwargs)
    return run(graph.unweighted(), source, strat,
               record_degrees=record_degrees, mode=mode, device=device)
