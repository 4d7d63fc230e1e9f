"""Connected components as min-label propagation: every node starts
active with its own id as label, and :data:`operators.min_label`
(message = the source's label, combine = min) runs to its fixed point.
Each node ends with the minimum id among the nodes that reach it: on a
symmetric (undirected) graph, its component's minimum id.

Any strategy declaring :data:`repro_torch.core.strategies.FRONTIER_INIT`
works (BS, WD, NS, HP, AD); EP does not declare it and
``engine.fixed_point`` rejects it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import operators
from repro_torch.core.engine import fixed_point, make_strategy


def _every_node_its_own_label(n_alloc: int):
    # NS children (ids ≥ num_nodes) get their own id too; the first
    # ns_activate mirror replaces it with the parent's label before any
    # child relaxes
    return (torch.arange(n_alloc, dtype=operators.min_label.dtype),
            torch.ones(n_alloc, dtype=torch.bool))


def connected_components(graph, strategy: str = "WD",
                         max_iterations: int = 10000,
                         mode: str = "stepped", shards=None,
                         partition: str = "degree", schedule: str = "bsp",
                         delta=None, async_shards: bool = False,
                         device="cuda", **strategy_kwargs) -> np.ndarray:
    """The min-node-id label of each node's (in-)component, on the card
    unless ``device="cpu"``.  ``schedule="delta"`` buckets by tentative
    label (min_label is not weight-additive: every edge is light);
    ``shards``, ``partition`` and ``async_shards`` as in ``sssp``."""
    labels, _, _ = fixed_point(
        graph, make_strategy(strategy, **strategy_kwargs),
        _every_node_its_own_label, op=operators.min_label, mode=mode,
        max_iterations=max_iterations, shards=shards, partition=partition,
        schedule=schedule, delta=delta, async_shards=async_shards,
        device=device)
    return labels
