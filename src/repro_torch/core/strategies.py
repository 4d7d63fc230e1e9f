"""Load-balancing strategies of the port (paper §II–III), stepped drivers.

Strategy        unit of work                     kernel
--------        ------------                     ------
BS  (baseline)  node; one lane per frontier      B2 per edge column
                slot, looping over its edges
EP  (edge)      edge; one lane per COO edge      B2 per iteration
                worklist entry (2E–3E memory)
WD  (workload   edge; merge-path search over     B1
     decomp.)   the frontier's degree prefix
NS  (node       node, after splitting deg>MDT    B2 per edge column of
     split)     nodes into ⌈deg/MDT⌉ children    the split graph
HP  (hier.)     ≤MDT edges/node/sub-iteration;   B2 per [cap, MDT] tile,
                WD for the small remainder       B1 for the tail
AD  (adaptive)  per-iteration choice of BS/WD/HP from frontier statistics
                (arXiv:1911.09135)

Strategies live in the :data:`STRATEGIES` registry (:func:`register`,
:func:`make_strategy`).

Every relax goes through :mod:`repro_torch.kernels.relax`, which runs the
CUDA kernels for CUDA tensors and their plain PyTorch versions for CPU
tensors.  The chunk schedule is the reference's (one B2 launch per BS or
NS column, per HP tile, per EP worklist; one B1 launch per WD iteration
and per HP tail), and each launch reads one snapshot of ``dist`` and
folds its candidates into a copy of it (``apply_relax``,
``wd_apply_relax``), so ``(dist, iterations, edges_relaxed)`` equal the
reference's stepped engine bit for bit.  The running ``updated`` mask of
an iteration is set in place by each launch.  The strategies sync to
the host between launches (frontier counts, column counts, worklist sizes);
that is what stepped mode is.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import operators
from repro_torch.core import node_split
from repro_torch.core.graph import COOGraph, CSRGraph, coo_bytes
from repro_torch.core.operators import EdgeOp
from repro_torch.core.schedule import (
    Schedule, default_schedule, resolve_overrides)
from repro_torch.core.worklist import bucket, compact_mask, run_fill
from repro_torch.kernels import relax


def _edge_weight(g, eidx: torch.Tensor) -> torch.Tensor:
    if g.wt is not None:
        return g.wt[eidx]
    return torch.ones_like(eidx)


def _new_mask(dist):
    return torch.zeros(dist.numel(), dtype=torch.bool, device=dist.device)


# ---------------------------------------------------------------------------
# BS — node-based baseline
# ---------------------------------------------------------------------------

def bs_relax(g: CSRGraph, dist, frontier, *,
             op: EdgeOp = operators.shortest_path):
    """Each frontier slot walks its own adjacency list, one edge column
    per B2 launch, for max-degree-in-frontier columns.  Each column is
    folded into ``dist`` before the next one reads it, as in the
    reference's ``while_loop``."""
    mask = frontier >= 0
    f = torch.where(mask, frontier, 0)
    deg = torch.where(mask, g.row_ptr[f + 1] - g.row_ptr[f], 0)
    base = g.row_ptr[f]
    updated = _new_mask(dist)
    for d in range(int(deg.max())):
        valid = mask & (deg > d)
        eidx = (base + d).clamp_(0, g.num_edges - 1)
        dist, updated, _ = relax.apply_relax(
            dist, updated, f, g.col[eidx], _edge_weight(g, eidx), valid,
            op=op)
    return dist, updated


# ---------------------------------------------------------------------------
# EP — edge-based parallelism over a COO edge worklist
# ---------------------------------------------------------------------------

def ep_relax(coo: COOGraph, dist, edge_wl, *,
             op: EdgeOp = operators.shortest_path):
    """One lane per worklist edge, one B2 launch (paper §II-B).  Returns
    ``(dist, updated, improve, dst)``: the lanes' destinations and which
    of them improved feed the unchunked push."""
    mask = edge_wl >= 0
    e = torch.where(mask, edge_wl, 0)
    dst = coo.dst[e]
    dist, updated, improve = relax.apply_relax(
        dist, _new_mask(dist), coo.src[e], dst, _edge_weight(coo, e), mask,
        op=op)
    return dist, updated, improve, dst


def ep_push_chunked(row_ptr, updated_mask, total: int, *, cap_out: int):
    """Work-chunked push (§IV-D): ONE output range per updated node, in
    ascending node order, holding its adjacency run."""
    nodes = torch.nonzero(updated_mask).flatten()
    wl, _ = run_fill(row_ptr[nodes], row_ptr[nodes + 1] - row_ptr[nodes],
                     total, cap_out)
    return wl


def ep_push_unchunked(row_ptr, improve, dst, total: int, *, cap_out: int):
    """Per-edge push (the default the paper compares against in Fig. 11):
    every improving *edge* pushes its destination's whole adjacency run,
    so a node improved by k edges is pushed k times."""
    deg = torch.where(improve, row_ptr[dst + 1] - row_ptr[dst], 0)
    wl, _ = run_fill(row_ptr[dst], deg, total, cap_out)
    return wl


# ---------------------------------------------------------------------------
# WD — workload decomposition (merge path over the frontier's edges)
# ---------------------------------------------------------------------------

def wd_relax(g: CSRGraph, dist, frontier, cursor, *, cap_work: int,
             op: EdgeOp = operators.shortest_path, updated=None):
    """Block-distribute the frontier's remaining edges (past ``cursor``)
    over ``cap_work`` lanes: one B1 launch ranks every lane in the degree
    prefix and relaxes its edge.  Returns ``(dist, updated)``; a given
    ``updated`` mask (HP's running one) is set in place, else a new one
    is made."""
    mask = frontier >= 0
    f = torch.where(mask, frontier, 0)
    deg = torch.where(mask, g.row_ptr[f + 1] - g.row_ptr[f] - cursor, 0)
    deg = deg.clamp_(min=0)
    prefix = torch.cumsum(deg, 0, dtype=torch.int32)
    exclusive = prefix - deg
    start = g.row_ptr[f] + cursor
    dist, updated, _ = relax.wd_apply_relax(
        dist, _new_mask(dist) if updated is None else updated, prefix,
        exclusive, start, f, g.col, g.wt, cap_work=cap_work, op=op)
    return dist, updated


# ---------------------------------------------------------------------------
# NS — node splitting (the split graph is built in node_split.py)
# ---------------------------------------------------------------------------

def ns_activate(dist2, mask2, child_parent):
    """Mirror every parent's value onto its children and activate the
    children of an active parent (paper §III-B).  Children receive no
    in-edges (destinations are always parent ids), so a child's value is
    only ever its parent's: a gather, right for every operator."""
    return dist2[child_parent], mask2 | mask2[child_parent]


# ---------------------------------------------------------------------------
# HP — hierarchical processing (≤ MDT edges per node per sub-iteration)
# ---------------------------------------------------------------------------

def hp_sub_relax(g: CSRGraph, dist, sub, cursor, *, mdt: int, updated,
                 op: EdgeOp = operators.shortest_path):
    """One sub-iteration: every sublist node relaxes its next ≤MDT edges,
    a dense ``[cap, MDT]`` tile in one B2 launch, setting ``updated`` (the
    iteration's running mask) in place.  Returns ``(dist, updated,
    new_cursor, alive)``."""
    mask = sub >= 0
    n = torch.where(mask, sub, 0)
    deg = g.row_ptr[n + 1] - g.row_ptr[n]
    j = torch.arange(mdt, dtype=torch.int32, device=dist.device)[None, :]
    pos = cursor[:, None] + j
    valid = mask[:, None] & (pos < deg[:, None])
    eidx = (g.row_ptr[n][:, None] + pos).clamp_(0, g.num_edges - 1)
    eidx = eidx.reshape(-1)
    src = n[:, None].expand(-1, mdt).reshape(-1)
    dist, updated, _ = relax.apply_relax(
        dist, updated, src, g.col[eidx], _edge_weight(g, eidx),
        valid.reshape(-1), op=op)
    new_cursor = cursor + mdt
    alive = mask & (new_cursor < deg)
    return dist, updated, new_cursor, alive


def compact_pair(nodes, cursor, alive, *, cap_out: int):
    """Compact the (node, cursor) pairs that survive a sub-iteration."""
    idx = compact_mask(alive, cap_out)
    ok = idx >= 0
    idx_c = torch.where(ok, idx, 0)
    return (torch.where(ok, nodes[idx_c], -1),
            torch.where(ok, cursor[idx_c], 0))


# ---------------------------------------------------------------------------
# Strategy drivers (host-stepped)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IterStats:
    frontier_size: int
    edges_processed: int
    sub_iterations: int = 1
    frontier_degrees: Optional[np.ndarray] = None  # for balance analysis
    kernel: Optional[str] = None     # relax kernel used (AD records choices)
    #: bucket settled by a delta-stepping epoch (None for BSP iterations);
    #: strictly increasing over a run for the monotone operators
    bucket: Optional[int] = None


#: capability: the strategy can start from an arbitrary dense
#: (dist, frontier-mask) pair (multi-source seeding, CC)
FRONTIER_INIT = "frontier_init"
#: capability: the strategy has a sharded lowering
#: (:mod:`repro_torch.core.shard`), so ``shards=`` may partition its graph
SHARDABLE = "shardable"
#: capability: the strategy's kernels have delta-stepping phases
#: (:mod:`repro_torch.core.priority`), so ``schedule="delta"`` may order
#: its relaxations by value bucket.  BS, WD, NS, HP and AD declare it; EP
#: does not (an edge worklist has no per-node value to bucket by)
PRIORITY_SCHEDULE = "priority_schedule"

#: what a plain StrategyBase subclass declares
DEFAULT_CAPABILITIES = frozenset({FRONTIER_INIT})
#: what AD declares (its choice reads global frontier statistics, so it
#: has no sharded lowering)
NODE_CAPABILITIES = frozenset({FRONTIER_INIT, PRIORITY_SCHEDULE})
#: what BS, WD, NS and HP declare, as the reference's
#: ``SHARDED_CAPABILITIES`` less its Pallas backend
SHARDED_CAPABILITIES = NODE_CAPABILITIES | {SHARDABLE}


class StrategyBase:
    """A strategy = host preprocessing + one frontier-relax iteration.

    ``setup`` and ``iterate`` are host-stepped; ``iterate`` receives the
    :class:`EdgeOp` and threads it to every kernel it launches.  Every
    strategy carries a work-assignment :class:`Schedule`; ``setup``
    resolves auto fields (MDT) into ``resolved_schedule``."""

    name = "base"
    capabilities: frozenset = DEFAULT_CAPABILITIES

    def __init__(self, schedule: Optional[Schedule] = None):
        self.schedule = (schedule if schedule is not None
                         else default_schedule(self.name))
        self.resolved_schedule = self.schedule

    def setup(self, graph: CSRGraph) -> Any:
        return graph

    def state_bytes(self, state) -> int:
        return state.device_bytes()

    def iterate(self, state, dist, updated_mask, count, *,
                op: EdgeOp = operators.shortest_path, record_degrees=False):
        raise NotImplementedError


#: name -> strategy class, populated by :func:`register`
STRATEGIES: dict[str, type] = {}


def register(cls=None, *, name: Optional[str] = None,
             capabilities: Optional[frozenset] = None):
    """Class decorator adding a :class:`StrategyBase` subclass to the
    registry under ``name`` (default: the class's ``name``)."""
    def _register(c):
        if not (isinstance(c, type) and issubclass(c, StrategyBase)):
            raise TypeError(f"{c!r} is not a StrategyBase subclass")
        key = name or c.name
        if key in STRATEGIES:
            raise ValueError(f"strategy {key!r} already registered "
                             f"({STRATEGIES[key]!r})")
        caps = capabilities
        if caps is None:
            caps = getattr(c, "capabilities", DEFAULT_CAPABILITIES)
        c.capabilities = frozenset(caps)
        STRATEGIES[key] = c
        return c
    return _register(cls) if cls is not None else _register


def _lookup(name: str) -> type:
    if name in STRATEGIES:
        return STRATEGIES[name]
    raise KeyError(f"unknown strategy {name!r}; registered: "
                   f"{sorted(STRATEGIES)}")


def make_strategy(name: str, **kwargs) -> StrategyBase:
    """Instantiate a registered strategy by name."""
    return _lookup(name)(**kwargs)


def strategy_capabilities(name: str) -> frozenset:
    """Declared capability flags of a registered strategy."""
    return _lookup(name).capabilities


def _frontier_stats(g: CSRGraph, frontier, count: int,
                    record_degrees: bool) -> IterStats:
    """Stats of one frontier (syncs its degree sum).  ``frontier`` comes
    from :func:`compact_mask`, so its first ``count`` slots are the live
    ones."""
    f = frontier[:count]
    degrees = g.row_ptr[f + 1] - g.row_ptr[f]
    stats = IterStats(frontier_size=int(count),
                      edges_processed=int(degrees.sum()))
    if record_degrees:
        stats.frontier_degrees = degrees.cpu().numpy()
    return stats


@register
class NodeBased(StrategyBase):
    name = "BS"
    capabilities = SHARDED_CAPABILITIES

    def iterate(self, g, dist, updated_mask, count, *,
                op: EdgeOp = operators.shortest_path, record_degrees=False):
        cap = bucket(count, self.schedule.min_bucket)
        frontier = compact_mask(updated_mask, cap)
        stats = _frontier_stats(g, frontier, count, record_degrees)
        dist, new_mask = bs_relax(g, dist, frontier, op=op)
        return dist, new_mask, stats


@register
class EdgeBased(StrategyBase):
    """EP.  State = the COO graph (+ its 2E/3E memory bill); the engine
    drives it by an edge worklist (:meth:`initial_worklist`,
    :meth:`relax_and_push`), not by :meth:`iterate`.

    No :data:`FRONTIER_INIT`: the worklist is seeded from one source's
    adjacency run, so an algorithm needing an arbitrary initial frontier
    (CC's every-node-active seeding) must pick a node strategy."""
    name = "EP"
    capabilities = frozenset()

    def __init__(self, chunked: bool = True,
                 memory_budget_bytes: Optional[int] = None,
                 schedule: Optional[Schedule] = None):
        super().__init__(schedule=resolve_overrides(self.name, schedule))
        self.chunked = chunked
        self.memory_budget_bytes = memory_budget_bytes

    def setup(self, graph: CSRGraph):
        need = coo_bytes(graph)
        if (self.memory_budget_bytes is not None
                and need > self.memory_budget_bytes):
            # "EP fails to execute for large graphs due to insufficient
            # memory" (paper §IV); raised before the COO is allocated
            raise MemoryError(
                f"EP COO storage needs {need} bytes > budget "
                f"{self.memory_budget_bytes} (paper §II-B memory wall)")
        self._degrees = graph.degrees
        return graph.to_coo()

    def initial_worklist(self, coo: COOGraph, source: int):
        """The source's adjacency run as a worklist ``[bucket(deg)]``
        padded with -1, and its length."""
        start, end = coo.row_ptr[source:source + 2].tolist()
        deg = end - start
        wl = torch.full((bucket(deg, self.schedule.min_bucket),), -1,
                        dtype=torch.int32, device=coo.device)
        wl[:deg] = torch.arange(start, end, dtype=torch.int32,
                                device=coo.device)
        return wl, deg

    def relax_and_push(self, coo, dist, edge_wl, count, *,
                       op: EdgeOp = operators.shortest_path):
        """Relax the worklist (one B2 launch) and push the next one.
        Returns ``(dist, updated, next worklist, its length)``."""
        min_bucket = self.schedule.min_bucket
        dist, new_mask, improve, dst = ep_relax(coo, dist, edge_wl, op=op)
        if not self.chunked:
            total = int(torch.where(improve, self._degrees[dst], 0).sum())
            if total <= 2 * coo.num_edges:
                wl = ep_push_unchunked(coo.row_ptr, improve, dst, total,
                                       cap_out=bucket(total, min_bucket))
                return dist, new_mask, wl, total
            # worklist explosion (paper §II-B): duplicates spawn duplicates
            # geometrically, so condense — every improved node once, in
            # ascending order (the reference's sort + unique), which is
            # the chunked push of the updated mask
        total = int(torch.where(new_mask, self._degrees, 0).sum())
        wl = ep_push_chunked(coo.row_ptr, new_mask, total,
                             cap_out=bucket(total, min_bucket))
        return dist, new_mask, wl, total


@register
class WorkloadDecomposition(StrategyBase):
    name = "WD"
    capabilities = SHARDED_CAPABILITIES

    def iterate(self, g, dist, updated_mask, count, *,
                op: EdgeOp = operators.shortest_path, record_degrees=False):
        sched = self.schedule
        cap = bucket(count, sched.min_bucket)
        frontier = compact_mask(updated_mask, cap)
        stats = _frontier_stats(g, frontier, count, record_degrees)
        cursor = torch.zeros(cap, dtype=torch.int32, device=dist.device)
        dist, new_mask = wd_relax(
            g, dist, frontier, cursor,
            cap_work=bucket(stats.edges_processed, sched.min_bucket), op=op)
        return dist, new_mask, stats


@register
class NodeSplitting(StrategyBase):
    """NS: BS over the split graph (max degree ≤ MDT), after mirroring
    every parent's value and activity onto its children."""
    name = "NS"
    capabilities = SHARDED_CAPABILITIES

    def __init__(self, histogram_bins: Optional[int] = None,
                 mdt: Optional[int] = None,
                 schedule: Optional[Schedule] = None):
        super().__init__(schedule=resolve_overrides(
            self.name, schedule, histogram_bins=histogram_bins, mdt=mdt))
        self.histogram_bins = self.schedule.histogram_bins
        self.mdt = self.schedule.mdt
        self.split_info: Optional[node_split.SplitGraph] = None

    def setup(self, graph: CSRGraph):
        self.resolved_schedule = self.schedule.resolved(
            graph.degrees.cpu().numpy())
        self.split_info = node_split.split_graph(
            graph, self.resolved_schedule.mdt)
        return self.split_info

    def iterate(self, sg, dist, updated_mask, count, *,
                op: EdgeOp = operators.shortest_path, record_degrees=False):
        g2 = sg.graph
        dist, mask2 = ns_activate(dist, updated_mask, sg.child_parent)
        count2 = int(mask2.sum())
        frontier = compact_mask(mask2, bucket(count2,
                                              self.schedule.min_bucket))
        stats = _frontier_stats(g2, frontier, count2, record_degrees)
        dist, new_mask = bs_relax(g2, dist, frontier, op=op)
        return dist, new_mask, stats

    def state_bytes(self, sg):
        return sg.graph.device_bytes() + sg.child_parent.numel() * 4


@register
class HierarchicalProcessing(StrategyBase):
    name = "HP"
    capabilities = SHARDED_CAPABILITIES

    def __init__(self, histogram_bins: Optional[int] = None,
                 mdt: Optional[int] = None,
                 switch_threshold: Optional[int] = None,
                 schedule: Optional[Schedule] = None):
        super().__init__(schedule=resolve_overrides(
            self.name, schedule, histogram_bins=histogram_bins, mdt=mdt,
            switch_threshold=switch_threshold))
        self.histogram_bins = self.schedule.histogram_bins
        self.mdt = self.schedule.mdt
        self.switch_threshold = self.schedule.switch_threshold

    def setup(self, graph: CSRGraph):
        self.resolved_schedule = self.schedule.resolved(
            graph.degrees.cpu().numpy())
        self.mdt_value = self.resolved_schedule.mdt
        self._wd = WorkloadDecomposition(schedule=self.schedule)
        self._wd.setup(graph)
        return graph

    def iterate(self, g, dist, updated_mask, count, *,
                op: EdgeOp = operators.shortest_path, record_degrees=False):
        sched = self.schedule
        cap = bucket(count, sched.min_bucket)
        frontier = compact_mask(updated_mask, cap)
        stats = _frontier_stats(g, frontier, count, record_degrees)
        acc_mask = _new_mask(dist)

        # hybrid: a small super list goes straight to WD (paper §III-C)
        if count <= sched.switch_threshold:
            dist, new_mask, sub_stats = self._wd.iterate(
                g, dist, updated_mask, count, op=op)
            stats.edges_processed = sub_stats.edges_processed
            return dist, new_mask, stats

        sub = frontier
        cursor = torch.zeros(cap, dtype=torch.int32, device=dist.device)
        live = count
        subiters = 0
        while live > sched.switch_threshold:
            dist, _, cursor, alive = hp_sub_relax(
                g, dist, sub, cursor, mdt=self.mdt_value, updated=acc_mask,
                op=op)
            live = int(alive.sum())
            subiters += 1
            if live:
                sub, cursor = compact_pair(
                    sub, cursor, alive,
                    cap_out=bucket(live, sched.min_bucket))
        if live > 0:
            # finish the small sublist with cursor-aware WD (B1)
            mask = sub >= 0
            n = torch.where(mask, sub, 0)
            rem = torch.where(mask, g.row_ptr[n + 1] - g.row_ptr[n] - cursor,
                              0)
            total = int(rem.clamp_(min=0).sum())
            if total > 0:
                dist, _ = wd_relax(g, dist, sub, cursor,
                                   cap_work=bucket(total, sched.min_bucket),
                                   op=op, updated=acc_mask)
            subiters += 1
        stats.sub_iterations = subiters
        return dist, acc_mask, stats


# ---------------------------------------------------------------------------
# AD — adaptive strategy selection (Jatala et al., arXiv:1911.09135)
# ---------------------------------------------------------------------------

def choose_kernel(count: int, degree_sum: int, max_degree: int,
                  imbalance: float, *, mdt: int,
                  small_frontier: int = 512,
                  imbalance_threshold: float = 4.0,
                  hp_edges_threshold: int = 1 << 15) -> str:
    """Pick the relax kernel for one iteration from frontier statistics
    (the reference's decision tree, unchanged):

    * empty or edgeless frontier → BS;
    * small and near-uniform frontier → BS;
    * large skewed frontier past ``hp_edges_threshold`` with nodes above
      MDT → HP;
    * everything else → WD.
    """
    if degree_sum == 0 or count == 0:
        return "BS"
    if not math.isfinite(imbalance):
        imbalance = math.inf
    if count <= small_frontier and imbalance <= imbalance_threshold:
        return "BS"
    if max_degree > mdt and degree_sum >= hp_edges_threshold:
        return "HP"
    return "WD"


@register
class AdaptiveStrategy(StrategyBase):
    """AD: per-iteration switching among BS, WD and HP on frontier
    statistics.  All three share the ``dist`` layout, so switching mid-run
    costs nothing.  ``kernel_counts`` records the choices.

    With ``cost_model`` (a :class:`repro_torch.core.costmodel.CostModel`)
    each iteration takes ``cost_model.choose(count, degree_sum)`` in place
    of the fixed tree; with ``online=True`` too, the stepped driver times
    the chosen iteration (a device sync on the card) and feeds it back
    through ``cost_model.observe``."""
    name = "AD"
    capabilities = NODE_CAPABILITIES

    def __init__(self, small_frontier: Optional[int] = None,
                 imbalance_threshold: Optional[float] = None,
                 hp_edges_threshold: Optional[int] = None,
                 histogram_bins: Optional[int] = None,
                 mdt: Optional[int] = None,
                 schedule: Optional[Schedule] = None,
                 cost_model=None, online: bool = False):
        super().__init__(schedule=resolve_overrides(
            self.name, schedule, small_frontier=small_frontier,
            imbalance_threshold=imbalance_threshold,
            hp_edges_threshold=hp_edges_threshold,
            histogram_bins=histogram_bins, mdt=mdt))
        sched = self.schedule
        self.small_frontier = sched.small_frontier
        # float32-canonical (Schedule.__post_init__), like the reference
        self.imbalance_threshold = sched.imbalance_threshold
        self.hp_edges_threshold = sched.hp_edges_threshold
        self.histogram_bins = sched.histogram_bins
        self.mdt = sched.mdt
        self.cost_model = cost_model
        self.online = bool(online)
        self.kernel_counts: dict[str, int] = {}

    def setup(self, graph: CSRGraph):
        self._degrees = graph.degrees
        self.resolved_schedule = self.schedule.resolved(
            self._degrees.cpu().numpy())
        self.mdt_value = self.resolved_schedule.mdt
        self._kernels = {
            "BS": NodeBased(schedule=self.schedule),
            "WD": WorkloadDecomposition(schedule=self.schedule),
            "HP": HierarchicalProcessing(mdt=self.mdt_value,
                                         schedule=self.schedule),
        }
        for k in self._kernels.values():
            k.setup(graph)
        self.kernel_counts = {}
        return graph

    def iterate(self, g, dist, updated_mask, count, *,
                op: EdgeOp = operators.shortest_path, record_degrees=False):
        fdeg = torch.where(updated_mask, self._degrees, 0)
        degree_sum, max_degree = torch.stack(
            [fdeg.sum(), fdeg.max().long()]).tolist()
        # float32 with the reference's operation order, so the choice
        # agrees with it at every threshold
        mean = np.float32(degree_sum) / np.float32(max(int(count), 1))
        imbalance = (float(np.float32(max_degree) / mean)
                     if mean > 0 else 1.0)
        if self.cost_model is not None:
            choice = self.cost_model.choose(int(count), degree_sum)
        else:
            choice = choose_kernel(
                int(count), degree_sum, max_degree, imbalance,
                mdt=self.mdt_value, small_frontier=self.small_frontier,
                imbalance_threshold=self.imbalance_threshold,
                hp_edges_threshold=self.hp_edges_threshold)
        self.kernel_counts[choice] = self.kernel_counts.get(choice, 0) + 1
        timed = self.online and self.cost_model is not None
        t0 = time.perf_counter() if timed else None
        dist, new_mask, stats = self._kernels[choice].iterate(
            g, dist, updated_mask, count, op=op,
            record_degrees=record_degrees)
        if timed:
            if dist.is_cuda:
                torch.cuda.synchronize(dist.device)
            self.cost_model.observe(choice, degree_sum, int(count),
                                    time.perf_counter() - t0)
        stats.kernel = choice
        return dist, new_mask, stats
