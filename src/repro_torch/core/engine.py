"""Data-driven execution engine of the port (paper Fig. 2 / Fig. 4 outer
loop), stepped and fused.

:func:`run` relaxes from one source to a fixed point under a registered
strategy.  ``mode="stepped"`` runs one frontier iteration per step: the
strategy launches its relax kernels, the host counts the next frontier,
and the loop goes on while it is non-empty (EP: while its edge worklist
is).  ``mode="fused"`` runs the whole traversal as one launch
(:mod:`repro_torch.core.fused`), with the same values, iteration count
and edge total.  :func:`fixed_point` does the same from a caller's
``(values, mask)`` seeding (connected components).  *What* is propagated
is an :class:`repro_torch.core.operators.EdgeOp` (``op=``, default
``shortest_path``).

:func:`run_batch` answers K sources at once
(:mod:`repro_torch.core.multi_source`).  ``schedule="delta"`` settles
value buckets in priority order (delta-stepping,
:mod:`repro_torch.core.priority`): ``iterations`` then counts bucket
epochs and ``relax_rounds`` the relax passes.  ``shards=S`` (fused)
partitions the graph into S shards and runs them in lockstep, or
asynchronously with ``async_shards=True``
(:mod:`repro_torch.core.shard`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from repro_torch.core import fused, operators, priority
from repro_torch.core import shard as _shard
from repro_torch.core.graph import CSRGraph, INF, resolve_device
from repro_torch.core.schedule import Schedule
from repro_torch.core.strategies import (  # noqa: F401  (re-exported)
    FRONTIER_INIT, PRIORITY_SCHEDULE, SHARDABLE, EdgeBased, IterStats,
    NodeSplitting, StrategyBase, make_strategy)

if TYPE_CHECKING:       # kernels.fused imports this package
    from repro_torch.kernels.fused import Rounds

#: work orderings: "bsp" relaxes the whole frontier every iteration;
#: "delta" settles value buckets in priority order
SCHEDULES = ("bsp", "delta")


@dataclasses.dataclass
class RunResult:
    dist: np.ndarray                 # [N] final distances / levels
    iterations: int
    total_seconds: float
    setup_seconds: float             # strategy overhead (prep, conversion)
    kernel_seconds: float            # useful relax time (paper's split)
    overhead_seconds: float          # scan/compaction/push bookkeeping
    edges_relaxed: int
    iter_stats: list
    strategy: str
    state_bytes: int                 # device bytes held by the strategy
    mode: str = "stepped"
    #: where the run went: "cuda" (hand-written kernels) or "cpu" (their
    #: plain PyTorch versions).  Replaces the reference's ``backend``.
    device: str = "cuda"
    shards: int = 1
    schedule: str = "bsp"
    delta: Optional[int] = None
    relax_rounds: Optional[int] = None
    #: a delta run's relax rounds split between the grid and one block
    #: (``kernels.fused.Rounds``, summed over a stepped run's epochs)
    round_split: Optional["Rounds"] = None
    async_shards: bool = False
    #: the resolved work-assignment Schedule the run executed under
    work_schedule: Optional[Schedule] = None

    def __post_init__(self):
        if self.relax_rounds is None:
            self.relax_rounds = self.iterations

    @property
    def traversal_seconds(self) -> float:
        """Time in the fixed-point loop, excluding one-off setup."""
        return max(self.total_seconds - self.setup_seconds, 0.0)

    @property
    def mteps(self) -> float:
        """Millions of traversed edges per second of traversal time."""
        if self.traversal_seconds <= 0:
            return 0.0
        return self.edges_relaxed / self.traversal_seconds / 1e6

    @property
    def mteps_with_setup(self) -> float:
        if self.total_seconds <= 0:
            return 0.0
        return self.edges_relaxed / self.total_seconds / 1e6


def ready(x: torch.Tensor) -> torch.Tensor:
    """Wait until the device has finished ``x``, then return it."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x


def _check_mode(mode: str) -> None:
    if mode not in ("stepped", "fused"):
        raise ValueError(f"mode must be 'stepped' or 'fused', got {mode!r}")


def _check_sharding(strategy: Optional[StrategyBase], mode: str,
                    shards: Optional[int]) -> None:
    """The reference's rules for ``shards=``: the fused engine only, and a
    strategy declaring :data:`SHARDABLE` (``strategy`` None: the WD
    batch)."""
    if shards is None:
        return
    if mode != "fused":
        raise ValueError(
            "sharded execution runs the whole traversal as the fused "
            "engine does; pass mode='fused'")
    if strategy is not None and SHARDABLE not in strategy.capabilities:
        raise ValueError(
            f"strategy {strategy.name!r} does not declare the "
            f"{SHARDABLE!r} capability; sharding is gated on BS/WD/HP/NS "
            f"(EP's COO worklist and AD's global frontier statistics stay "
            f"on one device)")


def _check_schedule(strategy: Optional[StrategyBase], schedule: str,
                    delta: Optional[int], op, shards: Optional[int] = None,
                    async_shards: bool = False) -> None:
    """The reference's rules for the work ordering, in its order (``op``
    resolved): a known schedule; ``delta=`` only with ``"delta"``; delta
    needs a strategy declaring :data:`PRIORITY_SCHEDULE` (``strategy``
    None: the WD batch), an idempotent operator and one shard;
    ``async_shards`` needs ``shards=`` and an idempotent operator."""
    if schedule not in SCHEDULES:
        raise ValueError(
            f"schedule must be one of {SCHEDULES}, got {schedule!r}")
    if delta is not None and schedule != "delta":
        raise ValueError(
            f"delta= sets the bucket width of schedule='delta'; it has no "
            f"meaning under schedule={schedule!r}")
    if schedule == "delta":
        if strategy is not None and (
                PRIORITY_SCHEDULE not in strategy.capabilities):
            raise ValueError(
                f"strategy {strategy.name!r} does not declare the "
                f"{PRIORITY_SCHEDULE!r} capability; delta-stepping is "
                f"gated on the node-centric strategies (EP's edge "
                f"worklist has no per-node value to bucket by)")
        if not op.idempotent:
            raise ValueError(
                f"schedule='delta' reorders relaxations; operator "
                f"{op.name!r} (combine={op.combine!r}) is not idempotent, "
                f"so its fixed point depends on relax order; use "
                f"schedule='bsp'")
        if shards is not None:
            raise ValueError(
                "schedule='delta' runs on one shard (bucket selection "
                "reads the global value array); pass shards=None and "
                "async_shards=False, or use schedule='bsp' for sharded "
                "runs")
    if async_shards:
        if shards is None:
            raise ValueError(
                "async_shards=True relaxes the fold cadence of SHARDED "
                "execution; pass shards= (and mode='fused')")
        if not op.idempotent:
            raise ValueError(
                f"async_shards=True lets shards relax against stale ghost "
                f"values, which is only safe for idempotent monotone "
                f"monoids; operator {op.name!r} has combine="
                f"{op.combine!r}")


def _n_alloc(graph: CSRGraph, strategy: StrategyBase) -> int:
    """Nodes of the value array: NS's split graph has its children too."""
    if isinstance(strategy, NodeSplitting):
        return strategy.split_info.graph.num_nodes
    return graph.num_nodes


def _original(dist: torch.Tensor, strategy: StrategyBase) -> np.ndarray:
    """The values of the original nodes, on the host."""
    if isinstance(strategy, NodeSplitting):
        dist = strategy.split_info.extract_original(dist)
    return operators.host_values(dist)


def check_kernels(op: operators.EdgeOp, dev: torch.device) -> None:
    """On a CUDA device, raise ``NotImplementedError`` before anything is
    allocated for an operator no kernel takes (``EdgeOp.kernel_codes``:
    its dtype, or add with a nonzero identity); a callable the lowering
    refuses raises at its first launch, before the build."""
    if dev.type == "cuda":
        op.kernel_codes()


def _planning_graph(graph: CSRGraph, dev: torch.device,
                    shards: Optional[int]) -> CSRGraph:
    """The graph a run plans on: on ``dev``, but a sharded run plans and
    partitions where the graph lies, and only the held shards go to
    ``dev`` (a rank of a graph larger than its device holds its shard)."""
    return graph if shards is not None else graph.to(dev)


def run(graph: CSRGraph, source: int, strategy: StrategyBase, *,
        max_iterations: int = 100000, record_degrees: bool = False,
        mode: str = "stepped", op="shortest_path",
        shards: Optional[int] = None, partition: str = "degree",
        schedule: str = "bsp", delta: Optional[int] = None,
        async_shards: bool = False, device="cuda") -> RunResult:
    """Relax from ``source`` to a fixed point.  With the default
    ``shortest_path`` operator, ``graph.wt is None`` ⇒ BFS levels, else
    SSSP distances.

    ``device="cuda"`` (the default) moves the graph to the card and runs
    the hand-written kernels; ``device="cpu"`` runs their plain PyTorch
    versions.  ``mode="fused"`` runs the traversal as one launch: the
    whole of it is booked as kernel time, ``iter_stats`` stays empty, and
    ``record_degrees`` (host-side per-iteration stats) raises
    ``ValueError``.

    ``shards=S`` (fused, strategies declaring :data:`SHARDABLE`)
    partitions the graph into S shards (``partition``: ``"degree"``
    balances edges, ``"contiguous"`` node counts; booked as setup) and
    runs them in lockstep, folding the shards' proposals at every chunk
    boundary: the same ``(dist, iterations, edges_relaxed)`` as one
    device (:mod:`repro_torch.core.shard`).  Without
    ``torch.distributed`` this process holds all S shards; with it, each
    rank holds one.  ``async_shards=True`` (idempotent operators) lets
    each shard run to a local fixed point between folds: ``iterations``
    counts epochs and ``relax_rounds`` the deepest shard's rounds.

    ``schedule="delta"`` (strategies declaring :data:`PRIORITY_SCHEDULE`,
    idempotent operators) runs delta-stepping
    (:mod:`repro_torch.core.priority`): ``delta=`` overrides the auto
    bucket width (``RunResult.delta`` reports the one used),
    ``iterations`` counts bucket epochs (what ``max_iterations`` caps),
    ``relax_rounds`` the relax passes, and each stepped epoch's
    ``IterStats`` carries the bucket it settled.  Stepped, one launch an
    epoch on the card; fused, one launch a traversal.

    EP runs by its edge worklist: each round relaxes the worklist and
    books its length as that round's frontier and edges, and the loop
    ends when the worklist is empty (one round before a node strategy's
    would: nothing is left to relax from the last improved nodes)."""
    _check_mode(mode)
    if mode == "fused" and record_degrees:
        raise ValueError(
            "record_degrees collects per-iteration host-side stats; "
            "use mode='stepped'")
    if record_degrees and schedule != "bsp":
        raise ValueError(
            "record_degrees reports per-BSP-iteration frontier degrees; "
            "it has no bucket-epoch equivalent; use schedule='bsp'")
    op = operators.resolve(op)
    _check_sharding(strategy, mode, shards)
    _check_schedule(strategy, schedule, delta, op, shards, async_shards)
    dev = resolve_device(device)
    check_kernels(op, dev)
    if not 0 <= int(source) < graph.num_nodes:
        raise ValueError(f"source {source} outside [0, {graph.num_nodes})")
    if graph.num_edges == 0:        # degenerate: nothing to relax
        dist = torch.full((graph.num_nodes,), op.identity,
                          dtype=operators.value_dtype(op))
        dist[source] = op.seed(source)
        dist = operators.host_values(dist)   # as every run's
        return RunResult(dist=dist, iterations=0, total_seconds=0.0,
                         setup_seconds=0.0, kernel_seconds=0.0,
                         overhead_seconds=0.0, edges_relaxed=0,
                         iter_stats=[], strategy=strategy.name,
                         state_bytes=0, mode=mode, device=dev.type,
                         shards=shards or 1, schedule=schedule, delta=delta,
                         async_shards=async_shards)

    t0 = time.perf_counter()
    graph = _planning_graph(graph, dev, shards)
    state = strategy.setup(graph)
    splan = dplan = None
    if shards is not None:
        # the partition is host preprocessing, booked as setup
        splan = _shard.plan_shards(strategy, state, graph, shards,
                                   method=partition,
                                   group=_shard.shard_group(shards, dev))
    if schedule == "delta":
        # the light/heavy split is host preprocessing, booked as setup
        dplan = priority.plan_delta(strategy, state, graph, op=op,
                                    delta=delta)
        delta = dplan.delta
    ready(graph.row_ptr if splan is None else splan.local[0].row_ptr)
    setup_s = time.perf_counter() - t0
    state_bytes = strategy.state_bytes(state)
    if splan is not None:
        state_bytes += splan.sharded.device_bytes()
    if dplan is not None:
        state_bytes += dplan.device_bytes()

    n = _n_alloc(graph, strategy)
    dist = torch.full((n,), op.identity, dtype=operators.value_dtype(op),
                      device=dev)
    dist[source] = op.seed(source)
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[source] = True
    done = dict(strategy=strategy.name, state_bytes=state_bytes,
                device=dev.type, shards=shards or 1, schedule=schedule,
                delta=delta, async_shards=async_shards,
                work_schedule=getattr(strategy, "resolved_schedule", None))

    if mode == "fused":
        rounds = split = None
        t_start = time.perf_counter()
        if splan is not None:
            dist, iterations, edges, rounds = _shard.run_fixed_point(
                splan, dist, mask, op=op, max_iterations=max_iterations,
                async_mode=async_shards)
            ready(dist)
        elif dplan is not None:
            dist, iterations, rounds, edges, split = (
                priority.run_fixed_point(dplan, dist, mask, op=op,
                                         max_iterations=max_iterations))
        else:
            dist, iterations, edges = fused.run_fixed_point(
                graph, state, strategy, dist, mask, op=op,
                max_iterations=max_iterations)
        total_s = time.perf_counter() - t_start
        # one launch: the whole traversal is kernel time, setup the only
        # host-side overhead
        return RunResult(
            dist=_original(dist, strategy), iterations=iterations,
            total_seconds=total_s + setup_s, setup_seconds=setup_s,
            kernel_seconds=total_s, overhead_seconds=setup_s,
            edges_relaxed=edges, iter_stats=[], mode="fused",
            relax_rounds=rounds, round_split=split, **done)

    iter_stats: list[IterStats] = []
    kernel_s = 0.0
    edges = 0
    it = 0
    rounds = split = None
    t_start = time.perf_counter()
    if dplan is not None:
        # one launch a bucket epoch; the host reads the frontier's count
        # between epochs and records the bucket each epoch settled
        count, rounds = 1, 0
        while count > 0 and it < max_iterations:
            tk = time.perf_counter()
            dist, mask, b, r, e, next_count, s = priority.step_epoch(
                dplan, dist, mask, op=op)
            kernel_s += time.perf_counter() - tk
            edges += e
            rounds += r
            split = s if split is None else split + s
            iter_stats.append(IterStats(
                frontier_size=int(count), edges_processed=int(e),
                sub_iterations=int(r), bucket=int(b),
                kernel=f"delta:{dplan.kernel}"))
            count = next_count
            it += 1
    elif isinstance(strategy, EdgeBased):
        wl, count = strategy.initial_worklist(state, source)
        while count > 0 and it < max_iterations:
            tk = time.perf_counter()
            relaxed = count          # worklist entries relaxed this round
            dist, _, wl, count = strategy.relax_and_push(
                state, dist, wl, count, op=op)
            ready(dist)
            kernel_s += time.perf_counter() - tk
            edges += relaxed
            iter_stats.append(IterStats(frontier_size=int(relaxed),
                                        edges_processed=int(relaxed)))
            it += 1
    else:
        count = 1
        while count > 0 and it < max_iterations:
            tk = time.perf_counter()
            dist, mask, stats = strategy.iterate(
                state, dist, mask, count, op=op,
                record_degrees=record_degrees)
            ready(dist)
            kernel_s += time.perf_counter() - tk
            iter_stats.append(stats)
            edges += stats.edges_processed
            count = int(mask.sum())
            it += 1
    total_s = time.perf_counter() - t_start
    return RunResult(
        dist=_original(dist, strategy), iterations=len(iter_stats),
        total_seconds=total_s + setup_s, setup_seconds=setup_s,
        kernel_seconds=kernel_s,
        overhead_seconds=max(total_s - kernel_s, 0.0) + setup_s,
        edges_relaxed=int(edges), iter_stats=iter_stats,
        relax_rounds=rounds, round_split=split, **done)


def fixed_point(graph: CSRGraph, strategy: StrategyBase, init, *,
                op="shortest_path", mode: str = "stepped",
                max_iterations: int = 100000,
                shards: Optional[int] = None, partition: str = "degree",
                schedule: str = "bsp", delta: Optional[int] = None,
                async_shards: bool = False, device="cuda"):
    """Run a strategy to its fixed point from a caller-supplied seeding:
    ``init(n_alloc)`` returns the initial ``(values, frontier_mask)`` on
    the strategy's allocation (``n_alloc`` counts NS's children too; the
    first ``ns_activate`` mirror overwrites whatever they were seeded
    with).  Both are moved to the run's device, the values as
    ``operators.value_dtype(op)``.  ``connected_components`` seeds every
    node with its own label this way.

    Needs a strategy declaring :data:`FRONTIER_INIT` (EP's edge worklist
    cannot hold an arbitrary dense frontier), checked right after the mode
    string, as the reference does.  Returns ``(values, iterations,
    edges_relaxed)``, ``values`` a host array on the original nodes.
    ``mode="fused"`` runs it as one launch, as in :func:`run`;
    ``shards=``/``async_shards`` shard it, as in :func:`run`;
    ``schedule="delta"`` runs delta-stepping, ``iterations`` counting
    epochs."""
    _check_mode(mode)
    if FRONTIER_INIT not in strategy.capabilities:
        raise ValueError(
            f"strategy {strategy.name!r} does not declare the "
            f"{FRONTIER_INIT!r} capability; seeding an arbitrary frontier "
            f"needs a node strategy")
    op = operators.resolve(op)
    _check_sharding(strategy, mode, shards)
    _check_schedule(strategy, schedule, delta, op, shards, async_shards)
    dev = resolve_device(device)
    check_kernels(op, dev)
    graph = _planning_graph(graph, dev, shards)
    state = strategy.setup(graph)
    values, mask = init(_n_alloc(graph, strategy))
    dist = torch.as_tensor(values).to(dev, operators.value_dtype(op))
    mask = torch.as_tensor(mask).to(dev, torch.bool)
    if shards is not None:
        splan = _shard.plan_shards(strategy, state, graph, shards,
                                   method=partition,
                                   group=_shard.shard_group(shards, dev))
        dist, it, edges, _ = _shard.run_fixed_point(
            splan, dist, mask, op=op, max_iterations=max_iterations,
            async_mode=async_shards)
        return _original(dist, strategy), it, edges
    if schedule == "delta":
        dplan = priority.plan_delta(strategy, state, graph, op=op,
                                    delta=delta)
        if mode == "fused":
            dist, it, _, edges, _ = priority.run_fixed_point(
                dplan, dist, mask, op=op, max_iterations=max_iterations)
            return _original(dist, strategy), it, edges
        count, it, edges = int(mask.sum()), 0, 0
        while count > 0 and it < max_iterations:
            dist, mask, _, _, e, count, _ = priority.step_epoch(
                dplan, dist, mask, op=op)
            edges += e
            it += 1
        return _original(dist, strategy), it, edges
    if mode == "fused":
        dist, it, edges = fused.run_fixed_point(
            graph, state, strategy, dist, mask, op=op,
            max_iterations=max_iterations)
        return _original(dist, strategy), it, edges
    count, it, edges = int(mask.sum()), 0, 0
    while count > 0 and it < max_iterations:
        dist, mask, stats = strategy.iterate(state, dist, mask, count, op=op)
        edges += stats.edges_processed
        count = int(mask.sum())
        it += 1
    return _original(dist, strategy), it, edges


def run_batch(graph: CSRGraph, sources, *, max_iterations: int = 100000,
              mode: str = "stepped", op="shortest_path",
              shards: Optional[int] = None, partition: str = "degree",
              schedule: str = "bsp", delta: Optional[int] = None,
              pad_to: Optional[int] = None,
              work_schedule: Optional[Schedule] = None, device="cuda"):
    """Run K sources concurrently against one graph (dist is ``[K, N]``).

    Thin wrapper over :func:`repro_torch.core.multi_source.run_batch`,
    kept here so single-source and batched entry points live side by
    side: on the card one B1 batch launch an iteration (stepped) or one
    fused launch a batch; ``shards=S`` (fused only) runs the sharded WD
    step on every row; ``schedule="delta"`` (fused only) runs every row
    as its own delta-stepping traversal; ``pad_to=P`` K-buckets the
    batch (the serving tier's)."""
    from repro_torch.core import multi_source
    return multi_source.run_batch(
        graph, sources, max_iterations=max_iterations, mode=mode, op=op,
        shards=shards, partition=partition, schedule=schedule, delta=delta,
        pad_to=pad_to,
        work_schedule=work_schedule, device=device)


def reference_distances(graph: CSRGraph, source: int) -> np.ndarray:
    """Host-side Dijkstra/BFS oracle for correctness tests."""
    import heapq
    row_ptr = graph.row_ptr.cpu().numpy()
    col = graph.col.cpu().numpy()
    wt = (np.ones(graph.num_edges, np.int64) if graph.wt is None
          else graph.wt.cpu().numpy().astype(np.int64))
    n = graph.num_nodes
    dist = np.full(n, np.iinfo(np.int64).max)
    dist[source] = 0
    heap = [(0, source)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        for e in range(row_ptr[u], row_ptr[u + 1]):
            v = col[e]
            nd = d + wt[e]
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    out = np.full(n, INF, np.int64)
    reach = dist < np.iinfo(np.int64).max
    out[reach] = dist[reach]
    return out.astype(np.int32)
