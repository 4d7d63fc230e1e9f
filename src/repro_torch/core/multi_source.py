"""Batched multi-source fixed point of the port (the serving workload; the
counterpart of :mod:`repro.core.multi_source`).

:func:`repro_torch.core.engine.run` answers one query a call.  A serving
deployment answers many BFS/SSSP queries against the same graph, so this
module runs K sources as one fixed point:

* ``dist`` is ``[K, N]`` and the frontier a ``[K, N]`` bool mask;
* each stepped iteration is ONE launch of B1's batch contract for all K
  rows (``relax.wd_apply_relax_union``), where the reference ``vmap``-s
  its WD relax over the source axis: the rows' values and frontiers are
  node-major (``[N, Kp]``, ``Kp`` = K rounded up to 4) for the whole
  traversal, and one merge path runs over the union of the rows'
  frontiers, each lane relaxing its edge in every row that holds its
  source;
* the capacities are shared by the batch: every iteration takes the
  widest live frontier and the largest edge total over the K rows, rounds
  them up with :func:`repro_torch.core.worklist.bucket`, and rows whose
  frontier is empty ride along with no valid lane.

A row whose query has converged stops producing frontier bits;
:func:`refill_slot` swaps a fresh source into it without touching the
other rows.

``run_batch(..., mode=)``:

* ``"stepped"``: the loop above.  The host syncs only the ``[K]`` frontier
  counts and degree totals and the union's size and edges each iteration
  (the reference copies the whole ``[K, N]`` mask; the numbers are the
  same);
* ``"fused"``: the whole batch to its fixed point in one launch,
  :func:`repro_torch.core.fused.run_batch_fixed_point`, with no
  per-iteration ``iter_stats``.

``schedule="delta"`` (fused only, as in the reference) runs every row as
its own delta-stepping traversal with WD phases
(:func:`repro_torch.core.priority.run_batch_fixed_point`: one single-row
launch a row on the card); ``iterations`` and ``relax_rounds`` are the
slowest row's.  ``shards=S`` (fused only) partitions the graph and runs
the sharded WD step on every live row
(:func:`repro_torch.core.shard.run_batch_fixed_point`: one B1 launch a
row and held shard an iteration on the card).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import fused, operators, priority, shard
from repro_torch.core.graph import CSRGraph, resolve_device
from repro_torch.core.operators import EdgeOp
from repro_torch.core.schedule import DEFAULT_SCHEDULE, Schedule
from repro_torch.core.strategies import IterStats
from repro_torch.core.worklist import bucket
from repro_torch.kernels import relax


@dataclasses.dataclass
class BatchRunResult:
    dist: np.ndarray                 # [K, N] final distances / levels
    sources: np.ndarray              # [K] the batched source nodes
    iterations: int                  # fixed-point iterations for the batch
    total_seconds: float             # to the device's finish, no host copy
    edges_relaxed: int               # summed over all K sources
    iter_stats: list
    strategy: str = "WD-batch"
    mode: str = "stepped"            # "stepped" or "fused"
    shards: int = 1
    #: where the batch ran: "cuda" (hand-written kernels) or "cpu" (their
    #: plain PyTorch versions).  Replaces the reference's ``backend``.
    device: str = "cuda"
    schedule: str = "bsp"
    delta: Optional[int] = None
    relax_rounds: Optional[int] = None
    #: trailing rows that are padding, not queries (``pad_to=``);
    #: ``dist[:K - pad_lanes]`` are the requested rows, and
    #: ``edges_relaxed`` includes the padded rows' work
    pad_lanes: int = 0

    def __post_init__(self):
        if self.relax_rounds is None:
            self.relax_rounds = self.iterations

    @property
    def mteps(self) -> float:
        if self.total_seconds <= 0:
            return 0.0
        return self.edges_relaxed / self.total_seconds / 1e6

    @property
    def queries_per_second(self) -> float:
        if self.total_seconds <= 0:
            return 0.0
        return self.sources.shape[0] / self.total_seconds


def _elapsed(t0: float, dist_b: torch.Tensor) -> float:
    """Seconds since ``t0`` once the device has finished ``dist_b``: the
    clock stops before the ``[K, N]`` copy to the host, as the
    reference's stops before ``np.asarray(dist_b)``."""
    if dist_b.is_cuda:
        torch.cuda.synchronize(dist_b.device)
    return time.perf_counter() - t0


def compact_rows(mask_b: torch.Tensor, cap: int) -> torch.Tensor:
    """``[K, N]`` bool mask -> ``[K, cap]`` int32 worklists: each row's
    set indices ascending, padded with -1 and truncated to ``cap`` (the
    reference's ``compact_mask`` on every row)."""
    k, n = mask_b.shape
    pos = torch.cumsum(mask_b, 1, dtype=torch.int32) - 1   # rank in the row
    slot = torch.where(mask_b & (pos < cap), pos, cap).long()
    out = torch.full((k, cap + 1), -1, dtype=torch.int32,
                     device=mask_b.device)
    ids = torch.arange(n, dtype=torch.int32, device=mask_b.device)
    out.scatter_(1, slot, ids.expand(k, n))      # column cap: discarded
    return out[:, :cap].contiguous()


def row_tables(g: CSRGraph, mask_b: torch.Tensor, cap: int) -> tuple:
    """Each row's WD slot tables ``(prefix, exclusive, start, src_ids)``,
    ``[K, cap]``, as the reference's vmapped ``wd_relax`` builds them: the
    inputs of the row-by-row oracle ``relax.wd_apply_relax_batch_plain``."""
    frontier = compact_rows(mask_b, cap)
    live = frontier >= 0
    f = torch.where(live, frontier, 0)
    deg = torch.where(live, g.row_ptr[f + 1] - g.row_ptr[f], 0)
    prefix = torch.cumsum(deg, 1, dtype=torch.int32)
    return prefix, prefix - deg, g.row_ptr[f], f


def row_quads(k: int) -> int:
    """``Kp``, the node-major width of ``k`` rows: ``k`` rounded up to 4
    (the kernel takes a node's rows in 16-byte quads)."""
    return -(-k // 4) * 4


def to_node_major(x_b: torch.Tensor, fill) -> torch.Tensor:
    """``[K, N]`` -> ``[N, Kp]``, the padded columns set to ``fill``."""
    k, n = x_b.shape
    out = torch.full((n, row_quads(k)), fill, dtype=x_b.dtype,
                     device=x_b.device)
    out[:, :k] = x_b.t()
    return out


def from_node_major(x_t: torch.Tensor, k: int) -> torch.Tensor:
    """``[N, Kp]`` -> its first ``k`` rows, ``[K, N]``."""
    return x_t[:, :k].t().contiguous()


def union_tables(g: CSRGraph, live: torch.Tensor, slots: int) -> tuple:
    """The WD slot tables ``(prefix, exclusive, start, src_ids)``, ``[slots]``,
    of the union frontier ``live [N]`` (one ``[N]`` compaction, one degree
    gather, one prefix); ``slots`` must hold every live node, and the
    slots past them are node 0 with no edge."""
    n = live.numel()
    pos = torch.cumsum(live, 0, dtype=torch.int32) - 1
    at = torch.where(live, pos, slots).long()
    ids = torch.full((slots + 1,), -1, dtype=torch.int32, device=live.device)
    ids.scatter_(0, at, torch.arange(n, dtype=torch.int32,
                                     device=live.device))
    ids = ids[:slots]
    used = ids >= 0
    f = torch.where(used, ids, 0)
    deg = torch.where(used, g.row_ptr[f + 1] - g.row_ptr[f], 0)
    prefix = torch.cumsum(deg, 0, dtype=torch.int32)
    return prefix, prefix - deg, g.row_ptr[f], f


def row_exclusive(front_t: torch.Tensor, prefix: torch.Tensor,
                  exclusive: torch.Tensor, src_ids: torch.Tensor):
    """``[slots, Kp]`` int32: each row's exclusive degree prefix at each
    union slot over that row's own frontier, i.e. the row's lane index of
    the slot's first edge (``relax.wd_apply_relax_union``'s ``row_excl``)."""
    mine = front_t[src_ids] * (prefix - exclusive)[:, None]
    return torch.cumsum(mine, 0, dtype=torch.int32) - mine


def _relax_node_major(g: CSRGraph, dist_t, front_t, live, *, slots: int,
                      max_lanes: int, cap_work: int, op: EdgeOp,
                      cut: bool):
    """One relax iteration of every row on node-major ``dist_t``/
    ``front_t`` (``[N, Kp]``): the slot tables of the union frontier
    ``live`` (``front_t.any(1)``; ``slots`` of them), then ONE launch of
    B1's batch contract.  ``cut``: some row may pass ``cap_work`` lanes,
    so each row's exclusive prefix at the slots goes along."""
    prefix, excl, start, src = union_tables(g, live, slots)
    row_excl = row_exclusive(front_t, prefix, excl, src) if cut else None
    return relax.wd_apply_relax_union(
        dist_t, front_t, prefix, excl, start, src, g.col, g.wt,
        cap_work=cap_work, max_lanes=max_lanes, row_excl=row_excl, op=op)


def batched_wd_relax(g: CSRGraph, dist_b, mask_b, *, cap: int,
                     cap_work: int, op: EdgeOp = operators.shortest_path):
    """One relax iteration for all K rows, each as the reference's: its
    first ``cap`` frontier nodes (ascending ids), its edges in that order,
    cut at ``cap_work`` lanes.  The rows go node-major, their frontiers
    are cut at ``cap`` and joined into one union frontier, and ONE launch
    of B1's batch contract relaxes them (its plain version on the CPU).
    Returns ``(dist [K, N], next frontier [K, N])``."""
    k, n = mask_b.shape
    if k == 0 or cap == 0:
        return dist_b.clone(), torch.zeros_like(mask_b)
    dist_t = to_node_major(dist_b, op.identity)
    front_t = to_node_major(mask_b, False)
    front_t &= torch.cumsum(front_t, 0, dtype=torch.int32) <= cap
    dist_t, front_t = _relax_node_major(
        g, dist_t, front_t, front_t.any(1), slots=min(n, k * cap),
        max_lanes=min(g.num_edges, k * cap_work), cap_work=cap_work, op=op,
        cut=True)
    return from_node_major(dist_t, k), from_node_major(front_t, k)


def init_batch(num_nodes: int, sources: torch.Tensor,
               op: EdgeOp = operators.shortest_path):
    """Initial ``[K, N]`` values and frontier mask for a batch of
    ``sources`` (on their device)."""
    k, dev = sources.numel(), sources.device
    rows = torch.arange(k, device=dev)
    src = sources.long()
    dtype = operators.value_dtype(op)
    dist = torch.full((k, num_nodes), op.identity, dtype=dtype, device=dev)
    dist[rows, src] = torch.as_tensor(op.seed(sources), dtype=dtype,
                                      device=dev)
    mask = torch.zeros((k, num_nodes), dtype=torch.bool, device=dev)
    mask[rows, src] = True
    return dist, mask


def refill_slot(dist_b, mask_b, slot: int, source: int,
                op: EdgeOp = operators.shortest_path):
    """Admit a new query into row ``slot``: reset its values and seed its
    frontier at ``source``; the other rows are untouched (continuous
    batching).  Returns new ``(dist_b, mask_b)``."""
    dist_b, mask_b = dist_b.clone(), mask_b.clone()
    dist_b[slot] = op.identity
    dist_b[slot, source] = op.seed(source)
    mask_b[slot] = False
    mask_b[slot, source] = True
    return dist_b, mask_b


def _pad(sources: np.ndarray, pad_to: Optional[int]) -> tuple:
    """``pad_to`` K-bucketing (the serving tier's): pad lanes re-run the
    first source (node 0 on an empty batch)."""
    if pad_to is None:
        return sources, 0
    if pad_to < sources.shape[0]:
        raise ValueError(
            f"pad_to={pad_to} is smaller than the batch "
            f"({sources.shape[0]} sources); pick a bucket >= K")
    pad_lanes = pad_to - int(sources.shape[0])
    fill = sources[0] if sources.shape[0] else np.int32(0)
    return (np.concatenate([sources, np.full(pad_lanes, fill, np.int32)]),
            pad_lanes)


def run_batch(graph: CSRGraph, sources, *, max_iterations: int = 100000,
              mode: str = "stepped", op="shortest_path",
              shards: Optional[int] = None, partition: str = "degree",
              schedule: str = "bsp", delta: Optional[int] = None,
              pad_to: Optional[int] = None,
              work_schedule: Optional[Schedule] = None,
              device="cuda") -> BatchRunResult:
    """Fixed point over K sources at once, equal to K independent
    ``engine.run`` calls with WD in every row's values; only the batching
    differs.  With the default ``shortest_path`` operator, ``graph.wt is
    None`` gives BFS levels, else SSSP distances.

    ``device="cuda"`` (the default) runs B1's batch contract (stepped) or
    the fused kernel a row (``mode="fused"``); ``device="cpu"``
    runs their plain versions.  ``pad_to=P`` rounds the batch up to P
    rows by repeating the first source (``BatchRunResult.pad_lanes``).
    ``work_schedule`` sets the worklist floor.  ``schedule="delta"``
    (``mode="fused"``, idempotent operators; ``delta=`` the bucket width)
    runs every row as its own delta-stepping traversal.  ``shards=S``
    (``mode="fused"``; ``partition`` as in ``engine.run``) runs the
    sharded WD step on every row.  An unknown mode, a stepped sharded or
    delta batch, a sharded delta batch and a source outside ``[0, N)``
    raise ``ValueError`` (the reference drops such a source silently)."""
    from repro_torch.core.engine import (_check_mode, _check_schedule,
                                         _check_sharding, check_kernels)
    _check_mode(mode)
    _check_sharding(None, mode, shards)
    op = operators.resolve(op)
    _check_schedule(None, schedule, delta, op, shards)
    if schedule == "delta" and mode != "fused":
        raise ValueError(
            "batched delta-stepping runs whole per-row traversals, a "
            "fused-only construction; pass mode='fused'")
    dev = resolve_device(device)
    check_kernels(op, dev)
    n = graph.num_nodes
    sources = np.asarray(sources, np.int32).reshape(-1)
    if np.any((sources < 0) | (sources >= n)):
        raise ValueError(f"sources {sources.tolist()} leave [0, {n})")
    sources, pad_lanes = _pad(sources, pad_to)
    k = int(sources.shape[0])
    done = dict(sources=sources, iterations=0, total_seconds=0.0,
                edges_relaxed=0, iter_stats=[], mode=mode, device=dev.type,
                shards=shards or 1, schedule=schedule, delta=delta,
                pad_lanes=pad_lanes)
    dtype = operators.value_dtype(op)
    if k == 0:
        return BatchRunResult(dist=operators.host_values(
            torch.zeros((0, n), dtype=dtype)), **done)
    if graph.num_edges == 0:        # the operator's dtype, as every run's
        dist = torch.full((k, n), op.identity, dtype=dtype)
        dist[torch.arange(k), torch.from_numpy(sources).long()] = \
            torch.as_tensor(op.seed(sources), dtype=dtype)
        return BatchRunResult(dist=operators.host_values(dist), **done)

    sched = work_schedule if work_schedule is not None else DEFAULT_SCHEDULE
    if shards is None:      # a sharded batch holds its shards alone on dev
        graph = graph.to(dev)
    t0 = time.perf_counter()
    dist_b, mask_b = init_batch(n, torch.from_numpy(sources).to(dev), op=op)

    if schedule == "delta":
        from repro_torch.core.strategies import make_strategy
        wd = make_strategy("WD", schedule=sched)
        dplan = priority.plan_delta(wd, wd.setup(graph), graph, op=op,
                                    delta=delta)
        dist_b, iterations, rounds, edges = priority.run_batch_fixed_point(
            dplan, dist_b, mask_b, op=op, max_iterations=max_iterations)
        total_s = _elapsed(t0, dist_b)
        return BatchRunResult(dist=operators.host_values(dist_b),
                              sources=sources,
                              iterations=iterations, total_seconds=total_s,
                              edges_relaxed=edges, iter_stats=[],
                              mode="fused", device=dev.type,
                              schedule="delta", delta=dplan.delta,
                              relax_rounds=rounds, pad_lanes=pad_lanes)

    if shards is not None:
        sharded, _ = shard.partition(graph, shards, method=partition)
        dist_b, iterations, edges = shard.run_batch_fixed_point(
            sharded, dist_b, mask_b, group=shard.shard_group(shards, dev),
            op=op, max_iterations=max_iterations)
        total_s = _elapsed(t0, dist_b)
        return BatchRunResult(dist=operators.host_values(dist_b),
                              sources=sources,
                              iterations=iterations, total_seconds=total_s,
                              edges_relaxed=edges, iter_stats=[],
                              mode="fused", shards=shards, device=dev.type,
                              pad_lanes=pad_lanes)

    if mode == "fused":
        dist_b, iterations, edges = fused.run_batch_fixed_point(
            graph, dist_b, mask_b, op=op, max_iterations=max_iterations,
            sched=sched)
        total_s = _elapsed(t0, dist_b)
        return BatchRunResult(dist=operators.host_values(dist_b),
                              sources=sources,
                              iterations=iterations, total_seconds=total_s,
                              edges_relaxed=edges, iter_stats=[],
                              mode="fused", device=dev.type,
                              pad_lanes=pad_lanes)

    # node-major for the whole traversal: one transpose in, one out
    dist_t = to_node_major(dist_b, op.identity)
    front_t = to_node_major(mask_b, False)
    degrees = graph.degrees
    iter_stats: list[IterStats] = []
    edges = 0
    it = 0
    while it < max_iterations:
        # the [K] counts and degree totals, and the union frontier's size
        # and edges: the one sync an iteration
        live = front_t.any(1)
        stats = torch.cat([
            front_t.sum(0, dtype=torch.int64)[:k],
            (front_t * degrees[:, None]).sum(0, dtype=torch.int64)[:k],
            live.sum(dtype=torch.int64)[None],
            torch.where(live, degrees, 0).sum(dtype=torch.int64)[None],
        ]).tolist()
        counts, totals = stats[:k], stats[k:2 * k]
        union, union_edges = stats[2 * k:]
        widest = max(counts)
        if widest == 0:
            break
        # cap = bucket(widest) and cap_work = bucket(max(totals)) hold
        # every row whole, so no row is cut
        dist_t, front_t = _relax_node_major(
            graph, dist_t, front_t, live,
            slots=bucket(union, sched.min_bucket),
            max_lanes=union_edges,
            cap_work=bucket(max(totals), sched.min_bucket), op=op,
            cut=False)
        edges += sum(totals)
        iter_stats.append(IterStats(frontier_size=widest,
                                    edges_processed=sum(totals),
                                    kernel="WD"))
        it += 1
    dist_b = from_node_major(dist_t, k)
    total_s = _elapsed(t0, dist_b)
    return BatchRunResult(dist=operators.host_values(dist_b),
                          sources=sources, iterations=it,
                          total_seconds=total_s,
                          edges_relaxed=edges, iter_stats=iter_stats,
                          device=dev.type, pad_lanes=pad_lanes)
