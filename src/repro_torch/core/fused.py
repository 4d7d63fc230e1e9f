"""Fused fixed point of the port: one launch per traversal (ROADMAP A7).

The stepped engine (:mod:`repro_torch.core.engine`) goes back to the host
between launches: frontier counts, column counts and worklist sizes are
synced every iteration, and a BS column is about ten PyTorch calls.  This
module runs a whole traversal, any built-in :class:`EdgeOp`, as one
device-resident loop, the counterpart of the reference's
``repro.core.fused``:

* on a CUDA tensor, ONE launch of the persistent cooperative kernel
  ``csrc/fused.cu`` (:func:`repro_torch.kernels.fused.fixed_point`), which
  runs the loop, the frontier statistics and every chunk on the card and
  reads back iterations, the edge total and AD's choices with one sync;
* on a CPU tensor, :func:`_fixed_point_plain`, a plain PyTorch loop over
  the reference's dense step bodies (:func:`_bs_step`, :func:`_wd_step`,
  :func:`_hp_step`, :func:`_ep_step`, :func:`_ns_step`,
  :func:`_ad_step`), which keep its shapes (``[N]`` node lanes, ``[E]``
  edge lanes, ``[N, MDT]`` HP tiles) and so its chunk schedule.

Both give the reference's ``mode="fused"`` bits: ``(dist, iterations,
edges_relaxed)`` and AD's ``kernel_counts``, which equal its stepped
engine's.  The edge total is a Python int (the reference carries two
int32 limbs because JAX runs without x64; nothing here needs them).

:data:`DISPATCH_COUNTS` moves by one per traversal, keyed by kernel name.
The reference's ``TRACE_COUNTS`` has no counterpart: nothing here
compiles per shape.  AD with a measured cost model
(``make_strategy("AD", cost_model=...)``, ROADMAP A9) carries the model's
``[3, 3]`` float32 coefficients in its plan (:attr:`FusedPlan.coeffs`):
:func:`_ad_step` and the kernel's selector then take the argmin of
``a + b·degree_sum + c·count`` instead of the fixed tree.

:func:`run_batch_fixed_point` runs K WD queries as one batch (ROADMAP A8,
the reference's ``_batch_fixed_point``): a launch of the same kernel a
row on the card, :func:`_batch_fixed_point_plain` on the CPU.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import operators
from repro_torch.core.graph import CSRGraph
from repro_torch.core.operators import EdgeOp
from repro_torch.core.schedule import DEFAULT_SCHEDULE, Schedule
from repro_torch.core.strategies import (
    AdaptiveStrategy, EdgeBased, HierarchicalProcessing, NodeBased,
    NodeSplitting, WorkloadDecomposition, _edge_weight)
from repro_torch.kernels import fused as fused_kernel
from repro_torch.kernels.relax import apply_relax_plain

#: traversals started, per kernel: one per :func:`run_fixed_point` call,
#: and ``"batch"`` one per :func:`run_batch_fixed_point` call
DISPATCH_COUNTS: Counter = Counter()

#: AD's branches, in the order of its kernel tally
_AD_KERNEL_ORDER = ("BS", "WD", "HP")


# ---------------------------------------------------------------------------
# the plain version: dense-mask steps, (dist [N], mask [N]) -> (dist,
# next frontier mask, edges relaxed), the reference's shapes
# ---------------------------------------------------------------------------

def _masked_degrees(g: CSRGraph, mask: torch.Tensor) -> torch.Tensor:
    """Out-degree where the node is in the frontier, 0 elsewhere."""
    return torch.where(mask, g.row_ptr[1:] - g.row_ptr[:-1], 0)


def _merge_path_relax(g: CSRGraph, dist, updated, work, cursor: int = 0, *,
                      op: EdgeOp):
    """One synchronous merge-path relax over ``E`` edge lanes: node ``n``
    contributes ``work[n]`` edges from ``row_ptr[n] + cursor`` on, and
    each lane finds its node by a search of the inclusive prefix.  Sets
    ``updated`` in place; returns ``(dist, updated)``."""
    prefix = torch.cumsum(work, 0, dtype=torch.int32)
    exclusive = prefix - work
    k = torch.arange(g.num_edges, dtype=torch.int32, device=dist.device)
    node = torch.searchsorted(prefix, k, right=True, out_int32=True)
    node = node.clamp_(0, g.num_nodes - 1)
    eidx = (g.row_ptr[node] + cursor + (k - exclusive[node])).clamp_(
        0, g.num_edges - 1)
    dist, updated, _ = apply_relax_plain(
        dist, updated, node, g.col[eidx], _edge_weight(g, eidx),
        k < prefix[-1], op=op)
    return dist, updated


def tail_start(deg: torch.Tensor, width: int) -> int:
    """The first BS/NS column the fused kernel runs inside one block, for a
    frontier whose degrees are ``deg`` (0 off the frontier): 0 when at most
    ``width`` nodes have edges, else the least power of two ``D`` with at
    most ``width`` nodes of degree ``>= D``, so that every column from
    ``D`` on has at most ``width`` live slots (``csrc/fused.cu``
    ``tail_start``, from a histogram of degree bit lengths).  ``width`` 0:
    none (a column past every degree)."""
    if width <= 0:
        return 1 << 31
    if int((deg >= 1).sum()) <= width:
        return 0
    d = 2
    while int((deg >= d).sum()) > width:
        d *= 2
    return d


def bs_split(deg: torch.Tensor,
             width: Optional[int] = None) -> tuple[int, int]:
    """A BS/NS step's columns as the fused kernel runs them: ``(grid-wide,
    one-block)``, the tail from :func:`tail_start` at ``width`` (default
    ``kernels.fused.TAIL_WIDTH``), taken when it has at least
    ``TAIL_MIN_COLUMNS`` columns."""
    if width is None:
        width = fused_kernel.TAIL_WIDTH
    max_degree = int(deg.max())
    grid = min(max_degree, tail_start(deg, width))
    if max_degree - grid < fused_kernel.TAIL_MIN_COLUMNS:
        grid = max_degree
    return grid, max_degree - grid


def delta_round_split(kernel: str, rounds,
                      width: Optional[int] = None) -> tuple[int, int]:
    """A delta-stepping traversal's relax rounds as the fused kernel's
    delta mode runs them: ``(grid-wide, narrow)``.  ``rounds`` holds each
    round's ``(nodes, edges)``: its frontier's size and the edges it
    relaxed.  A round is narrow (inside one block, with no grid barrier)
    when ``width`` (default ``kernels.fused.TAIL_WIDTH``) is positive and
    it has at most ``width`` nodes and ``NARROW_EDGES`` edges, unless the
    kernel is NS, whose gather over every node stays grid-wide
    (``csrc/fused.cu`` ``stage_narrow``)."""
    if width is None:
        width = fused_kernel.TAIL_WIDTH
    rounds = list(rounds)
    narrow = sum(kernel != "NS" and 0 < width and nodes <= width
                 and edges <= fused_kernel.NARROW_EDGES
                 for nodes, edges in rounds)
    return len(rounds) - narrow, narrow


def _tally(tally: Optional[list], grid: int, block: int = 0) -> None:
    """Count a step's chunks into ``[grid, block]``, where one is kept."""
    if tally is not None:
        tally[0] += grid
        tally[1] += block


def _bs_step(g: CSRGraph, dist, mask, *, op: EdgeOp,
             tally: Optional[list] = None):
    """Dense BS: column ``d`` relaxes the ``d``-th edge of every frontier
    node, for the frontier's max degree columns, each folded before the
    next reads ``dist``.  ``tally`` counts the columns that run grid-wide
    and inside one block (:func:`bs_split`)."""
    deg = _masked_degrees(g, mask)
    base = g.row_ptr[:-1]
    nodes = torch.arange(g.num_nodes, dtype=torch.int32, device=dist.device)
    updated = torch.zeros_like(mask)
    if tally is not None:
        _tally(tally, *bs_split(deg))
    for d in range(int(deg.max())):
        eidx = (base + d).clamp_(0, g.num_edges - 1)
        dist, updated, _ = apply_relax_plain(
            dist, updated, nodes, g.col[eidx], _edge_weight(g, eidx),
            mask & (d < deg), op=op)
    return dist, updated, int(deg.sum())


def _wd_step(g: CSRGraph, dist, mask, *, op: EdgeOp,
             tally: Optional[list] = None):
    """Dense WD: one synchronous merge path over the frontier's edges (one
    chunk)."""
    _tally(tally, 1)
    deg = _masked_degrees(g, mask)
    dist, updated = _merge_path_relax(g, dist, torch.zeros_like(mask), deg,
                                      op=op)
    return dist, updated, int(deg.sum())


def _hp_step(g: CSRGraph, dist, mask, *, sched: Schedule, op: EdgeOp,
             tally: Optional[list] = None):
    """Dense HP: a frontier of at most ``switch_threshold`` nodes takes
    WD; a larger one runs ``[N, MDT]`` tiles (at least one) while more
    than ``switch_threshold`` nodes have edges left past the cursor, then
    a cursor-aware WD tail over the rest (a chunk a tile, and one for a
    tail with edges)."""
    mdt = sched.mdt or 1
    deg = _masked_degrees(g, mask)
    if int(mask.sum()) <= sched.switch_threshold:
        dist, updated, _ = _wd_step(g, dist, mask, op=op, tally=tally)
        return dist, updated, int(deg.sum())
    n, e = g.num_nodes, g.num_edges
    nodes = torch.arange(n, dtype=torch.int32, device=dist.device)
    src = nodes[:, None].expand(n, mdt).reshape(-1)
    j = torch.arange(mdt, dtype=torch.int32, device=dist.device)[None, :]
    updated = torch.zeros_like(mask)
    cursor = 0
    while True:
        pos = cursor + j                                        # [1, mdt]
        valid = (mask[:, None] & (pos < deg[:, None])).reshape(-1)
        eidx = (g.row_ptr[:-1, None] + pos).clamp_(0, e - 1).reshape(-1)
        dist, updated, _ = apply_relax_plain(
            dist, updated, src, g.col[eidx], _edge_weight(g, eidx), valid,
            op=op)
        cursor += mdt
        _tally(tally, 1)
        if int((deg > cursor).sum()) <= sched.switch_threshold:
            break
    rem = (deg - cursor).clamp_(min=0)
    _tally(tally, int(rem.sum() > 0))
    dist, updated = _merge_path_relax(g, dist, updated, rem, cursor, op=op)
    return dist, updated, int(deg.sum())


def _ep_step(g: CSRGraph, edge_src, dist, mask, *, op: EdgeOp,
             tally: Optional[list] = None):
    """Dense EP: all ``E`` edge lanes, valid where the source is live (one
    chunk)."""
    _tally(tally, 1)
    valid = mask[edge_src]
    eidx = torch.arange(g.num_edges, dtype=torch.int32, device=dist.device)
    dist, updated, _ = apply_relax_plain(
        dist, torch.zeros_like(mask), edge_src, g.col,
        _edge_weight(g, eidx), valid, op=op)
    return dist, updated, int(valid.sum())


def _ns_step(g2: CSRGraph, child_parent, dist, mask, *, op: EdgeOp,
             tally: Optional[list] = None):
    """Dense NS: mirror every parent onto its children (``ns_activate``),
    then dense BS on the split graph."""
    dist = dist[child_parent]
    mask = mask | mask[child_parent]
    return _bs_step(g2, dist, mask, op=op, tally=tally)


def _measured_choice(coeffs, count: int, degree_sum: int) -> int:
    """Measured AD's branch: the first argmin of ``a + b·es + c·cn`` in
    float32, each operation rounded; 0 (BS) for an edgeless or empty
    frontier."""
    if degree_sum == 0 or count == 0:
        return 0
    c = np.asarray(coeffs, np.float32)
    es, cn = np.float32(degree_sum), np.float32(count)
    return int(np.argmin(c[:, 0] + c[:, 1] * es + c[:, 2] * cn))


def _ad_step(g: CSRGraph, dist, mask, *, sched: Schedule, op: EdgeOp,
             coeffs: Optional[np.ndarray] = None,
             tally: Optional[list] = None):
    """AD's choice on the frontier's statistics, then that kernel's step.
    Returns the step's result and the branch (0 BS, 1 WD, 2 HP).

    With ``coeffs`` None, the fixed decision tree in the reference's
    float32 order.  With ``coeffs`` a ``[3, 3]`` float32 cost model, the
    first argmin of ``a + b·es + c·cn`` per kernel, each operation
    rounded, as :meth:`repro_torch.core.costmodel.CostModel.choose`.  An
    edgeless or empty frontier takes BS either way."""
    mdt = sched.mdt or 1
    deg = _masked_degrees(g, mask)
    count = int(mask.sum())
    degree_sum, max_degree = int(deg.sum()), int(deg.max())
    mean = np.float32(degree_sum) / np.float32(max(count, 1))
    imbalance = (np.float32(max_degree) / mean if mean > 0
                 else np.float32(1.0))
    if degree_sum == 0 or count == 0:
        idx = 0
    elif coeffs is not None:
        idx = _measured_choice(coeffs, count, degree_sum)
    elif (count <= sched.small_frontier
          and imbalance <= np.float32(sched.imbalance_threshold)):
        idx = 0
    elif max_degree > mdt and degree_sum >= sched.hp_edges_threshold:
        idx = 2
    else:
        idx = 1
    if idx == 0:
        out = _bs_step(g, dist, mask, op=op, tally=tally)
    elif idx == 1:
        out = _wd_step(g, dist, mask, op=op, tally=tally)
    else:
        out = _hp_step(g, dist, mask, sched=sched, op=op, tally=tally)
    return (*out, idx)


def _fixed_point_plain(kernel: str, g: CSRGraph, aux, dist, mask, *,
                       op: EdgeOp, sched: Schedule, max_iterations: int,
                       coeffs: Optional[np.ndarray] = None):
    """The fused loop in plain PyTorch, on the tensors' device: while the
    frontier is live (EP: while it has outgoing edges) and ``it <
    max_iterations``, one dense step (``coeffs``: measured AD's model).
    Returns ``(dist, iterations, edges_relaxed, [BS, WD, HP] counts of
    AD's choices, Chunks)``: the kernel's counts, but for its barriers."""
    chosen = [0, 0, 0]
    it, edges = 0, 0
    tally = [0, 0]
    while it < max_iterations:
        if kernel == "EP":
            live = int(_masked_degrees(g, mask).sum()) > 0
        else:
            live = bool(mask.any())
        if not live:
            break
        if kernel == "BS":
            dist, mask, e = _bs_step(g, dist, mask, op=op, tally=tally)
        elif kernel == "WD":
            dist, mask, e = _wd_step(g, dist, mask, op=op, tally=tally)
        elif kernel == "HP":
            dist, mask, e = _hp_step(g, dist, mask, sched=sched, op=op,
                                     tally=tally)
        elif kernel == "EP":
            dist, mask, e = _ep_step(g, aux, dist, mask, op=op, tally=tally)
        elif kernel == "NS":
            dist, mask, e = _ns_step(g, aux, dist, mask, op=op, tally=tally)
        elif kernel == "AD":
            dist, mask, e, idx = _ad_step(g, dist, mask, sched=sched, op=op,
                                          coeffs=coeffs, tally=tally)
            chosen[idx] += 1
        else:
            raise ValueError(f"unknown fused kernel {kernel!r}")
        edges += e
        it += 1
    return dist, it, edges, chosen, fused_kernel.Chunks(*tally)


# ---------------------------------------------------------------------------
# strategy instance -> fused lowering
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FusedPlan:
    """How to run one strategy as a single fused launch."""
    kernel: str
    graph: CSRGraph               # graph the loop runs on (NS: split graph)
    aux: Optional[torch.Tensor]   # EP edge sources / NS child_parent
    sched: Schedule               # the resolved work-assignment schedule
    #: measured AD's [3, 3] float32 cost-model coefficients, else None
    coeffs: Optional[np.ndarray] = None


def fused_kernel_name(cls) -> Optional[str]:
    """The fused kernel a strategy *class* lowers to, or ``None``; the
    class-level companion of :func:`_plan` (same precedence order)."""
    for klass, kernel in ((AdaptiveStrategy, "AD"),
                          (HierarchicalProcessing, "HP"),
                          (NodeSplitting, "NS"),
                          (EdgeBased, "EP"),
                          (WorkloadDecomposition, "WD"),
                          (NodeBased, "BS")):
        if isinstance(cls, type) and issubclass(cls, klass):
            return kernel
    return None


def _sched_of(strategy) -> Schedule:
    """The instance's resolved schedule (concrete MDT), else its declared
    one, else the default (third-party strategies that skip
    ``StrategyBase.__init__``)."""
    sched = getattr(strategy, "resolved_schedule", None)
    if sched is None:
        sched = getattr(strategy, "schedule", None)
    return sched if isinstance(sched, Schedule) else DEFAULT_SCHEDULE


def _plan(strategy, state, graph: CSRGraph) -> FusedPlan:
    """Map a set-up strategy instance to its fused lowering; raises
    ``ValueError`` for strategies without one."""
    kernel = fused_kernel_name(type(strategy))
    if kernel is None:
        raise ValueError(
            f"strategy {strategy.name!r} has no fused lowering; "
            f"use mode='stepped'")
    sched = _sched_of(strategy)
    if kernel == "NS":
        sg = strategy.split_info
        return FusedPlan("NS", sg.graph, sg.child_parent, sched)
    if kernel == "EP":
        if not strategy.chunked:
            # the unchunked per-edge push (duplicate worklist entries,
            # paper Fig. 11) has no dense equivalent: a dense mask is
            # deduplicated by construction
            raise ValueError(
                "EP with chunked=False has no fused lowering "
                "(dense frontiers are deduplicated by construction); "
                "use mode='stepped'")
        return FusedPlan("EP", graph, state.src, sched)
    model = getattr(strategy, "cost_model", None)
    if kernel == "AD" and model is not None:
        return FusedPlan("AD", graph, None, sched, model.coeff_array())
    return FusedPlan(kernel, graph, None, sched)


def run_fixed_point(graph: CSRGraph, state: Any, strategy, dist0, mask0, *,
                    op="shortest_path", max_iterations: int = 100000):
    """Run one strategy's whole traversal as a single fused launch (the
    plain loop for CPU tensors).  ``dist0``/``mask0`` are the initial
    values and frontier on the strategy's allocation (the split graph's
    for NS), on ``graph``'s device; callers own seeding and extraction.
    Returns ``(dist, iterations, edges_relaxed)``, ``dist`` on the
    device; for AD the tally of its choices is stored on the strategy as
    ``kernel_counts``, as the stepped driver does."""
    plan = _plan(strategy, state, graph)
    DISPATCH_COUNTS[plan.kernel] += 1
    dist, it, edges, chosen, _ = fused_kernel.fixed_point(
        plan.kernel, plan.graph, plan.aux, dist0, mask0,
        op=operators.resolve(op), sched=plan.sched,
        max_iterations=max_iterations, coeffs=plan.coeffs)
    if plan.kernel == "AD":
        strategy.kernel_counts = {
            name: c for name, c in zip(_AD_KERNEL_ORDER, chosen) if c}
    return dist, it, edges


# ---------------------------------------------------------------------------
# batched multi-source fixed point (K queries, one launch)
# ---------------------------------------------------------------------------

def _batch_fixed_point_plain(g: CSRGraph, dist_b, mask_b, *, op: EdgeOp,
                             max_iterations: int):
    """The batch's plain version: while any row's frontier is live and
    ``it < max_iterations``, :func:`_wd_step` on every row (the
    reference's ``vmap``); the edge total sums the rows.  Returns
    ``(dist [K, N], iterations, edges_relaxed)``."""
    it, edges = 0, 0
    while it < max_iterations and bool(mask_b.any()):
        steps = [_wd_step(g, d, m, op=op) for d, m in zip(dist_b, mask_b)]
        dist_b = torch.stack([d for d, _, _ in steps])
        mask_b = torch.stack([m for _, m, _ in steps])
        edges += sum(e for _, _, e in steps)
        it += 1
    return dist_b, it, edges


def run_batch_fixed_point(graph: CSRGraph, dist_b, mask_b, *,
                          op="shortest_path", max_iterations: int = 100000,
                          sched: Schedule = DEFAULT_SCHEDULE):
    """All K queries of ``dist_b``/``mask_b`` (``[K, N]``, on ``graph``'s
    device) to the batch's fixed point, a launch a row (the plain loop for
    CPU tensors), the counterpart of the reference's
    ``run_batch_fixed_point``.  Iterations count until every row's
    frontier is empty; the edge total sums the rows' masked degree sums.
    Returns ``(dist [K, N], iterations, edges_relaxed)``, ``dist`` on the
    device."""
    DISPATCH_COUNTS["batch"] += 1
    return fused_kernel.batch_fixed_point(
        graph, dist_b, mask_b, op=operators.resolve(op), sched=sched,
        max_iterations=max_iterations)
