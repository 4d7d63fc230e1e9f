"""Priority-ordered (delta-stepping) fixed points of the port (the
counterpart of :mod:`repro.core.priority`, ROADMAP A10).

The bulk-synchronous engine relaxes the whole frontier every iteration.
On high-diameter inputs (road networks) that spends one iteration per
hop.  Delta-stepping (Meyer & Sanders) partitions tentative values into
buckets of width Δ (:func:`repro_torch.core.worklist.bucket_index`) and
settles them in order.  One **epoch** settles the minimum live bucket:

1. the light closure: while some frontier node lies in bucket ``b`` (taken
   once at the epoch's start, each node's bucket recomputed from the
   current values every round), relax those nodes over the **light**
   edges (w ≤ Δ) and add the improved nodes to the frontier, since a
   light candidate can land back in ``b``;
2. the heavy pass: every node settled in the closure relaxes its
   **heavy** edges (w > Δ) once; their candidates land in later buckets
   (operators with ``weight_additive``).

``iterations`` counts epochs (what ``max_iterations`` caps, stepped and
fused alike); ``relax_rounds`` counts light passes plus heavy passes that
had edges.  When every edge is light the light graph aliases the graph
and the closure is BSP's loop: the same rounds, edges and values.  EP is
excluded (an edge worklist has no per-node value to bucket by), and so
are non-idempotent operators (reordering changes their fixed point).

Each phase is one of the dense steps of :mod:`repro_torch.core.fused`
(BS, WD, HP, NS, AD's fixed tree) over the light or the heavy graph, so
the chunk schedule and the bits are the reference's ``backend="xla"``:

* :func:`run_fixed_point`: the whole traversal as ONE launch of the fused
  kernel (``csrc/fused.cu``) in its delta mode on the card, the plain
  epoch loop :func:`_delta_fixed_point_plain` on the CPU, which also
  counts the kernel's split of rounds between the grid and one block
  (:func:`repro_torch.core.fused.delta_round_split`);
* :func:`step_epoch`: one epoch a call, the same launch capped at one
  epoch on the card (it also returns the frontier, the settled bucket,
  the rounds and the frontier's count, read with one sync);
* :func:`run_batch_fixed_point`: K WD traversals, each row its own bucket
  sequence: one single-row launch a row on the card, the plain loop a row
  on the CPU; epochs and rounds are the rows' maximum, edges their sum.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import fused, operators, worklist
from repro_torch.core.graph import CSRGraph
from repro_torch.core.operators import EdgeOp
from repro_torch.core.schedule import Schedule
from repro_torch.core.strategies import PRIORITY_SCHEDULE
from repro_torch.kernels import fused as fused_kernel

#: Δ = multiplier × mean edge weight when the caller passes none (the
#: per-run knob is ``Schedule.delta_multiplier``; this is its default)
DELTA_WEIGHT_MULTIPLIER = 4


def auto_delta(graph: CSRGraph,
               multiplier: int = DELTA_WEIGHT_MULTIPLIER) -> int:
    """Default bucket width: ``round(multiplier × mean(w))``, at least 1
    (the mean in float64 on the host, as the reference computes it).
    Unweighted graphs take the bare multiplier."""
    multiplier = max(1, int(multiplier))
    if graph.wt is None or graph.num_edges == 0:
        return multiplier
    mean = float(graph.wt.cpu().numpy().mean())
    return max(1, int(round(multiplier * mean)))


def _edge_subgraph(g: CSRGraph, keep: np.ndarray) -> CSRGraph:
    """The CSR of the kept edges, in their order, on ``g``'s device."""
    rp = g.row_ptr.cpu().numpy().astype(np.int64)
    kept_before = np.concatenate([[0], np.cumsum(keep, dtype=np.int64)])
    row_ptr = kept_before[rp].astype(np.int32)
    col = g.col.cpu().numpy()[keep]
    wt = None if g.wt is None else g.wt.cpu().numpy()[keep]
    return CSRGraph.from_arrays(row_ptr, col, wt, device=g.device)


@dataclasses.dataclass
class DeltaPlan:
    """One strategy lowered to delta-stepping phases."""
    kernel: str                     # BS | WD | HP | NS | AD
    light: CSRGraph                 # w ≤ Δ edges (the graph itself when
                                    # nothing is heavy)
    heavy_graph: Optional[CSRGraph]  # w > Δ edges; None when none exist
    aux: Optional[torch.Tensor]     # NS child -> parent map
    sched: Schedule                 # the resolved work-assignment schedule
    delta: int

    @property
    def heavy(self) -> bool:
        return self.heavy_graph is not None

    def device_bytes(self) -> int:
        total = self.light.device_bytes()
        if self.heavy_graph is not None:
            total += self.heavy_graph.device_bytes()
        if self.aux is not None:
            total += self.aux.numel() * self.aux.element_size()
        return total


def plan_delta(strategy, state, graph: CSRGraph, *,
               op=operators.shortest_path,
               delta: Optional[int] = None) -> DeltaPlan:
    """Lower a set-up strategy to its delta-stepping plan: the fused
    lowering's kernel, phase graph (NS: the split graph) and schedule
    (:func:`repro_torch.core.fused._plan`), that graph's edges split at
    Δ.  Δ is ``delta``, else ``Schedule.delta``, else :func:`auto_delta`
    with ``Schedule.delta_multiplier``.  An operator without
    ``weight_additive`` gets an all-light split.  Measured AD's cost
    model is dropped: delta phases take AD's fixed tree."""
    op = operators.resolve(op)
    if PRIORITY_SCHEDULE not in type(strategy).capabilities:
        raise ValueError(
            f"strategy {strategy.name!r} does not declare the "
            f"{PRIORITY_SCHEDULE!r} capability")
    if not op.idempotent:
        raise ValueError(
            f"schedule='delta' reorders relaxations, which changes the "
            f"fixed point of non-idempotent operators; op {op.name!r} "
            f"has combine={op.combine!r}")
    fplan = fused._plan(strategy, state, graph)
    g, sched = fplan.graph, fplan.sched
    if delta is None:
        delta = (sched.delta if sched.delta is not None
                 else auto_delta(graph, sched.delta_multiplier))
    delta = int(delta)
    if delta < 1:
        raise ValueError(f"delta must be >= 1, got {delta}")
    if op.weight_additive and g.wt is not None and g.num_edges:
        light = g.wt.cpu().numpy() <= delta
    else:
        light = np.ones(int(g.num_edges), bool)
    if light.all():
        gl, gh = g, None               # alias: BSP's loop, bit for bit
    else:
        gl, gh = _edge_subgraph(g, light), _edge_subgraph(g, ~light)
    return DeltaPlan(fplan.kernel, gl, gh, fplan.aux, sched, delta)


# ---------------------------------------------------------------------------
# the plain version: phases and epochs over the dense steps
# ---------------------------------------------------------------------------

def _ad_phase(g, aux, dist, cur, *, op, sched):
    dist, updated, edges, _idx = fused._ad_step(g, dist, cur, sched=sched,
                                                op=op)
    return dist, updated, edges


#: fused kernel -> its dense step under :func:`_phase`, each as
#: ``(g, aux, dist, cur, *, op, sched) -> (dist, updated, edges)`` (EP's
#: edge worklist has no per-node value to bucket by); the capability
#: pass holds ``PRIORITY_SCHEDULE`` declarations to its keys
DELTA_STEPS = {
    "BS": lambda g, aux, dist, cur, *, op, sched:
        fused._bs_step(g, dist, cur, op=op),
    "WD": lambda g, aux, dist, cur, *, op, sched:
        fused._wd_step(g, dist, cur, op=op),
    "HP": lambda g, aux, dist, cur, *, op, sched:
        fused._hp_step(g, dist, cur, sched=sched, op=op),
    "NS": lambda g, aux, dist, cur, *, op, sched:
        fused._ns_step(g, aux, dist, cur, op=op),
    "AD": _ad_phase,
}


def _phase(g: CSRGraph, aux, dist, cur, *, kernel: str, op: EdgeOp,
           sched: Schedule):
    """One dense relax of the frontier ``cur`` over ``g``'s edges with the
    strategy's step.  Returns ``(dist, updated, edges)``; an edgeless
    ``g`` relaxes nothing (not even NS's gather)."""
    if kernel not in DELTA_STEPS:
        raise ValueError(f"kernel {kernel!r} has no delta-stepping phase")
    if g.num_edges == 0:
        return dist, torch.zeros_like(cur), 0
    return DELTA_STEPS[kernel](g, aux, dist, cur, op=op, sched=sched)


def _epoch(gl: CSRGraph, gh: Optional[CSRGraph], aux, dist, mask,
           delta: int, *, kernel: str, op: EdgeOp, sched: Schedule,
           trail: list):
    """Settle the minimum live bucket: the light closure, then one heavy
    pass.  Appends each relax round's ``(nodes, edges)`` to ``trail``,
    its nodes as a 0-d tensor (read once, after the traversal).
    Returns ``(dist, mask, bucket, rounds, edges)``."""
    descending = op.combine == "max"

    def in_bucket(dist, mask, b):
        return mask & (worklist.bucket_index(
            dist, delta, descending=descending) == b)

    b = worklist.min_live_bucket(
        mask, worklist.bucket_index(dist, delta, descending=descending))
    settled = torch.zeros_like(mask)
    rounds, edges = 0, 0
    while True:
        cur = in_bucket(dist, mask, b)
        if not bool(cur.any()):
            break
        settled = settled | cur
        mask = mask & ~cur
        dist, upd, e = _phase(gl, aux, dist, cur, kernel=kernel, op=op,
                              sched=sched)
        mask = mask | upd        # light candidates may land back in b
        rounds += 1
        edges += e
        trail.append((cur.sum(), e))
    if gh is not None:
        dist, upd, e = _phase(gh, aux, dist, settled, kernel=kernel, op=op,
                              sched=sched)
        mask = mask | upd
        rounds += int(e > 0)
        edges += e
        if e > 0:
            trail.append((settled.sum(), e))
    return dist, mask, b, rounds, edges


def _delta_fixed_point_plain(kernel: str, gl: CSRGraph,
                             gh: Optional[CSRGraph], aux, dist, mask, *,
                             delta: int, op: EdgeOp, sched: Schedule,
                             max_iterations: int):
    """The fused kernel's delta mode in plain PyTorch: epochs while the
    frontier is live and ``it < max_iterations``.  Returns ``(dist, mask,
    epochs, rounds, edges, last bucket settled, frontier count,
    Rounds)``: the kernel's counts, but for its barriers."""
    it, rounds, edges, b = 0, 0, 0, worklist.NO_BUCKET
    trail = []
    while it < max_iterations and bool(mask.any()):
        dist, mask, b, r, e = _epoch(gl, gh, aux, dist, mask, delta,
                                     kernel=kernel, op=op, sched=sched,
                                     trail=trail)
        it += 1
        rounds += r
        edges += e
    nodes = torch.stack([n for n, _ in trail]).tolist() if trail else []
    trail = [(n, e) for n, (_, e) in zip(nodes, trail)]
    return (dist, mask, it, rounds, edges, b, int(mask.sum()),
            fused_kernel.Rounds(*fused.delta_round_split(kernel, trail),
                                nodes=sum(nodes)))


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def _launch(plan: DeltaPlan, dist, mask, *, op: EdgeOp,
            max_iterations: int):
    return fused_kernel.delta_fixed_point(
        plan.kernel, plan.light, plan.heavy_graph, plan.aux, dist, mask,
        op=op, sched=plan.sched, delta=plan.delta,
        max_iterations=max_iterations)


def step_epoch(plan: DeltaPlan, dist, mask, *,
               op=operators.shortest_path):
    """One bucket epoch (stepped mode): on the card one launch of the
    fused kernel capped at one epoch.  Returns ``(dist, mask, bucket,
    rounds, edges, count, Rounds)``, the tensors on the device and the
    counters (``count``: the next frontier's size) on the host."""
    dist, mask, _, rounds, edges, b, count, split = _launch(
        plan, dist, mask, op=operators.resolve(op), max_iterations=1)
    return dist, mask, b, rounds, edges, count, split


def run_fixed_point(plan: DeltaPlan, dist0, mask0, *,
                    op=operators.shortest_path,
                    max_iterations: int = 100000):
    """The whole delta-stepping traversal as one launch (the plain loop
    for CPU tensors).  Returns ``(dist, epochs, relax_rounds,
    edges_relaxed, Rounds)``, ``dist`` on the device."""
    fused.DISPATCH_COUNTS[f"delta:{plan.kernel}"] += 1
    dist, _, it, rounds, edges, _, _, split = _launch(
        plan, dist0, mask0, op=operators.resolve(op),
        max_iterations=max_iterations)
    return dist, it, rounds, edges, split


def run_batch_fixed_point(plan: DeltaPlan, dist_b, mask_b, *,
                          op=operators.shortest_path,
                          max_iterations: int = 100000):
    """K queries (``[K, N]``) each to its delta fixed point with WD
    phases, every row its own bucket sequence: one single-row launch a
    row on the card, the plain loop a row on the CPU.  Returns ``(dist_b,
    epochs, relax_rounds, edges)``: epochs and rounds of the slowest row,
    edges summed."""
    if plan.kernel != "WD":
        raise ValueError(
            f"batched delta-stepping runs WD phases; got {plan.kernel!r}")
    op = operators.resolve(op)
    fused.DISPATCH_COUNTS["delta:batch"] += 1
    rows, epochs, rounds, edges = [], 0, 0, 0
    for dist, mask in zip(dist_b, mask_b):
        d, _, it, r, e, *_ = _launch(plan, dist.contiguous(),
                                       mask.contiguous(), op=op,
                                       max_iterations=max_iterations)
        rows.append(d)
        epochs, rounds, edges = max(epochs, it), max(rounds, r), edges + e
    out = torch.stack(rows) if rows else dist_b.clone()
    return out, epochs, rounds, edges
