"""Sharded fixed points of the port (ROADMAP A11; the counterpart of
:mod:`repro.core.shard`).

The paper's edge-based balancing is "unsuitable for large graphs"
because of its memory (§I); at that scale the graph is partitioned over
devices.  This module adds the reference's 1-D **node partition** and
runs the fused strategies over it:

* :func:`partition` splits a :class:`~repro_torch.core.graph.CSRGraph`
  into ``S`` contiguous node ranges (``method="degree"`` balances edges
  a shard, ``"contiguous"`` node counts) and builds one local CSR a
  shard on the host, padded to the widest shard, with **global**
  destination ids, plus the halo bookkeeping :class:`ShardInfo`;
* :class:`ShardGroup` says which shards this process holds, on which
  device, and across which ``torch.distributed`` processes the rest
  live.  Only the held shards' slices go to that device, so a rank
  holding one shard of a graph keeps one shard's edges there.  Without an initialised process group one process holds all
  ``S`` shards on one device (the CPU tests, one card); with one, each
  rank holds the shard of its rank.  Its four collectives
  (:meth:`ShardGroup.fold`, :meth:`~ShardGroup.any_across`,
  :meth:`~ShardGroup.max_across`, :meth:`~ShardGroup.sum_across`) take
  the reference's ``lax.pmin``/``pmax``/``psum``: a fold over the held
  shards, then an ``all_reduce`` across ranks;
* :func:`run_fixed_point` runs one planned traversal.  **Lockstep** (the
  default): every held shard relaxes its own edges against one
  replicated ``[N]`` value array, each into a proposal (B2
  ``relax.relax_lanes`` for a BS/NS column or an HP tile, B1
  ``relax.wd_relax_lanes`` for a WD merge path or HP's tail: on the card
  the hand-written kernels, on the CPU their plain versions), and the
  proposals are folded across shards before ONE ``apply_proposal`` at
  every chunk boundary the single-device kernels have: each BS/NS
  column, each HP tile plus the WD tail, once a WD iteration.  Every
  global decision (BS's column count, HP's branch and tile trip count,
  the next frontier) comes from a fold, so every deployment runs the same
  chunks and ``(dist, iterations, edges_relaxed)`` equal the
  single-device fused run bit for bit.  **Async** (``async_mode=True``,
  idempotent operators): each held shard drains its owned frontier to a
  local fixed point on a replica of its own, with local decisions and no
  fold, then one fold an epoch; nodes the fold improved are the next
  frontier.  Values are exact; epochs and rounds are their own.
* :func:`run_batch_fixed_point`: K sources, the sharded WD step on each
  row whose frontier is live, one B1 launch a row and held shard an
  iteration.

No kernel is new here: the fold between shards lies outside every relax
kernel in the reference too (``_combine_proposal``), so it is
``torch.minimum``/``maximum``/``add`` over the held shards and
``all_reduce`` across ranks.  ``edges_relaxed`` counts each edge once:
every shard sums the masked degrees of the nodes it owns, and the sums
are folded once after the loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.core import operators
from repro_torch.core.fused import DISPATCH_COUNTS, _plan
from repro_torch.core.graph import CSRGraph, resolve_device
from repro_torch.core.operators import EdgeOp
from repro_torch.core.schedule import Schedule
from repro_torch.kernels import relax

#: partition methods understood by :func:`partition`
PARTITION_METHODS = ("degree", "contiguous")


# ---------------------------------------------------------------------------
# host-side partitioner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedCSRGraph:
    """1-D node-partitioned CSR: per-shard local CSRs stacked on axis 0.

    Shard ``s`` owns the global nodes ``[node_base[s], node_base[s] +
    num_local[s])`` and keeps their out-edges as a local CSR
    (``row_ptr[s]`` indexes ``col[s]``/``wt[s]``; destinations stay
    global ids, because the value array is replicated).  Every shard is
    padded to the widest (``nodes_per_shard``, ``edges_per_shard``):
    padded rows have no edges, padded edge slots are never valid."""

    row_ptr: torch.Tensor         # [S, Nmax+1] int32, local offsets
    col: torch.Tensor             # [S, Emax]   int32, global dst ids
    wt: Optional[torch.Tensor]    # [S, Emax]   int32 (None: unweighted)
    node_base: torch.Tensor       # [S] int32, first global node owned
    num_local: torch.Tensor       # [S] int32, owned node count
    num_nodes: int
    num_edges: int
    num_shards: int
    nodes_per_shard: int          # Nmax
    edges_per_shard: int          # Emax

    def device_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.row_ptr, self.col, self.wt,
                             self.node_base, self.num_local)
                   if t is not None)


@dataclasses.dataclass
class ShardInfo:
    """Host-side partition bookkeeping: balance and halo maps.

    ``ghosts[s]`` holds the global ids of the non-owned destinations of
    shard ``s``'s edges: the values it reads that another shard
    produces.  The fold moves whole ``[N]`` proposals, so these maps are
    what a sparse ghost exchange would move instead."""

    boundaries: np.ndarray    # [S+1] node-range boundaries
    method: str
    nodes: np.ndarray         # [S] owned node counts
    edges: np.ndarray         # [S] owned edge counts
    ghosts: list              # [S] arrays of ghost (non-owned dst) ids
    cut_edges: np.ndarray     # [S] owned edges whose dst is not owned

    @property
    def num_shards(self) -> int:
        return len(self.nodes)

    @property
    def cut_share(self) -> float:
        """The share of all edges that cross a shard boundary."""
        total = int(self.edges.sum())
        if total == 0:
            return 0.0
        return float(self.cut_edges.sum() / total)

    @property
    def halo_total(self) -> int:
        """Ghost entries summed over shards (one exchange's volume)."""
        return int(sum(len(g) for g in self.ghosts))

    @property
    def halo_bytes(self) -> int:
        """int32 bytes a sparse ghost exchange would move a fold."""
        return 4 * self.halo_total

    @property
    def edge_imbalance(self) -> float:
        """Most owned edges over the mean; 1.0 is perfectly balanced."""
        if self.edges.size == 0 or self.edges.sum() == 0:
            return 1.0
        return float(self.edges.max() / self.edges.mean())


def partition_boundaries(graph: CSRGraph, num_shards: int,
                         method: str = "degree") -> np.ndarray:
    """Contiguous node-range boundaries ``[S+1]``: ``"degree"`` cuts the
    degree prefix sum at multiples of ``E/S`` (edge-balanced shards, the
    default for power-law graphs), ``"contiguous"`` splits node ids
    evenly."""
    if method not in PARTITION_METHODS:
        raise ValueError(f"partition method must be one of "
                         f"{PARTITION_METHODS}, got {method!r}")
    n = graph.num_nodes
    if method == "contiguous":
        bounds = np.round(np.linspace(0, n, num_shards + 1)).astype(np.int64)
    else:
        csum = np.cumsum(graph.degrees.cpu().numpy().astype(np.int64))
        targets = np.arange(1, num_shards) * (graph.num_edges / num_shards)
        # +1: the node whose running degree crosses a target belongs to
        # the LEFT shard; cutting before it would let a hub at node 0
        # with degree >= E/S move every cut to 0
        cuts = np.searchsorted(csum, targets, side="left") + 1
        bounds = np.concatenate(([0], cuts, [n])).astype(np.int64)
    return np.maximum.accumulate(np.clip(bounds, 0, n))


def partition(graph: CSRGraph, num_shards: int, *,
              method: str = "degree") -> tuple[ShardedCSRGraph, ShardInfo]:
    """Split ``graph`` into ``num_shards`` local CSRs (a host numpy
    morph, like :mod:`repro_torch.core.node_split`), stacked on the host
    (:meth:`ShardGroup.hold` moves the held ones to their device), and
    the host-side :class:`ShardInfo`."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    bounds = partition_boundaries(graph, num_shards, method)
    rp = graph.row_ptr.cpu().numpy().astype(np.int64)
    col = graph.col.cpu().numpy()
    wt = None if graph.wt is None else graph.wt.cpu().numpy()

    counts = np.diff(bounds)
    e_counts = rp[bounds[1:]] - rp[bounds[:-1]]
    n_max = max(int(counts.max()), 1) if counts.size else 1
    e_max = max(int(e_counts.max()), 1) if e_counts.size else 1

    row_ptr_s = np.zeros((num_shards, n_max + 1), np.int32)
    col_s = np.zeros((num_shards, e_max), np.int32)
    wt_s = None if wt is None else np.zeros((num_shards, e_max), np.int32)
    ghosts = []
    cut = np.zeros(num_shards, np.int64)
    for s in range(num_shards):
        b0, b1 = int(bounds[s]), int(bounds[s + 1])
        local_rp = rp[b0:b1 + 1] - rp[b0]
        row_ptr_s[s, : b1 - b0 + 1] = local_rp
        row_ptr_s[s, b1 - b0 + 1:] = local_rp[-1]     # padded rows: empty
        e0, e1 = int(rp[b0]), int(rp[b1])
        col_s[s, : e1 - e0] = col[e0:e1]
        if wt is not None:
            wt_s[s, : e1 - e0] = wt[e0:e1]
        crossing = (col[e0:e1] < b0) | (col[e0:e1] >= b1)
        cut[s] = int(crossing.sum())
        ghosts.append(np.unique(col[e0:e1][crossing]))

    def host(a):
        return None if a is None else torch.from_numpy(a)

    sharded = ShardedCSRGraph(
        row_ptr=host(row_ptr_s), col=host(col_s), wt=host(wt_s),
        node_base=host(bounds[:-1].astype(np.int32)),
        num_local=host(counts.astype(np.int32)),
        num_nodes=graph.num_nodes, num_edges=graph.num_edges,
        num_shards=num_shards, nodes_per_shard=n_max,
        edges_per_shard=e_max)
    info = ShardInfo(boundaries=bounds, method=method,
                     nodes=counts.astype(np.int64),
                     edges=e_counts.astype(np.int64), ghosts=ghosts,
                     cut_edges=cut)
    return sharded, info


# ---------------------------------------------------------------------------
# the group: which shards this process holds, and the folds across them
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LocalShard:
    """One held shard on the group's device, with what every step reads:
    its lanes' global ids (clamped into ``[0, N)``, as the reference's)
    and their degrees, zero on padded lanes."""

    row_ptr: torch.Tensor          # [Nmax+1]
    col: torch.Tensor              # [Emax]
    wt: Optional[torch.Tensor]     # [Emax]
    gids: torch.Tensor             # [Nmax] int32
    lane_owned: torch.Tensor       # [Nmax] bool, False on padded lanes
    degree: torch.Tensor           # [Nmax] int32
    base: int
    count: int
    edges_per_shard: int

    def owned(self, n: int) -> torch.Tensor:
        """``[n]`` bool: the nodes this shard owns."""
        ids = torch.arange(n, device=self.gids.device)
        return (ids >= self.base) & (ids < self.base + self.count)


_REDUCE_OPS = {"min": "MIN", "max": "MAX", "add": "SUM"}


@dataclasses.dataclass
class ShardGroup:
    """The ``S`` shards of a run as this process sees them: ``held``
    (all ``S`` without a ``process_group``, else this rank's one) on
    ``device``, the rest on the other ranks of ``process_group``."""

    num_shards: int
    device: torch.device
    held: tuple
    process_group: Optional[object] = None

    def __post_init__(self):
        want = (1 if self.process_group is not None else self.num_shards)
        if len(self.held) != want:
            raise ValueError(
                f"a group of {self.num_shards} shards holds "
                f"{'one shard a rank' if want == 1 else 'every shard'}, "
                f"got {self.held}")

    def hold(self, sharded: ShardedCSRGraph) -> list:
        """The held shards of ``sharded`` as :class:`LocalShard` s on this
        group's device: copies of their slices alone, never views into
        the stack."""
        if sharded.num_shards != self.num_shards:
            raise ValueError(f"{sharded.num_shards} shards in the graph, "
                             f"{self.num_shards} in the group")
        out = []
        for s in self.held:
            row_ptr = sharded.row_ptr[s].to(self.device, copy=True)
            base = int(sharded.node_base[s])
            count = int(sharded.num_local[s])
            lanes = torch.arange(sharded.nodes_per_shard, dtype=torch.int32,
                                 device=self.device)
            lane_owned = lanes < count
            out.append(LocalShard(
                row_ptr=row_ptr,
                col=sharded.col[s].to(self.device, copy=True),
                wt=None if sharded.wt is None else sharded.wt[s].to(
                    self.device, copy=True),
                gids=(base + lanes).clamp_(0, max(sharded.num_nodes - 1, 0)),
                lane_owned=lane_owned,
                degree=torch.where(lane_owned, row_ptr[1:] - row_ptr[:-1], 0),
                base=base, count=count,
                edges_per_shard=sharded.edges_per_shard))
        return out

    def all_reduce(self, t: torch.Tensor, combine: str) -> torch.Tensor:
        """``t`` folded in place across ranks with ``combine`` (min, max,
        add); itself without a process group."""
        if self.process_group is not None:
            tdist.all_reduce(t, getattr(tdist.ReduceOp,
                                        _REDUCE_OPS[combine]),
                             group=self.process_group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (one shape on every rank) concatenated along
        axis 0 in rank order; ``t`` itself without a process group."""
        if self.process_group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(
            tdist.get_world_size(self.process_group))]
        tdist.all_gather(parts, t.contiguous(), group=self.process_group)
        return torch.cat(parts)

    def fold(self, op: EdgeOp, proposals: list) -> torch.Tensor:
        """The monoid fold of the held shards' ``[N]`` proposals, then
        across ranks: the reference's ``_combine_proposal``.  Exact for
        every built-in combine, since a proposal holds the identity where
        it proposes nothing."""
        out = proposals[0]
        for p in proposals[1:]:
            out = relax.apply_proposal(out, p, op)
        if self.process_group is not None:
            out = self.all_reduce(
                out.clone() if len(proposals) == 1 else out, op.combine)
        return out

    def any_across(self, mask: torch.Tensor) -> torch.Tensor:
        """OR of a bool mask across ranks (in place across ranks; the
        held shards have OR-ed theirs already)."""
        if self.process_group is not None:
            self.all_reduce(mask.view(torch.uint8), "max")
        return mask

    def _scalar(self, x: int, combine: str) -> int:
        if self.process_group is None:
            return int(x)
        t = torch.tensor([int(x)], dtype=torch.int64, device=self.device)
        return int(self.all_reduce(t, combine).item())

    def max_across(self, x: int) -> int:
        return self._scalar(x, "max")

    def sum_across(self, x: int) -> int:
        return self._scalar(x, "add")

    def all_to_all(self, sends: list) -> list:
        """Each held shard's ``[S, cap]`` send buffer (row ``p`` for shard
        ``p``) -> its ``[S, cap]`` receive buffer (row ``p`` from shard
        ``p``): a transpose among held shards, ``all_to_all_single``
        across ranks."""
        if self.process_group is None:
            return list(torch.stack(sends).transpose(0, 1).contiguous())
        out = torch.empty_like(sends[0])
        tdist.all_to_all_single(out, sends[0].contiguous(),
                                group=self.process_group)
        return [out]


def shard_group(num_shards: int, device="cuda") -> ShardGroup:
    """The group of a ``num_shards``-shard run (the counterpart of the
    reference's ``shard_mesh``).  Without an initialised
    ``torch.distributed`` this process holds every shard on ``device``;
    with one of world size ``W``, ``num_shards`` must equal ``W`` and this
    rank holds the shard of its rank (``device`` is that rank's:
    ``"cuda"`` is the current device, which the rank sets with
    ``torch.cuda.set_device``).  A ``ShardGroup`` built by hand may name
    another process group."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    dev = resolve_device(device)
    if not (tdist.is_available() and tdist.is_initialized()):
        return ShardGroup(num_shards, dev, tuple(range(num_shards)))
    world = tdist.get_world_size()
    if num_shards != world:
        raise ValueError(
            f"{num_shards} shards need {num_shards} ranks, one a shard, "
            f"but the torch.distributed group has {world}; run "
            f"shards={world}, or without torch.distributed to hold every "
            f"shard in one process")
    return ShardGroup(num_shards, dev, (tdist.get_rank(),),
                      tdist.group.WORLD)


# ---------------------------------------------------------------------------
# per-shard dense steps: (held shards, group, replicated dist [N], mask
# [N]; aux, sched, op) -> (dist, next frontier [N], owned-degree sum).
# ``sync=False`` (async mode, one held shard) takes local decisions and
# skips every fold.
# ---------------------------------------------------------------------------

def _local_frontier(sh: LocalShard, mask) -> torch.Tensor:
    """Masked degrees of this shard's owned slice of the frontier."""
    return torch.where(mask[sh.gids], sh.degree, 0)


def _weight(sh: LocalShard, eidx) -> torch.Tensor:
    return torch.ones_like(eidx) if sh.wt is None else sh.wt[eidx]


def _edge_sum(degs: list) -> torch.Tensor:
    return torch.stack([d.sum(dtype=torch.int64) for d in degs]).sum()


def _apply(group: ShardGroup, op: EdgeOp, dist, props: list, sync: bool):
    """The chunk boundary: fold the held shards' proposals (lockstep),
    then one elementwise ``apply_proposal``."""
    prop = group.fold(op, props) if sync else props[0]
    return relax.apply_proposal(dist, prop, op)


def _merge_path_chunk(shards, group, dist, updated, works, cursor: int, *,
                      op: EdgeOp, sync: bool):
    """One merge-path relax of each held shard over its ``Emax`` edge
    lanes (B1: shard ``s``'s slot ``i`` has ``works[s][i]`` edges from
    ``row_ptr[i] + cursor``), and the chunk's fold; sets ``updated`` in
    place."""
    props = []
    for sh, work in zip(shards, works):
        prefix = torch.cumsum(work, 0, dtype=torch.int32)
        start = sh.row_ptr[:-1] + cursor
        prop, upd, _ = relax.wd_relax_lanes(
            dist, prefix, prefix - work, start, sh.gids, sh.col, sh.wt,
            cap_work=sh.edges_per_shard, op=op)
        updated |= upd
        props.append(prop)
    return _apply(group, op, dist, props, sync)


def _bs_step(shards, group, dist, mask, *, aux=None, sched=None,
             op: EdgeOp, sync: bool = True):
    """Sharded dense BS: column ``d`` relaxes the ``d``-th edge of every
    owned frontier node (B2), for the global frontier's max degree
    columns, each folded before the next reads ``dist``."""
    degs = [_local_frontier(sh, mask) for sh in shards]
    columns = int(torch.stack([d.max() for d in degs]).max())
    if sync:
        columns = group.max_across(columns)
    updated = torch.zeros_like(mask)
    for d in range(columns):
        props = []
        for sh, deg in zip(shards, degs):
            eidx = (sh.row_ptr[:-1] + d).clamp_(0, sh.edges_per_shard - 1)
            prop, upd, _ = relax.relax_lanes(
                dist, sh.gids, sh.col[eidx], _weight(sh, eidx), d < deg,
                op=op)
            updated |= upd
            props.append(prop)
        dist = _apply(group, op, dist, props, sync)
    return dist, updated, _edge_sum(degs)


def _wd_step(shards, group, dist, mask, *, aux=None, sched=None,
             op: EdgeOp, sync: bool = True):
    """Sharded dense WD: one merge path a shard, one fold an iteration."""
    degs = [_local_frontier(sh, mask) for sh in shards]
    updated = torch.zeros_like(mask)
    dist = _merge_path_chunk(shards, group, dist, updated, degs, 0, op=op,
                             sync=sync)
    return dist, updated, _edge_sum(degs)


def _hp_step(shards, group, dist, mask, *, aux=None, sched: Schedule,
             op: EdgeOp, sync: bool = True):
    """Sharded dense HP: the branch and the tile loop's trip count come
    from global counts; a fold a ``[Nmax, MDT]`` tile (B2) while more
    than ``switch_threshold`` owned nodes have edges past the cursor
    (at least one tile), then one for the cursor-aware WD tail (B1)."""
    mdt = sched.mdt or 1
    degs = [_local_frontier(sh, mask) for sh in shards]
    count = int(torch.stack([(mask[sh.gids] & sh.lane_owned).sum()
                             for sh in shards]).sum())
    if sync:
        count = group.sum_across(count)
    updated = torch.zeros_like(mask)
    if count <= sched.switch_threshold:
        dist = _merge_path_chunk(shards, group, dist, updated, degs, 0,
                                 op=op, sync=sync)
        return dist, updated, _edge_sum(degs)
    j = torch.arange(mdt, dtype=torch.int32, device=dist.device)[None, :]
    cursor = 0
    while True:
        props = []
        for sh, deg in zip(shards, degs):
            pos = cursor + j                                    # [1, mdt]
            valid = (pos < deg[:, None]).reshape(-1)
            eidx = (sh.row_ptr[:-1, None] + pos).clamp_(
                0, sh.edges_per_shard - 1).reshape(-1)
            src = sh.gids[:, None].expand(-1, mdt).reshape(-1)
            prop, upd, _ = relax.relax_lanes(
                dist, src, sh.col[eidx], _weight(sh, eidx), valid, op=op)
            updated |= upd
            props.append(prop)
        dist = _apply(group, op, dist, props, sync)
        cursor += mdt
        alive = int(torch.stack([(d > cursor).sum() for d in degs]).sum())
        if sync:
            alive = group.sum_across(alive)
        if alive <= sched.switch_threshold:
            break
    rems = [(d - cursor).clamp_(min=0) for d in degs]
    dist = _merge_path_chunk(shards, group, dist, updated, rems, cursor,
                             op=op, sync=sync)
    return dist, updated, _edge_sum(degs)


def _ns_step(shards, group, dist, mask, *, aux, sched=None, op: EdgeOp,
             sync: bool = True):
    """Sharded dense NS: mirror every parent onto its children (``aux``,
    the child -> parent map; a gather on the replicated arrays, the same
    on every shard), then sharded BS on the split graph."""
    dist = dist[aux]
    mask = mask | mask[aux]
    return _bs_step(shards, group, dist, mask, op=op, sync=sync)


#: fused kernel -> step of its sharded lowering (EP's COO worklist and
#: AD's global frontier statistics stay on one device)
SHARDED_STEPS = {"BS": _bs_step, "WD": _wd_step, "HP": _hp_step,
                 "NS": _ns_step}


# ---------------------------------------------------------------------------
# planned traversals
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedPlan:
    """How to run one strategy's traversal across shards."""
    kernel: str
    sharded: ShardedCSRGraph
    info: ShardInfo
    aux: Optional[torch.Tensor]     # NS child -> parent map
    sched: Schedule                 # the resolved work-assignment schedule
    group: ShardGroup
    local: list                     # the held shards (LocalShard)


def plan_shards(strategy, state, graph: CSRGraph, num_shards: int, *,
                method: str = "degree",
                group: Optional[ShardGroup] = None) -> ShardedPlan:
    """Map a set-up strategy to its sharded lowering and partition (host
    work the engine books as setup).  ``group`` defaults to
    :func:`shard_group` on the graph's device.  Raises ``ValueError`` for
    a kernel without a sharded lowering (EP, AD)."""
    plan = _plan(strategy, state, graph)
    if plan.kernel not in SHARDED_STEPS:
        raise ValueError(
            f"fused kernel {plan.kernel!r} has no sharded lowering; "
            f"shardable kernels: {tuple(SHARDED_STEPS)} (EP's COO worklist "
            f"and AD's global frontier statistics stay on one device)")
    if group is None:
        group = shard_group(num_shards, graph.device)
    sharded, info = partition(plan.graph, num_shards, method=method)
    aux = None if plan.aux is None else plan.aux.to(group.device)
    return ShardedPlan(plan.kernel, sharded, info, aux, plan.sched, group,
                       group.hold(sharded))


def _lockstep(splan: ShardedPlan, dist, mask, *, op: EdgeOp,
              max_iterations: int):
    group, step = splan.group, SHARDED_STEPS[splan.kernel]
    it = 0
    edges = torch.zeros((), dtype=torch.int64, device=dist.device)
    # the frontier is replicated: every rank takes the same branch
    while it < max_iterations and bool(mask.any()):
        dist, upd, e = step(splan.local, group, dist, mask, aux=splan.aux,
                            sched=splan.sched, op=op)
        edges += e
        mask = group.any_across(upd)
        it += 1
    return dist, it, group.sum_across(int(edges)), it


def _async(splan: ShardedPlan, dist, mask, *, op: EdgeOp,
           max_iterations: int):
    """Shards run ahead between folds: each held shard drains its owned
    frontier to a local fixed point on its own replica (local decisions,
    no fold; the trip count is the shard's own), then the replicas are
    folded once and each shard's next frontier is the nodes the fold
    improved on its replica.  Stale ghost reads are safe for idempotent
    monotone monoids (the engine admits only those).  ``max_iterations``
    caps epochs.  Returns ``(dist, epochs, edges, rounds)``, ``rounds``
    the deepest shard's summed local rounds."""
    group, step, n = splan.group, SHARDED_STEPS[splan.kernel], dist.numel()
    owned = [sh.owned(n) for sh in splan.local]

    def eff(m):
        # NS: a live parent activates its children, which may live on
        # another shard
        return (m | m[splan.aux]) if splan.kernel == "NS" else m

    masks = [mask] * len(splan.local)
    rounds = [0] * len(splan.local)
    edges = torch.zeros((), dtype=torch.int64, device=dist.device)
    it = 0
    live = bool(mask.any())
    while live and it < max_iterations:
        replicas = []
        for s, sh in enumerate(splan.local):
            d, m = dist, masks[s]
            while bool((eff(m) & owned[s]).any()):
                d, m, e = step([sh], group, d, eff(m), aux=splan.aux,
                               sched=splan.sched, op=op, sync=False)
                edges += e
                rounds[s] += 1
            replicas.append(d)
        dist = group.fold(op, replicas)          # the epoch's one fold
        masks = [op.improves(dist, d) for d in replicas]
        live = bool(group.max_across(int(any(bool(m.any())
                                               for m in masks))))
        it += 1
    return (dist, it, group.sum_across(int(edges)),
            group.max_across(max(rounds)))


def run_fixed_point(splan: ShardedPlan, dist0, mask0, *,
                    op="shortest_path", max_iterations: int = 100000,
                    async_mode: bool = False):
    """Run one planned sharded traversal from the replicated ``dist0``/
    ``mask0`` (on the group's device).  Returns ``(dist, iterations,
    edges_relaxed, relax_rounds)``.  Lockstep keeps the single-device
    fused run's bits and ``relax_rounds == iterations``; ``async_mode``
    counts epochs in ``iterations`` and the deepest shard's local rounds
    in ``relax_rounds``.  :data:`DISPATCH_COUNTS` moves by one, keyed
    ``"shard:<kernel>"`` or ``"shard-async:<kernel>"``."""
    op = operators.resolve(op)
    if async_mode:
        DISPATCH_COUNTS[f"shard-async:{splan.kernel}"] += 1
        return _async(splan, dist0, mask0, op=op,
                      max_iterations=max_iterations)
    DISPATCH_COUNTS[f"shard:{splan.kernel}"] += 1
    return _lockstep(splan, dist0, mask0, op=op,
                     max_iterations=max_iterations)


def run_batch_fixed_point(sharded: ShardedCSRGraph, dist_b, mask_b, *,
                          group: ShardGroup, op="shortest_path",
                          max_iterations: int = 100000):
    """All K rows of ``dist_b``/``mask_b`` (``[K, N]``, replicated) to the
    batch's fixed point, sharded: each iteration runs the sharded WD step
    (one B1 launch a held shard) on every row whose frontier is live; a
    row with an empty frontier relaxes nothing.  Iterations count until
    every row is empty; edges sum the rows.  Returns ``(dist [K, N],
    iterations, edges_relaxed)``."""
    op = operators.resolve(op)
    DISPATCH_COUNTS["shard:batch"] += 1
    local = group.hold(sharded)
    rows, masks = list(dist_b), list(mask_b)
    edges = torch.zeros((), dtype=torch.int64, device=dist_b.device)
    it = 0
    while it < max_iterations:
        live = torch.stack([m.any() for m in masks]).tolist()
        if not any(live):
            break
        for r in range(len(rows)):
            if live[r]:
                rows[r], upd, e = _wd_step(local, group, rows[r], masks[r],
                                           op=op)
                masks[r] = group.any_across(upd)
                edges += e
        it += 1
    dist_b = torch.stack(rows) if rows else dist_b.clone()
    return dist_b, it, group.sum_across(int(edges))
