"""Distributed SSSP over a range-partitioned graph with a frontier
exchange (the counterpart of :mod:`repro.core.dist`).

When one device cannot hold the graph, nodes are range-partitioned over
the shards of a :class:`~repro_torch.core.shard.ShardGroup`: each shard
relaxes its own rows with WD's merge path (the lane search is B3,
``kernels.find_offsets``: the hand-written kernel on the card, its plain
version on the CPU), and every relaxation is routed to the owner of its
destination by a bucketed all-to-all (the frontier exchange of
distributed BFS), where the owner folds it in with ``min``.

Messages are ``(dst, alt)`` pairs in per-owner buckets of a fixed
capacity; the capacity is the worst case, a shard's whole edge count
(``e_loc``), so no message is dropped.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import INF, CSRGraph
from repro_torch.core.shard import ShardGroup
from repro_torch.kernels.find_offsets import find_offsets


@dataclasses.dataclass
class PartitionedGraph:
    """Per-shard padded CSR, the partition on axis 0: shard ``p`` owns
    nodes ``[p * n_loc, (p + 1) * n_loc)``."""
    row_ptr: torch.Tensor      # [P, n_loc+1] local offsets
    col: torch.Tensor          # [P, e_loc] global dst ids (padded -1)
    wt: torch.Tensor           # [P, e_loc] (padded 0)
    num_nodes: int
    n_loc: int
    e_loc: int
    num_parts: int


def partition_graph(g: CSRGraph, parts: int) -> PartitionedGraph:
    """Host-side 1-D range partition with per-shard padding, stacked on
    the host (:func:`distributed_sssp` moves the held shards to their
    device)."""
    row_ptr = g.row_ptr.cpu().numpy().astype(np.int64)
    col = g.col.cpu().numpy()
    wt = (g.wt.cpu().numpy() if g.wt is not None
          else np.ones(g.num_edges, np.int32))
    n = g.num_nodes
    n_loc = -(-n // parts)
    e_loc = 1
    shards = []
    for p in range(parts):
        lo, hi = p * n_loc, min((p + 1) * n_loc, n)
        base = row_ptr[lo]
        rp = row_ptr[lo:hi + 1] - base
        rp = np.pad(rp, (0, n_loc + 1 - len(rp)), mode="edge")
        c = col[row_ptr[lo]: row_ptr[hi]]
        w = wt[row_ptr[lo]: row_ptr[hi]]
        shards.append((rp, c, w))
        e_loc = max(e_loc, len(c))
    rps = np.stack([s[0] for s in shards])
    cols = np.stack([np.pad(s[1], (0, e_loc - len(s[1])),
                            constant_values=-1) for s in shards])
    wts = np.stack([np.pad(s[2], (0, e_loc - len(s[2]))) for s in shards])

    def host(a):
        return torch.from_numpy(a.astype(np.int32))

    return PartitionedGraph(
        row_ptr=host(rps), col=host(cols), wt=host(wts),
        num_nodes=n, n_loc=n_loc, e_loc=e_loc, num_parts=parts)


def _send_buffers(rp, col, wt, dist_loc, mask_loc, *, n_loc: int,
                  e_loc: int, parts: int):
    """One shard's relax of its frontier's edges, bucketed by the owner of
    each destination: ``([parts, e_loc] dst, [parts, e_loc] alt)``,
    ``-1``/``INF`` in unused slots.  Only the valid lanes are written (a
    compaction, one sync): every invalid lane aimed at one dump slot
    would serialise on its address."""
    dev = dist_loc.device
    deg = torch.where(mask_loc, rp[1:] - rp[:-1], 0)
    prefix = torch.cumsum(deg, 0, dtype=torch.int32)
    k = torch.arange(e_loc, dtype=torch.int32, device=dev)
    node = find_offsets(prefix, e_loc).clamp_(0, n_loc - 1)
    eidx = (rp[node] + k - (prefix[node] - deg[node])).clamp_(0, e_loc - 1)
    lanes = torch.nonzero((k < prefix[-1]) & (col[eidx] >= 0))[:, 0]
    node, eidx = node[lanes], eidx[lanes]
    dst = col[eidx]
    alt = dist_loc[node] + wt[eidx]
    owner = torch.div(dst, n_loc, rounding_mode="floor").clamp_(0, parts - 1)
    # a lane's place in its owner's bucket: the lanes before it with the
    # same owner, one scan a owner along the lanes (the innermost axis: a
    # scan along an outer axis runs a thread a column)
    mine = owner[None, :] == torch.arange(parts, dtype=torch.int32,
                                          device=dev)[:, None]
    pos = (torch.cumsum(mine, 1, dtype=torch.int32) - mine.int()).gather(
        0, owner.long()[None, :])[0]
    slot = owner.long() * e_loc + pos
    buf_dst = torch.full((parts * e_loc,), -1, dtype=torch.int32, device=dev)
    buf_dst[slot] = dst
    buf_alt = torch.full((parts * e_loc,), INF, dtype=torch.int32,
                         device=dev)
    buf_alt[slot] = alt
    return buf_dst.view(parts, e_loc), buf_alt.view(parts, e_loc)


def _receive(dist_loc, rx_dst, rx_alt, *, me: int, n_loc: int):
    """The owner's ``min`` over the messages it received (the used slots
    only, one sync): ``(dist_loc, next frontier)``, the frontier being
    the nodes whose value fell."""
    rx_dst, rx_alt = rx_dst.reshape(-1), rx_alt.reshape(-1)
    ok = torch.nonzero(rx_dst >= 0)[:, 0]
    loc_idx = (rx_dst[ok] - me * n_loc).clamp_(0, n_loc - 1).long()
    new_dist = dist_loc.scatter_reduce(0, loc_idx, rx_alt[ok], "amin")
    return new_dist, new_dist < dist_loc


def distributed_sssp(g: CSRGraph, source: int, group: ShardGroup,
                     max_iterations: int = 10000) -> np.ndarray:
    """SSSP over ``g`` partitioned into ``group.num_shards`` ranges, each
    relaxed by its holder with WD's merge path, the relaxations routed to
    their owners by :meth:`ShardGroup.all_to_all`.  Returns the ``[N]``
    distances on the host (on every rank)."""
    parts = group.num_shards
    pg = partition_graph(g, parts)
    n_loc, e_loc = pg.n_loc, pg.e_loc
    dev = group.device
    held = [(p, *(t[p].to(dev, copy=True) for t in (pg.row_ptr, pg.col,
                                                     pg.wt)))
            for p in group.held]
    dist, mask = [], []
    for p, *_ in held:
        d = torch.full((n_loc,), INF, dtype=torch.int32, device=dev)
        m = torch.zeros(n_loc, dtype=torch.bool, device=dev)
        if p == source // n_loc:
            d[source % n_loc] = 0
            m[source % n_loc] = True
        dist.append(d)
        mask.append(m)

    it, count = 0, 1
    while count > 0 and it < max_iterations:
        sends = [_send_buffers(rp, col, wt, d, m, n_loc=n_loc, e_loc=e_loc,
                               parts=parts)
                 for (_, rp, col, wt), d, m in zip(held, dist, mask)]
        rx_dst = group.all_to_all([s[0] for s in sends])
        rx_alt = group.all_to_all([s[1] for s in sends])
        out = [_receive(d, rd, ra, me=p, n_loc=n_loc)
               for (p, *_), d, rd, ra in zip(held, dist, rx_dst, rx_alt)]
        dist = [d for d, _ in out]
        mask = [m for _, m in out]
        count = group.sum_across(int(torch.stack(
            [m.sum() for m in mask]).sum()))
        it += 1
    # every rank gets the whole array: each writes its ranges into an
    # INF-filled one, and a MIN across ranks fills the rest
    full = torch.full((parts, n_loc), INF, dtype=torch.int32, device=dev)
    for (p, *_), d in zip(held, dist):
        full[p] = d
    full = group.all_reduce(full, "min")
    return full.reshape(-1)[: g.num_nodes].cpu().numpy()
