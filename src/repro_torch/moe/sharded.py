"""Expert-parallel MoE dispatch over a :class:`ShardGroup` (the port of
:mod:`repro.moe.sharded`).

The reference runs its sharded dispatch under ``shard_map`` over a device
mesh; the port runs it over the group of shards of
:mod:`repro_torch.core.shard` (A11's holder of shards): one process holds
every shard, or, under an initialised ``torch.distributed``, each rank
holds its own.  The layout is the reference's:

* :func:`sharded_moe_dispatch` (``moe_impl="shard_map"``): the experts
  are cut into ``S`` contiguous groups of ``E / S``, one a shard (the
  reference's ``model`` ranks); every shard sees the same tokens and
  dispatches, locally and with the paper's ``padded`` policy, the
  assignments routed to its own experts; the partial outputs are added
  across the held shards, then with one ``all_reduce`` across ranks;
* :func:`ep_global_dispatch` (``serve_ep``): the shards take the whole
  data×model grid, each a group of experts; each rank's token rows are
  all-gathered, each shard dispatches the gathered assignments routed to
  its experts, the partial outputs are summed, and each rank keeps its
  own rows;
* :func:`pad_experts`: dummy experts (zero weights, router logits at
  -1e30) make an expert count the shards do not divide (granite's 40 over
  16) divisible.

``use_group`` sets the group that :func:`repro_torch.models.moe.moe_ffn`
dispatches over, as the reference's ``use_mesh`` sets ``ACTIVE_MESH``.
The reference's ``fsdp`` branch (a ZeRO-3 all-gather of each rank's expert
weights over the data axis) has no counterpart: a one-axis group holds a
shard's experts whole.  Every rank holds the whole expert tree and reads
its own experts' rows of it.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.core.shard import ShardGroup
from repro_torch.moe.balancing import (_by_expert, _by_row, _expert_ffn,
                                       _gather_combine, _positions,
                                       _scatter_dispatch)

#: the group the MoE layers dispatch over (None: one device)
ACTIVE_GROUP: Optional[ShardGroup] = None


@contextlib.contextmanager
def use_group(group: Optional[ShardGroup]):
    """Run the MoE layers inside the block over ``group``'s shards."""
    global ACTIVE_GROUP
    prev, ACTIVE_GROUP = ACTIVE_GROUP, group
    try:
        yield group
    finally:
        ACTIVE_GROUP = prev


def _positions_sorted(ida: torch.Tensor) -> torch.Tensor:
    """ida [B,A] -> the position of each assignment in its expert's queue
    of its row, from a stable sort by expert instead of an [A,E] one-hot
    prefix sum: the same integers as ``balancing._positions``."""
    A = ida.shape[-1]
    order = torch.argsort(ida, dim=-1, stable=True)
    sorted_ids = torch.gather(ida, -1, order)
    left = torch.searchsorted(sorted_ids.contiguous(), sorted_ids,
                              side="left")
    pos_sorted = (torch.arange(A, device=ida.device) - left).to(torch.int32)
    return torch.empty_like(pos_sorted).scatter_(-1, order, pos_sorted)


def pad_experts(expert_params: dict, router_logits: torch.Tensor,
                num_experts: int, multiple: int):
    """Pad the expert axis to a multiple of ``multiple`` with dummy
    experts: zero weights, router logits at -1e30 (no token routes to
    them).  Returns ``(expert_params, router_logits, num_experts)``,
    unchanged when ``multiple`` divides ``num_experts``."""
    pad = (-num_experts) % multiple
    if pad == 0:
        return expert_params, router_logits, num_experts
    wp = {k: torch.cat([w, w.new_zeros(pad, *w.shape[1:])])
          for k, w in expert_params.items()}
    logits = torch.cat([router_logits, router_logits.new_full(
        (*router_logits.shape[:-1], pad), -1e30)], dim=-1)
    return wp, logits, num_experts + pad


def _local(expert_params: dict, lo: int, count: int) -> dict:
    return {k: w[lo:lo + count] for k, w in expert_params.items()}


def _shard_ffn(xa, ida, wa, pos, wp, lo: int, e_loc: int, capacity: int,
               activation: str):
    """One shard's part: the assignments [B,A] routed to experts
    ``lo .. lo + e_loc`` and within ``capacity`` of their queue go to
    that shard's ``e_loc × capacity`` slots of each row; its weighted
    outputs [B,A,D] (zero elsewhere)."""
    B = xa.shape[0]
    keep = (ida >= lo) & (ida < lo + e_loc) & (pos < capacity)
    flat = (ida - lo) * capacity + pos
    slots = _scatter_dispatch(xa, flat, keep, e_loc * capacity)
    out = _expert_ffn(_by_expert(slots, 1, e_loc, capacity), wp, activation)
    return _gather_combine(_by_row(out, B, 1, e_loc, capacity), flat, keep,
                           wa)


def _check_divides(num_experts: int, shards: int) -> int:
    if num_experts % shards:
        raise ValueError(f"{num_experts} experts over {shards} shards: "
                         f"pad them first (pad_experts)")
    return num_experts // shards


def sharded_moe_dispatch(x, ids, weights, expert_params, *,
                         group: ShardGroup, num_experts: int, capacity: int,
                         activation: str = "swiglu") -> torch.Tensor:
    """x [B,S,D] (the same rows on every rank); ids/weights [B,S,K].
    Shard ``s`` takes experts ``s·E/S .. (s+1)·E/S`` and ``capacity``
    slots an expert and row; positions are counted per row over all
    experts (:func:`_positions_sorted`).  Returns y [B,S,D] in x's
    dtype."""
    e_loc = _check_divides(num_experts, group.num_shards)
    B, S, D = x.shape
    K = ids.shape[-1]
    xa = x.repeat_interleave(K, dim=1)
    ida = ids.reshape(B, S * K).long()
    wa = weights.reshape(B, S * K).float()
    pos = _positions_sorted(ida)
    y = None
    for s in group.held:
        part = _shard_ffn(xa, ida, wa, pos,
                          _local(expert_params, s * e_loc, e_loc),
                          s * e_loc, e_loc, capacity, activation)
        part = part.reshape(B, S, K, D).sum(2)
        y = part if y is None else y + part
    return group.all_reduce(y, "add").to(x.dtype)


def ep_global_dispatch(x, ids, weights, expert_params, *,
                       group: ShardGroup, num_experts: int, capacity: int,
                       activation: str = "swiglu") -> torch.Tensor:
    """x [B,S,D] (this rank's rows); ids/weights [B,S,K].  Every rank's
    rows are gathered (in rank order, the same B a rank), the gathered
    assignments are queued per expert in one row (token-major), shard
    ``s`` runs experts ``s·E/S .. (s+1)·E/S`` at ``capacity`` slots each,
    the partial outputs are summed across shards, and this rank's rows
    come back.  Returns y [B,S,D] in x's dtype."""
    e_grp = _check_divides(num_experts, group.num_shards)
    B, S, D = x.shape
    xg, idg, wg = (group.all_gather(t) for t in (x, ids, weights))
    Bg, K = xg.shape[0], idg.shape[-1]
    A = Bg * S * K
    xa = xg.reshape(1, Bg * S, D).repeat_interleave(K, dim=1)
    ida = idg.reshape(1, A).long()
    wa = wg.reshape(1, A).float()
    pos, _ = _positions(ida, num_experts)
    y = None
    for s in group.held:
        part = _shard_ffn(xa, ida, wa, pos,
                          _local(expert_params, s * e_grp, e_grp),
                          s * e_grp, e_grp, capacity, activation)
        part = part.reshape(Bg, S, K, D).sum(2)
        y = part if y is None else y + part
    y = group.all_reduce(y.to(x.dtype), "add")
    lo = group.held[0] * B if group.process_group is not None else 0
    return y[lo:lo + B]
