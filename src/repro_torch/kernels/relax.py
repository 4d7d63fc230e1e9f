"""The relax kernels B1 and B2 of the port, their plain versions, and the
fold of their candidates into ``dist``.

* :func:`relax_lanes` (B2) relaxes ``L`` direct-mapped ``(src, dst, w,
  valid)`` lanes: BS edge columns and HP's ``[cap, MDT]`` tiles.  It
  replaces the reference's Pallas ``repro.kernels.relax.relax_lanes``.
* :func:`wd_relax_lanes` (B1) fuses WD's merge-path search with the
  relax: lane *k* ranks itself in the frontier's inclusive degree prefix,
  reads its edge through the per-slot ``start``/``exclusive``/``src_ids``
  tables, and relaxes it.  It replaces the reference's Pallas
  ``repro.kernels.relax.wd_relax_lanes`` (WD, HP's tail, AD).
* :func:`wd_apply_relax_union` is B1's batch contract: ``K`` rows at
  once, node-major (``dist_t [N, Kp]``), one merge path over the union
  of the rows' frontiers and one launch for all rows, folding into a copy
  of ``dist_t``.  It replaces the reference's ``jax.vmap`` of B1 in
  ``repro.core.multi_source.batched_wd_relax``;
  :func:`wd_apply_relax_batch_plain` is the same relax row by row, its
  oracle.

Each kernel serves two contracts, and every lane of a launch reads the
same unmodified ``dist``, so the port's ``(dist, iterations,
edges_relaxed)`` equal the reference's bit for bit:

* the reference kernel's own, ``(proposal [N], updated [N] bool,
  improve [lanes] bool)`` (:func:`relax_lanes`, :func:`wd_relax_lanes`):
  ``proposal`` is the monoid fold of every improving candidate per
  destination, the identity elsewhere; :func:`apply_proposal` folds it
  into ``dist`` elementwise;
* the fold into ``dist`` itself, ``(next dist, updated, improve)``
  (:func:`apply_relax`, :func:`wd_apply_relax`): the kernel folds the
  candidates into a copy of ``dist`` and marks them in the caller's
  running ``updated`` mask, **in place**.  On the card that is one copy
  and one launch, with no proposal to fill or fold and no mask to OR.

A wrapper takes its device from its tensors: for CUDA tensors it launches
its kernel (``csrc/relax.cu``) and counts the launch in :data:`LAUNCHES`,
the values of the operator's dtype (int32, or float32 from the
operator's own build) and every index and weight int32;
for CPU tensors it runs its plain PyTorch version (``*_plain``), which
is the reference's XLA lowering written in PyTorch.  A user-defined
operator launches the same kernels from its own library, built for it at
first use (``_build.op_library``; its callables lowered by
:mod:`repro_torch.kernels.opgen`), or raises before the launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import operators
from repro_torch.core.operators import EdgeOp
from repro_torch.kernels import _build
from repro_torch.kernels._build import (  # noqa: F401  (re-exported)
    LANES, LAUNCHES, check_aligned, check_dense, check_tensor, stream_of)
from repro_torch.kernels.find_offsets import find_offsets_plain


def _empty_result(dist: torch.Tensor, lanes: int, op: EdgeOp):
    dev = dist.device
    return (torch.full_like(dist, op.identity),
            torch.zeros(dist.numel(), dtype=torch.bool, device=dev),
            torch.zeros(lanes, dtype=torch.bool, device=dev))


def _dispatch(dist: torch.Tensor, name: str):
    if dist.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no {name} for device {dist.device}")
    return dist.device.type == "cuda"


def _launch(name: str, dev: torch.device, library, *args) -> None:
    """Call the C entry point ``repro_<name>`` of ``library`` (the
    operator's, ``_build.op_library``) on ``dev``'s current stream and
    raise if it reports an error; every launch goes through here."""
    with torch.cuda.device(dev):
        _build.check(name, getattr(library, f"repro_{name}")(
            *args, stream_of(dev)))


def apply_proposal(dist, proposal, op: EdgeOp):
    """Fold a dense proposal into ``dist`` elementwise
    (:meth:`EdgeOp.fold_values`): the proposal holds the identity for
    untouched destinations and the monoid is associative, so this equals
    scattering every candidate into ``dist``."""
    return op.fold_values(dist, proposal)


# ---------------------------------------------------------------------------
# B2: direct-mapped lanes
# ---------------------------------------------------------------------------

def relax_lanes_plain(dist, src, dst, w, valid, *,
                      op: EdgeOp = operators.shortest_path):
    """B2's plain version: ``index_select`` gathers, then
    ``scatter_reduce_`` folds the proposal and ``amax`` the updated
    flags (the reference's ``strategies._apply_relax``)."""
    n = dist.numel()
    src_c = src.clamp(0, n - 1)
    dst_c = dst.clamp(0, n - 1)
    cand = op.message(dist.index_select(0, src_c), w)
    improve = valid & op.improves(cand, dist.index_select(0, dst_c))
    prop = op.scatter(torch.full_like(dist, op.identity), dst_c, cand,
                      improve)
    upd = torch.zeros(n, dtype=torch.uint8, device=dist.device)
    upd.scatter_reduce_(0, dst_c.long(), improve.to(torch.uint8), "amax")
    return prop, upd.bool(), improve


def _relax_lanes_cuda(dist, src, dst, w, valid, target, updated,
                      op: EdgeOp):
    """Launch B2 folding into ``target`` (the wrapper's own buffer, never
    ``dist``) and ``updated``; returns ``improve``."""
    library, msg, comb = _build.op_library(op)
    dev = dist.device
    n, lanes = dist.numel(), src.numel()
    check_tensor("dist", dist, dev, operators.value_dtype(op))
    for name, t in (("src", src), ("dst", dst), ("w", w)):
        check_tensor(name, t, dev, torch.int32, lanes)
    check_tensor("valid", valid, dev, torch.bool, lanes)
    check_tensor("updated", updated, dev, torch.bool, n)
    imp = torch.empty(lanes, dtype=torch.bool, device=dev)
    if lanes == 0:
        return imp
    if n == 0:
        raise ValueError("relax_lanes needs a non-empty dist")
    _launch("relax_lanes", dev, library, dist.data_ptr(), n, src.data_ptr(),
            dst.data_ptr(), w.data_ptr(), valid.data_ptr(), lanes, msg, comb,
            target.data_ptr(), updated.data_ptr(), imp.data_ptr())
    LAUNCHES["relax_lanes"] += 1
    LANES["relax_lanes"] += lanes
    return imp


def relax_lanes(dist, src, dst, w, valid, *,
                op: EdgeOp = operators.shortest_path):
    """One relax over ``L`` direct-mapped lanes: ``dist [N]`` of the
    operator's dtype; ``src``/``dst``/``w`` ``[L]`` int32 (indices are
    clamped into
    ``[0, N)``); ``valid [L]`` bool.  Returns ``(proposal [N],
    updated [N] bool, improve [L] bool)``."""
    if not _dispatch(dist, "relax_lanes"):
        return relax_lanes_plain(dist, src, dst, w, valid, op=op)
    prop = torch.full_like(dist, op.identity)
    upd = torch.zeros(dist.numel(), dtype=torch.bool, device=dist.device)
    imp = _relax_lanes_cuda(dist, src, dst, w, valid, prop, upd, op)
    return prop, upd, imp


def apply_relax_plain(dist, updated, src, dst, w, valid, *,
                      op: EdgeOp = operators.shortest_path):
    """:func:`apply_relax`'s plain version: B2's plain version, then
    :func:`apply_proposal` and an OR into ``updated`` (in place)."""
    prop, upd, imp = relax_lanes_plain(dist, src, dst, w, valid, op=op)
    updated |= upd
    return apply_proposal(dist, prop, op), updated, imp


def apply_relax(dist, updated, src, dst, w, valid, *,
                op: EdgeOp = operators.shortest_path):
    """``dist[dst] = combine(dist[dst], message(dist[src], w))`` over the
    valid lanes, against one snapshot of ``dist``; the port of the
    reference's ``strategies._apply_relax``.  Returns ``(next dist,
    updated, improve)``: ``next dist`` is new, ``updated`` is the
    caller's bool mask with the improved destinations set **in place**."""
    if not _dispatch(dist, "apply_relax"):
        return apply_relax_plain(dist, updated, src, dst, w, valid, op=op)
    target = dist.clone()
    imp = _relax_lanes_cuda(dist, src, dst, w, valid, target, updated, op)
    return target, updated, imp


# ---------------------------------------------------------------------------
# B1: merge-path search fused with the relax
# ---------------------------------------------------------------------------

def wd_relax_lanes_plain(dist, prefix, exclusive, start, src_ids, col,
                         wt: Optional[torch.Tensor], *, cap_work: int,
                         op: EdgeOp = operators.shortest_path):
    """B1's plain version: ``searchsorted`` ranks, gathers of the slot
    tables and ``col``/``wt``, then B2's plain relax (the reference's XLA
    path of ``strategies.wd_relax``)."""
    f, e = prefix.numel(), col.numel()
    if f == 0 or cap_work == 0:
        return _empty_result(dist, cap_work, op)
    k = torch.arange(cap_work, dtype=torch.int32, device=dist.device)
    i = find_offsets_plain(prefix, cap_work).clamp_(max=f - 1)
    eidx = (start[i] + (k - exclusive[i])).clamp_(0, e - 1)
    valid = k < prefix[f - 1]
    w = torch.ones_like(k) if wt is None else wt[eidx]
    return relax_lanes_plain(dist, src_ids[i], col[eidx], w, valid, op=op)


def _wd_relax_lanes_cuda(dist, prefix, exclusive, start, src_ids, col, wt,
                         cap_work: int, target, updated, op: EdgeOp):
    """Launch B1 folding into ``target`` (the wrapper's own buffer, never
    ``dist``) and ``updated``; returns ``improve``."""
    library, msg, comb = _build.op_library(op)
    dev = dist.device
    n, f, e = dist.numel(), prefix.numel(), col.numel()
    check_tensor("dist", dist, dev, operators.value_dtype(op))
    for name, t in (("prefix", prefix), ("exclusive", exclusive),
                    ("start", start), ("src_ids", src_ids)):
        check_tensor(name, t, dev, torch.int32, f)
    check_tensor("col", col, dev, torch.int32)
    if wt is not None:
        check_tensor("wt", wt, dev, torch.int32, e)
    check_tensor("updated", updated, dev, torch.bool, n)
    if f == 0 or cap_work == 0:
        return torch.zeros(cap_work, dtype=torch.bool, device=dev)
    if n == 0 or e == 0:
        raise ValueError("wd_relax_lanes needs a non-empty dist and col")
    imp = torch.empty(cap_work, dtype=torch.bool, device=dev)
    _launch("wd_relax_lanes", dev, library, dist.data_ptr(), n,
            prefix.data_ptr(), exclusive.data_ptr(), start.data_ptr(),
            src_ids.data_ptr(), f, col.data_ptr(),
            None if wt is None else wt.data_ptr(), e, cap_work, msg, comb,
            target.data_ptr(), updated.data_ptr(), imp.data_ptr())
    LAUNCHES["wd_relax_lanes"] += 1
    LANES["wd_relax_lanes"] += cap_work
    return imp


def _check_cap_work(cap_work: int) -> None:
    if cap_work < 0 or cap_work >= 2 ** 31:
        raise ValueError(f"cap_work must be in [0, 2**31), got {cap_work}")


def wd_relax_lanes(dist, prefix, exclusive, start, src_ids, col,
                   wt: Optional[torch.Tensor], *, cap_work: int,
                   op: EdgeOp = operators.shortest_path):
    """Merge-path search + relax over ``cap_work`` lanes.  ``prefix`` is
    the inclusive scan of the frontier's remaining degrees ``[F]``;
    ``exclusive``, ``start`` (first edge of each slot's remaining run) and
    ``src_ids`` are per-slot ``[F]``; ``col``/``wt`` are the CSR arrays
    (``wt=None``: weight 1).  Returns ``(proposal [N], updated [N] bool,
    improve [cap_work] bool)``."""
    _check_cap_work(cap_work)
    if not _dispatch(dist, "wd_relax_lanes"):
        return wd_relax_lanes_plain(dist, prefix, exclusive, start, src_ids,
                                    col, wt, cap_work=cap_work, op=op)
    prop = torch.full_like(dist, op.identity)
    upd = torch.zeros(dist.numel(), dtype=torch.bool, device=dist.device)
    imp = _wd_relax_lanes_cuda(dist, prefix, exclusive, start, src_ids, col,
                               wt, cap_work, prop, upd, op)
    return prop, upd, imp


def wd_apply_relax_plain(dist, updated, prefix, exclusive, start, src_ids,
                         col, wt: Optional[torch.Tensor], *, cap_work: int,
                         op: EdgeOp = operators.shortest_path):
    """:func:`wd_apply_relax`'s plain version: B1's plain version, then
    :func:`apply_proposal` and an OR into ``updated`` (in place)."""
    prop, upd, imp = wd_relax_lanes_plain(dist, prefix, exclusive, start,
                                          src_ids, col, wt,
                                          cap_work=cap_work, op=op)
    updated |= upd
    return apply_proposal(dist, prop, op), updated, imp


def wd_apply_relax(dist, updated, prefix, exclusive, start, src_ids, col,
                   wt: Optional[torch.Tensor], *, cap_work: int,
                   op: EdgeOp = operators.shortest_path):
    """:func:`wd_relax_lanes` folded into ``dist``: returns ``(next dist,
    updated, improve)``, with ``updated`` (the caller's bool mask) set in
    place where a lane improved its destination, as in
    :func:`apply_relax`."""
    _check_cap_work(cap_work)
    if not _dispatch(dist, "wd_apply_relax"):
        return wd_apply_relax_plain(dist, updated, prefix, exclusive, start,
                                    src_ids, col, wt, cap_work=cap_work,
                                    op=op)
    target = dist.clone()
    imp = _wd_relax_lanes_cuda(dist, prefix, exclusive, start, src_ids, col,
                               wt, cap_work, target, updated, op)
    return target, updated, imp


# ---------------------------------------------------------------------------
# B1's batch contract: K rows, one merge path over their union frontier
# ---------------------------------------------------------------------------

def wd_apply_relax_batch_plain(dist, updated, prefix, exclusive, start,
                               src_ids, col, wt: Optional[torch.Tensor], *,
                               cap_work: int,
                               op: EdgeOp = operators.shortest_path):
    """B1's batch contract row by row, the oracle of
    :func:`wd_apply_relax_union`: ``dist``/``updated`` ``[K, N]``, each
    row's slot tables ``[K, F]``; B1's plain fold on each row
    (``updated[r]`` set in place), stacked.  Returns ``(next dist [K, N],
    updated)``."""
    rows = [wd_apply_relax_plain(dist[r], updated[r], prefix[r],
                                 exclusive[r], start[r], src_ids[r], col, wt,
                                 cap_work=cap_work, op=op)[0]
            for r in range(dist.shape[0])]
    return (torch.stack(rows) if rows else dist.clone()), updated


def wd_apply_relax_union_plain(dist_t, front_t, prefix, exclusive, start,
                               src_ids, col, wt: Optional[torch.Tensor], *,
                               cap_work: int, row_excl=None,
                               op: EdgeOp = operators.shortest_path):
    """:func:`wd_apply_relax_union`'s plain version: B1's plain ranks over
    the union's lanes, then every row's candidates at once, folded by
    ``scatter_reduce_`` into a copy of ``dist_t``."""
    n, kp = dist_t.shape
    f, e = prefix.numel(), col.numel()
    target = dist_t.clone()
    upd = torch.zeros_like(front_t)
    total = int(prefix[-1]) if f else 0
    if total == 0:
        return target, upd
    k = torch.arange(total, dtype=torch.int32, device=dist_t.device)
    i = find_offsets_plain(prefix, total).clamp_(max=f - 1)
    off = k - exclusive[i]
    eidx = (start[i] + off).clamp_(0, e - 1)
    src = src_ids[i].clamp(0, n - 1).long()
    dst = col[eidx].clamp(0, n - 1).long()
    w = torch.ones_like(k) if wt is None else wt[eidx]
    active = front_t[src]                                   # [L, kp]
    if row_excl is not None:
        active &= row_excl[i] + off[:, None] < cap_work
    cand = op.message(dist_t[src], w[:, None])
    improve = active & op.improves(cand, dist_t[dst])
    at = (dst[:, None] * kp + torch.arange(kp, device=dst.device)).view(-1)
    op.scatter(target.view(-1), at, cand.reshape(-1), improve.view(-1))
    upd.view(-1)[at[improve.view(-1)]] = True
    return target, upd


def _check_node_major(dist_t, front_t, slots, row_excl, col, wt,
                      dtype: torch.dtype):
    """The union contract's arguments on the card (``dist_t`` of the
    operator's ``dtype``); returns ``(n, kp, f, e)``."""
    dev = dist_t.device
    if dist_t.dim() != 2:
        raise ValueError(f"dist_t has shape {tuple(dist_t.shape)}, "
                         f"expected [N, Kp]")
    n, kp = dist_t.shape
    if kp % 4:
        raise ValueError(f"dist_t has {kp} columns; the kernel takes rows "
                         f"in fours (pad K to a multiple of 4)")
    check_dense("dist_t", dist_t, dev, dtype, (n, kp))
    check_dense("front_t", front_t, dev, torch.bool, (n, kp))
    f = slots[0].numel()
    for name, t in zip(("prefix", "exclusive", "start", "src_ids"), slots):
        check_tensor(name, t, dev, torch.int32, f)
    if row_excl is not None:
        check_dense("row_excl", row_excl, dev, torch.int32, (f, kp))
        check_aligned(row_excl=row_excl)
    check_tensor("col", col, dev, torch.int32)
    e = col.numel()
    if wt is not None:
        check_tensor("wt", wt, dev, torch.int32, e)
    # a 16-byte start keeps each row's quads aligned for every value
    # width (a quad is 16 bytes of int32/float32, 8 of a 16-bit type, 4
    # of an 8-bit one, and Kp is a multiple of 4)
    check_aligned(dist_t=dist_t)
    if front_t.data_ptr() % 4:
        raise ValueError("front_t must start on a 4-byte boundary")
    return n, kp, f, e


def wd_apply_relax_union(dist_t, front_t, prefix, exclusive, start,
                         src_ids, col, wt: Optional[torch.Tensor], *,
                         cap_work: int, max_lanes: int, row_excl=None,
                         op: EdgeOp = operators.shortest_path):
    """B1's batch contract, node-major: one relax of ``K`` rows over the
    union of their frontiers.  ``dist_t [N, Kp]`` (the operator's dtype)
    and ``front_t
    [N, Kp]`` bool hold row ``r`` in column ``r`` (``Kp`` = ``K`` rounded
    up to 4; the padded columns' frontier is empty); ``prefix``,
    ``exclusive``, ``start`` and ``src_ids`` ``[F]`` are the WD slot
    tables of the union frontier (every node active in some row, padded
    with zero-degree slots).  Each union lane (an out-edge of a slot) is
    relaxed in every row whose frontier holds its source.
    ``row_excl [F, Kp]`` (optional) is each row's exclusive degree prefix
    at the slot, over that row's own frontier: with it a row relaxes only
    its first ``cap_work`` lanes, as the reference's row does; without
    it, no row is cut.  ``max_lanes`` bounds the union's lanes (it sizes
    the kernel's grid; the kernel reads the count itself).  Returns
    ``(next dist_t, next frontier [N, Kp] bool)``.  On the card: one copy
    of ``dist_t``, one zeroed frontier and one launch for all ``K``
    rows."""
    _check_cap_work(cap_work)
    if not _dispatch(dist_t, "wd_apply_relax_union"):
        return wd_apply_relax_union_plain(
            dist_t, front_t, prefix, exclusive, start, src_ids, col, wt,
            cap_work=cap_work, row_excl=row_excl, op=op)
    library, msg, comb = _build.op_library(op)
    slots = (prefix, exclusive, start, src_ids)
    n, kp, f, e = _check_node_major(dist_t, front_t, slots, row_excl, col,
                                    wt, operators.value_dtype(op))
    target = dist_t.clone()
    upd = torch.zeros_like(front_t)
    if kp == 0 or f == 0:
        return target, upd
    if n == 0 or e == 0:
        raise ValueError("wd_apply_relax_union needs a non-empty dist_t "
                         "and col")
    _launch("wd_relax_union", dist_t.device, library, dist_t.data_ptr(), n,
            kp, front_t.data_ptr(), *(t.data_ptr() for t in slots), f,
            None if row_excl is None else row_excl.data_ptr(), cap_work,
            col.data_ptr(), None if wt is None else wt.data_ptr(), e,
            max_lanes, msg, comb, target.data_ptr(), upd.data_ptr())
    LAUNCHES["wd_relax_lanes_batch"] += 1
    LANES["wd_relax_lanes_batch"] += max_lanes * (kp // 4)
    return target, upd
