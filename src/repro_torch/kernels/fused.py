"""The fused fixed point's kernel wrapper: a whole traversal in one launch.

:func:`fixed_point` runs one strategy's traversal (the loop of the
reference's ``repro.core.fused._fixed_point``) from ``(dist, mask)`` to
its fixed point.  For CUDA tensors it makes ONE cooperative launch of
``csrc/fused.cu``'s persistent kernel, counts it in
``LAUNCHES["fused_fixed_point"]`` and reads back iterations, the edge
total and AD's three counts with one host sync; nothing of B1 or B2 is
launched (the kernel carries their lane bodies).  For CPU tensors it runs
the plain version, :func:`repro_torch.core.fused._fixed_point_plain`.
:func:`batch_fixed_point` runs K WD traversals the same way, in one launch
of the same kernel with K rows (ROADMAP A8).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.graph import CSRGraph
from repro_torch.core.operators import EdgeOp
from repro_torch.kernels import _build
from repro_torch.kernels._build import (LAUNCHES, check_dense, check_tensor,
                                        stream_of)

#: the kernel argument naming each fused lowering (``csrc/fused.cu``)
KERNEL_CODES = {"BS": 0, "WD": 1, "HP": 2, "EP": 3, "NS": 4, "AD": 5}


def fixed_point(kernel: str, graph: CSRGraph, aux: Optional[torch.Tensor],
                dist: torch.Tensor, mask: torch.Tensor, *, op: EdgeOp,
                sched, max_iterations: int):
    """Run ``kernel`` (a :data:`KERNEL_CODES` name) on ``graph`` from the
    values ``dist`` and frontier ``mask`` to the fixed point, or for at
    most ``max_iterations`` iterations.  ``aux`` is EP's per-edge source
    ids or NS's child -> parent map (else ``None``); ``sched`` the
    resolved :class:`~repro_torch.core.schedule.Schedule`.  Returns
    ``(dist, iterations, edges_relaxed, [BS, WD, HP] counts of AD's
    choices)``; the inputs are not modified."""
    if kernel not in KERNEL_CODES:
        raise ValueError(f"unknown fused kernel {kernel!r}")
    if dist.device.type == "cpu":
        from repro_torch.core.fused import _fixed_point_plain
        return _fixed_point_plain(kernel, graph, aux, dist, mask, op=op,
                                  sched=sched, max_iterations=max_iterations)
    if dist.device.type != "cuda":
        raise ValueError(f"no fused_fixed_point for device {dist.device}")
    dev = dist.device
    n, e = graph.num_nodes, graph.num_edges
    check_tensor("dist", dist, dev, torch.int32, n)
    check_tensor("mask", mask, dev, torch.bool, n)
    if kernel in ("EP", "NS"):
        check_tensor("aux", aux, dev, torch.int32, e if kernel == "EP" else n)
    out = torch.empty_like(dist)
    it, edges, *chosen = _launch(kernel, graph, aux, dist, mask, 1, out,
                                 op=op, sched=sched,
                                 max_iterations=max_iterations)
    return out, it, edges, chosen


def rows_per_launch(num_nodes: int, num_edges: int) -> int:
    """The most rows a batch launch takes: its flat ``[rows, N]`` values
    and an iteration's summed degree (at most ``rows * E``) index with
    int32."""
    return max(1, min((2 ** 31 - 1) // max(num_nodes, 1),
                      (2 ** 31 - 1) // max(num_edges, 1)))


def batch_fixed_point(graph: CSRGraph, dist: torch.Tensor,
                      mask: torch.Tensor, *, op: EdgeOp, sched,
                      max_iterations: int):
    """K WD traversals from the rows of ``dist [K, N]`` and ``mask
    [K, N]`` to the batch's fixed point (while any row's frontier is
    live).  For CUDA tensors ONE launch of the persistent kernel with K
    rows (the kernel's WD chunk over every row's frontier at once); a
    batch past :func:`rows_per_launch` runs as groups of rows, one launch
    each, which is exact because rows never interact: the iterations are
    the groups' maximum and the edges their sum.  For CPU tensors the
    plain loop :func:`repro_torch.core.fused._batch_fixed_point_plain`.
    Returns ``(dist [K, N], iterations, edges_relaxed)``; the inputs are
    not modified."""
    if dist.device.type == "cpu":
        from repro_torch.core.fused import _batch_fixed_point_plain
        return _batch_fixed_point_plain(graph, dist, mask, op=op,
                                        max_iterations=max_iterations)
    if dist.device.type != "cuda":
        raise ValueError(f"no fused_fixed_point for device {dist.device}")
    dev = dist.device
    if dist.dim() != 2:
        raise ValueError(f"dist has shape {tuple(dist.shape)}, expected "
                         f"[K, N]")
    k, n = dist.shape
    check_dense("dist", dist, dev, torch.int32, (k, graph.num_nodes))
    check_dense("mask", mask, dev, torch.bool, (k, n))
    out = torch.empty_like(dist)
    it, edges = 0, 0
    step = rows_per_launch(n, graph.num_edges)
    for r0 in range(0, k, step):
        r1 = min(r0 + step, k)
        res = _launch("WD", graph, None, dist[r0:r1], mask[r0:r1], r1 - r0,
                      out[r0:r1], op=op, sched=sched,
                      max_iterations=max_iterations)
        it, edges = max(it, res[0]), edges + res[1]
    return out, it, edges


def _launch(kernel: str, graph: CSRGraph, aux, dist, mask, rows: int, out,
            *, op: EdgeOp, sched, max_iterations: int) -> list:
    """One cooperative launch over ``rows`` rows of ``graph``'s nodes
    (contiguous ``dist``/``mask``/``out``); returns iterations, the edge
    total and AD's three counts, read with one host sync."""
    msg, comb = op.kernel_codes()
    dev = dist.device
    n, e = graph.num_nodes, graph.num_edges
    check_tensor("row_ptr", graph.row_ptr, dev, torch.int32, n + 1)
    check_tensor("col", graph.col, dev, torch.int32, e)
    if graph.wt is not None:
        check_tensor("wt", graph.wt, dev, torch.int32, e)
    if n == 0:
        raise ValueError("fused_fixed_point needs a graph with nodes")
    lib = _build.lib()
    nbytes = ctypes.c_longlong()
    with torch.cuda.device(dev):
        _build.check("fused_workspace_bytes", lib.repro_fused_workspace_bytes(
            rows * n, ctypes.byref(nbytes)))
    workspace = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
    result = torch.empty(5, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        _build.check("fused_fixed_point", lib.repro_fused_fixed_point(
            graph.row_ptr.data_ptr(), graph.col.data_ptr(),
            None if graph.wt is None else graph.wt.data_ptr(), n, rows, e,
            None if aux is None else aux.data_ptr(), dist.data_ptr(),
            mask.data_ptr(), KERNEL_CODES[kernel], msg, comb,
            min(int(max_iterations), 2 ** 31 - 1), sched.mdt or 1,
            sched.switch_threshold, sched.small_frontier,
            sched.imbalance_threshold, sched.hp_edges_threshold,
            out.data_ptr(), workspace.data_ptr(), nbytes.value,
            result.data_ptr(), stream_of(dev)))
    LAUNCHES["fused_fixed_point"] += 1
    return result.tolist()                          # the one host sync
