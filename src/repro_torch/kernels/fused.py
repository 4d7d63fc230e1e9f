"""The fused fixed point's kernel wrapper: a whole traversal in one launch.

:func:`fixed_point` runs one strategy's traversal (the loop of the
reference's ``repro.core.fused._fixed_point``) from ``(dist, mask)`` to
its fixed point.  For CUDA tensors it makes ONE cooperative launch of
``csrc/fused.cu``'s persistent kernel, counts it in
``LAUNCHES["fused_fixed_point"]`` and reads back iterations, the edge
total, AD's three counts and the traversal's :class:`Chunks` with one host
sync; nothing of B1 or B2 is launched (the kernel carries their lane
bodies).  A user-defined operator, and every float32 one, launches the
kernel of its own library (``_build.op_library``), built for it at first
use; ``dist`` holds the operator's dtype.  For CPU tensors it runs the plain version,
:func:`repro_torch.core.fused._fixed_point_plain`.
:func:`batch_fixed_point` runs K WD traversals (ROADMAP A8) as K launches
of the same kernel, one a row.  :func:`delta_fixed_point`
runs a delta-stepping traversal (ROADMAP A10) as one launch of the same
file's kernel in its delta mode (light and heavy graphs, bucket epochs
over node lists, a round of few nodes inside one block; :class:`Rounds`),
also counted in ``LAUNCHES["fused_fixed_point"]``; its CPU version is
:func:`repro_torch.core.priority._delta_fixed_point_plain`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.graph import CSRGraph
from repro_torch.core.operators import EdgeOp, value_dtype
from repro_torch.kernels import _build
from repro_torch.kernels._build import (LAUNCHES, check_dense, check_tensor,
                                        stream_of)

#: the kernel argument naming each fused lowering (``csrc/fused.cu``)
KERNEL_CODES = {"BS": 0, "WD": 1, "HP": 2, "EP": 3, "NS": 4, "AD": 5}

#: int64 cells of a launch's result (``csrc/fused.cu`` RESULT_CELLS)
RESULT_CELLS = 8
#: the most live slots a BS/NS column may have to run inside one block of
#: the fused kernel, and the most nodes (or M list entries) of a delta
#: stage that runs in one block (at most 1,024; 0: every column is a
#: grid-wide chunk and every delta stage grid-wide).  The path reads it as
#: a constant.  It is a module value, passed to each launch, only so that
#: the card tests can force the tail's and the delta rounds' cases on
#: small graphs and ``tools/fused_column_profile.py --widths`` can weigh
#: it; the width sweep's outcome is in PERF.md (1,024 within 1% of the
#: best).
TAIL_WIDTH = 1024
#: the fewest columns a one-block BS/NS tail takes: it costs two grid
#: barriers of its own (one before, one after) and saves about one a
#: column.  Passed to each launch and read by the plain loop's count
#: (``core.fused.bs_split``); the kernel holds no copy
TAIL_MIN_COLUMNS = 4
#: the most edges of a delta phase run inside one block (with at most
#: ``TAIL_WIDTH`` nodes), passed to each delta launch and read by the
#: plain loop's count (``core.fused.delta_round_split``): a narrow phase's
#: tiles of 1,024 lanes run one after another in one block, each a chain
#: of dependent gathers and atomics; 1,024 and 2,048 tie on road1024 and
#: 3,072 to 8,192 are slower (PERF.md)
NARROW_EDGES = 2 * 1024


@dataclasses.dataclass(frozen=True)
class Chunks:
    """A traversal's chunks by kind: ``grid`` chunks end at a grid barrier,
    ``block`` chunks (narrow BS/NS columns) run inside one block.  Both
    follow from the frontiers, so the plain loop counts them too;
    ``barriers`` is the kernel's count of grid barriers (``None`` from the
    plain loop) and takes no part in a comparison."""
    grid: int
    block: int
    barriers: Optional[int] = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass(frozen=True)
class Rounds:
    """A delta-stepping traversal's relax rounds by kind: ``grid`` rounds
    run on the whole grid, ``narrow`` ones (at most ``TAIL_WIDTH`` nodes
    and ``NARROW_EDGES`` edges, not NS) inside one block with no grid
    barrier.  Both follow from the rounds' frontiers, so the plain loop
    counts them too (``core.fused.delta_round_split``); ``barriers`` is
    the kernel's count of grid barriers and ``nodes`` the plain loop's
    sum of the rounds' frontier sizes (each ``None`` from the other), and
    neither takes part in a comparison.  Two add up as the rounds of
    consecutive launches (stepped epochs)."""
    grid: int
    narrow: int
    barriers: Optional[int] = dataclasses.field(default=None, compare=False)
    nodes: Optional[int] = dataclasses.field(default=None, compare=False)

    def __add__(self, other: "Rounds") -> "Rounds":
        def total(a, b):
            return None if a is None or b is None else a + b
        return Rounds(self.grid + other.grid, self.narrow + other.narrow,
                      total(self.barriers, other.barriers),
                      total(self.nodes, other.nodes))


def fixed_point(kernel: str, graph: CSRGraph, aux: Optional[torch.Tensor],
                dist: torch.Tensor, mask: torch.Tensor, *, op: EdgeOp,
                sched, max_iterations: int, coeffs=None):
    """Run ``kernel`` (a :data:`KERNEL_CODES` name) on ``graph`` from the
    values ``dist`` and frontier ``mask`` to the fixed point, or for at
    most ``max_iterations`` iterations.  ``aux`` is EP's per-edge source
    ids or NS's child -> parent map (else ``None``); ``sched`` the
    resolved :class:`~repro_torch.core.schedule.Schedule`; ``coeffs``
    measured AD's ``[3, 3]`` float32 cost model (else ``None``: the fixed
    tree).  Returns ``(dist, iterations, edges_relaxed, [BS, WD, HP]
    counts of AD's choices, Chunks)``; the inputs are not modified."""
    if kernel not in KERNEL_CODES:
        raise ValueError(f"unknown fused kernel {kernel!r}")
    if dist.device.type == "cpu":
        from repro_torch.core.fused import _fixed_point_plain
        return _fixed_point_plain(kernel, graph, aux, dist, mask, op=op,
                                  sched=sched, max_iterations=max_iterations,
                                  coeffs=coeffs)
    if dist.device.type != "cuda":
        raise ValueError(f"no fused_fixed_point for device {dist.device}")
    dev = dist.device
    n, e = graph.num_nodes, graph.num_edges
    check_tensor("dist", dist, dev, value_dtype(op), n)
    check_tensor("mask", mask, dev, torch.bool, n)
    if kernel in ("EP", "NS"):
        check_tensor("aux", aux, dev, torch.int32, e if kernel == "EP" else n)
    _check_graph(graph, dev)
    out = torch.empty_like(dist)
    workspace, result = _workspace(n, dev)
    _launch(kernel, graph, aux, dist, mask, out, workspace, result[0], op=op,
            sched=sched, max_iterations=max_iterations, coeffs=coeffs)
    it, edges, *chosen, grid, block, barriers = result[0].tolist()  # sync
    return out, it, edges, chosen, Chunks(grid, block, barriers)


def batch_fixed_point(graph: CSRGraph, dist: torch.Tensor,
                      mask: torch.Tensor, *, op: EdgeOp, sched,
                      max_iterations: int):
    """K WD traversals from the rows of ``dist [K, N]`` and ``mask
    [K, N]`` to the batch's fixed point (while any row's frontier is
    live).  For CUDA tensors one launch of the persistent kernel a row,
    each a WD traversal, queued back to back and read with one host sync:
    rows never interact, and a row whose frontier empties early only
    idles in the batch's loop, so the iterations are the rows' maximum and
    the edges their sum.  (One launch over all K
    rows, a flat ``[K, N]`` frontier, measured 1.39x slower at K = 8 on
    the H100: PERF.md.)  For CPU tensors the plain loop
    :func:`repro_torch.core.fused._batch_fixed_point_plain`.
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
    check_dense("dist", dist, dev, value_dtype(op), (k, graph.num_nodes))
    check_dense("mask", mask, dev, torch.bool, (k, n))
    _check_graph(graph, dev)
    out = torch.empty_like(dist)
    workspace, result = _workspace(n, dev, k)
    for r in range(k):
        _launch("WD", graph, None, dist[r], mask[r], out[r], workspace,
                result[r], op=op, sched=sched, max_iterations=max_iterations)
    cells = result.tolist()                         # the one host sync
    return (out, max((c[0] for c in cells), default=0),
            sum(c[1] for c in cells))


def _check_graph(graph: CSRGraph, dev: torch.device) -> None:
    n, e = graph.num_nodes, graph.num_edges
    check_tensor("row_ptr", graph.row_ptr, dev, torch.int32, n + 1)
    check_tensor("col", graph.col, dev, torch.int32, e)
    if graph.wt is not None:
        check_tensor("wt", graph.wt, dev, torch.int32, e)
    if n == 0:
        raise ValueError("fused_fixed_point needs a graph with nodes")


def _workspace(values: int, dev: torch.device, launches: int = 1,
               delta: bool = False):
    """A launch's workspace (``delta``: with the delta mode's lists),
    which launches in turn on one stream share, and ``[launches,
    RESULT_CELLS]`` int64 result cells."""
    nbytes = ctypes.c_longlong()
    with torch.cuda.device(dev):
        _build.check("fused_workspace_bytes",
                     _build.lib().repro_fused_workspace_bytes(
                         values, int(delta), NARROW_EDGES if delta else 0,
                         ctypes.byref(nbytes)))
    return (torch.empty(nbytes.value, dtype=torch.uint8, device=dev),
            torch.empty((launches, RESULT_CELLS), dtype=torch.int64,
                        device=dev))


def _coeff_array(coeffs):
    """Measured AD's coefficients as the kernel reads them (9 float32,
    row-major), or ``None`` for the fixed tree."""
    if coeffs is None:
        return None
    c = np.ascontiguousarray(coeffs, np.float32).reshape(-1)
    if c.size != 9:
        raise ValueError(f"coeffs must be [3, 3], got {np.shape(coeffs)}")
    return (ctypes.c_float * 9)(*c.tolist())


def _launch(kernel: str, graph: CSRGraph, aux, dist, mask, out, workspace,
            result, *, op: EdgeOp, sched, max_iterations: int,
            coeffs=None) -> None:
    """Enqueue one cooperative launch over ``graph``'s nodes (contiguous
    ``dist``/``mask``/``out``, a :func:`_workspace`); ``result`` (int64
    ``[RESULT_CELLS]``) receives iterations, the edge total, AD's three
    counts, the grid-wide and block-local chunks and the grid barriers.
    Does not sync."""
    lib, msg, comb = _build.op_library(op)
    dev = dist.device
    n, e = graph.num_nodes, graph.num_edges
    with torch.cuda.device(dev):
        _build.check("fused_fixed_point", lib.repro_fused_fixed_point(
            graph.row_ptr.data_ptr(), graph.col.data_ptr(),
            None if graph.wt is None else graph.wt.data_ptr(), n, e,
            None if aux is None else aux.data_ptr(), dist.data_ptr(),
            mask.data_ptr(), KERNEL_CODES[kernel], msg, comb,
            min(int(max_iterations), 2 ** 31 - 1), sched.mdt or 1,
            sched.switch_threshold, sched.small_frontier,
            sched.imbalance_threshold, sched.hp_edges_threshold, TAIL_WIDTH,
            TAIL_MIN_COLUMNS, _coeff_array(coeffs), out.data_ptr(),
            workspace.data_ptr(), workspace.numel(), result.data_ptr(),
            stream_of(dev)))
    LAUNCHES["fused_fixed_point"] += 1


def delta_fixed_point(kernel: str, light: CSRGraph,
                      heavy: Optional[CSRGraph], aux: Optional[torch.Tensor],
                      dist: torch.Tensor, mask: torch.Tensor, *, op: EdgeOp,
                      sched, delta: int, max_iterations: int):
    """A delta-stepping traversal (:mod:`repro_torch.core.priority`) of
    ``kernel`` (BS, WD, HP, NS or AD) from ``dist``/``mask`` over the
    ``light`` graph and, where it is not ``None``, the ``heavy`` one (the
    same nodes), for at most ``max_iterations`` epochs.  ``aux`` is NS's
    child -> parent map.  For CUDA tensors ONE cooperative launch of the
    fused kernel in its delta mode; for CPU tensors the plain loop.
    Returns ``(dist, mask, epochs, relax_rounds, edges_relaxed, last
    bucket settled, frontier count, Rounds)``; the inputs are not
    modified."""
    if kernel not in ("BS", "WD", "HP", "NS", "AD"):
        raise ValueError(f"kernel {kernel!r} has no delta-stepping phase")
    if dist.device.type == "cpu":
        from repro_torch.core.priority import _delta_fixed_point_plain
        return _delta_fixed_point_plain(
            kernel, light, heavy, aux, dist, mask, delta=delta, op=op,
            sched=sched, max_iterations=max_iterations)
    if dist.device.type != "cuda":
        raise ValueError(f"no fused_fixed_point for device {dist.device}")
    if not op.idempotent:
        raise ValueError(f"delta-stepping needs an idempotent operator, "
                         f"got {op.name!r}")
    dev = dist.device
    n = light.num_nodes
    check_tensor("dist", dist, dev, value_dtype(op), n)
    check_tensor("mask", mask, dev, torch.bool, n)
    _check_graph(light, dev)
    if heavy is not None:
        _check_graph(heavy, dev)
        if heavy.num_nodes != n or heavy.num_edges == 0:
            raise ValueError("the heavy graph must have the light graph's "
                             "nodes and at least one edge")
    if kernel == "NS":
        check_tensor("aux", aux, dev, torch.int32, n)
    lib, msg, comb = _build.op_library(op)
    workspace, result = _workspace(n, dev, delta=True)
    out = torch.empty_like(dist)
    out_mask = torch.empty_like(mask)

    def ptr(t):
        return None if t is None else t.data_ptr()

    h_row_ptr, h_col, h_wt, h_e = ((None, None, None, 0) if heavy is None
                                   else (heavy.row_ptr, heavy.col, heavy.wt,
                                         heavy.num_edges))
    with torch.cuda.device(dev):
        _build.check("fused_delta", lib.repro_fused_delta(
            light.row_ptr.data_ptr(), light.col.data_ptr(), ptr(light.wt),
            light.num_edges, ptr(h_row_ptr), ptr(h_col), ptr(h_wt), h_e, n,
            ptr(aux), dist.data_ptr(), mask.data_ptr(), KERNEL_CODES[kernel],
            msg, comb, int(delta), min(int(max_iterations), 2 ** 31 - 1),
            sched.mdt or 1, sched.switch_threshold, sched.small_frontier,
            sched.imbalance_threshold, sched.hp_edges_threshold, TAIL_WIDTH,
            TAIL_MIN_COLUMNS, NARROW_EDGES, out.data_ptr(),
            out_mask.data_ptr(), workspace.data_ptr(), workspace.numel(),
            result.data_ptr(), stream_of(dev)))
    LAUNCHES["fused_fixed_point"] += 1
    epochs, edges, rounds, b, count, grid, narrow, barriers = (
        result[0].tolist())                                 # host sync
    return (out, out_mask, epochs, rounds, edges, b, count,
            Rounds(grid, narrow, barriers))


def ad_choice_probe(coeffs, count: torch.Tensor,
                    degree_sum: torch.Tensor) -> torch.Tensor:
    """The fused kernel's measured AD selector alone: for each pair of
    ``count [m]`` and ``degree_sum [m]`` (int32), the branch (0 BS, 1 WD,
    2 HP) the ``[3, 3]`` cost model ``coeffs`` picks.  For CUDA tensors
    one launch of a probe kernel around ``csrc/fused.cu``'s
    ``ad_choice``; for CPU tensors
    :func:`repro_torch.core.fused._measured_choice`."""
    if count.device.type == "cpu":
        from repro_torch.core.fused import _measured_choice
        return torch.tensor(
            [_measured_choice(coeffs, c, d) for c, d in
             zip(count.tolist(), degree_sum.tolist())], dtype=torch.int32)
    dev = count.device
    m = count.numel()
    check_tensor("count", count, dev, torch.int32)
    check_tensor("degree_sum", degree_sum, dev, torch.int32, m)
    out = torch.empty(m, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.check("ad_choice_probe",
                     _build.lib().repro_fused_ad_choice_probe(
                         _coeff_array(coeffs), count.data_ptr(),
                         degree_sum.data_ptr(), m, out.data_ptr(),
                         stream_of(dev)))
    LAUNCHES["ad_choice_probe"] += 1
    return out


def barrier_probe(k: int, device) -> None:
    """``k`` grid barriers and nothing else, by a cooperative grid the size
    of the fused kernel's: the barrier's cost alone, timed by the caller
    (CUDA events).  Card only."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"barrier_probe runs on a CUDA device, not {dev}")
    bar = torch.zeros(16, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.check("barrier_probe", _build.lib().repro_fused_barrier_probe(
            int(k), bar.data_ptr(), stream_of(dev)))
    LAUNCHES["barrier_probe"] += 1
