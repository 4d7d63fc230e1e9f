"""The fused kernel's chunks, counted by its plain loop on the CPU: a BS or
NS iteration is one chunk per column of the frontier's max degree, a WD or
EP iteration one chunk, and :func:`repro_torch.core.fused.bs_split`
splits the columns between grid-wide chunks and one-block chunks the way
``csrc/fused.cu`` does.  The frontiers come from the reference's stepped
runs with ``record_degrees``, so the counts are held to the reference's
own iterations."""

import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.data import graphs as jgraphs
from repro_torch.core import fused
from repro_torch.core.graph import CSRGraph
from repro_torch.kernels import fused as fused_kernel
from repro_torch.kernels.fused import Chunks

JAX_GRAPHS = {
    "rmat": jgraphs.rmat_graph(scale=9, edge_factor=8, weighted=True, seed=1),
    "road": jgraphs.road_grid_graph(side=12, weighted=True, seed=4),
}


def _port(jg) -> CSRGraph:
    return CSRGraph.from_arrays(
        np.asarray(jg.row_ptr), np.asarray(jg.col),
        None if jg.wt is None else np.asarray(jg.wt), device="cpu")


def _source(jg) -> int:
    return int(np.argmax(np.asarray(jg.degrees)))


def _plain_chunks(jg, strategy: str, width: int, monkeypatch) -> tuple:
    """The port's plain fused loop of ``strategy`` from the highest-degree
    node at tail width ``width``: ``(iterations, Chunks)``."""
    from repro_torch.core.strategies import make_strategy
    monkeypatch.setattr(fused_kernel, "TAIL_WIDTH", width)
    g = _port(jg)
    strat = make_strategy(strategy)
    plan = fused._plan(strat, strat.setup(g), g)
    n = plan.graph.num_nodes
    src = _source(jg)
    dist = torch.full((n,), 2 ** 30 - 1, dtype=torch.int32)
    dist[src] = 0
    mask = torch.zeros(n, dtype=torch.bool)
    mask[src] = True
    out = fused_kernel.fixed_point(
        plan.kernel, plan.graph, plan.aux, dist, mask,
        op=fused.operators.shortest_path, sched=plan.sched,
        max_iterations=100000)
    return out[1], out[4]


def _reference_degrees(jg, strategy: str) -> list:
    """Each stepped iteration's frontier degrees from the reference
    (NS: on its split graph)."""
    r = jengine.run(jg, _source(jg), jengine.make_strategy(strategy),
                    record_degrees=True)
    return [np.asarray(st.frontier_degrees) for st in r.iter_stats]


def _split(degrees: np.ndarray, width: int) -> tuple:
    """``(grid, block)`` columns of one BS step: the kernel's rule from the
    degrees alone (numpy, independent of ``tail_start``): a tail of fewer
    than ``TAIL_MIN_COLUMNS`` columns is not taken."""
    top = int(degrees.max(initial=0))
    if width <= 0:
        return top, 0
    if (degrees >= 1).sum() <= width:
        start = 0
    else:
        start = 2
        while (degrees >= start).sum() > width:
            start *= 2
    grid = min(start, top)
    if top - grid < fused_kernel.TAIL_MIN_COLUMNS:
        grid = top
    return grid, top - grid


@pytest.mark.parametrize("width", [0, 1, 16, 1024])
@pytest.mark.parametrize("strategy", ["BS", "NS"])
@pytest.mark.parametrize("gname", list(JAX_GRAPHS))
def test_plain_chunks_are_the_reference_columns(gname, strategy, width,
                                                monkeypatch):
    """BS/NS: one chunk per column of each iteration's max frontier
    degree, summed over the reference's stepped iterations, split by the
    kernel's rule into grid-wide and one-block chunks."""
    jg = JAX_GRAPHS[gname]
    degrees = _reference_degrees(jg, strategy)
    iterations, chunks = _plain_chunks(jg, strategy, width, monkeypatch)
    assert iterations == len(degrees)
    splits = [_split(d, width) for d in degrees]
    assert chunks == Chunks(sum(g for g, _ in splits),
                            sum(b for _, b in splits))
    assert chunks.grid + chunks.block == sum(int(d.max(initial=0))
                                             for d in degrees)
    assert chunks.barriers is None
    if width == 0:
        assert chunks.block == 0
    if width == 1024:
        assert chunks.block > 0


@pytest.mark.parametrize("strategy", ["WD", "EP"])
@pytest.mark.parametrize("gname", list(JAX_GRAPHS))
def test_plain_chunks_are_one_a_wd_or_ep_iteration(gname, strategy,
                                                   monkeypatch):
    jg = JAX_GRAPHS[gname]
    r = jengine.run(jg, _source(jg), jengine.make_strategy(strategy))
    iterations, chunks = _plain_chunks(jg, strategy, 1024, monkeypatch)
    assert iterations == r.iterations
    assert chunks == Chunks(r.iterations, 0)


def test_tail_start_rule():
    """0 when at most ``width`` slots have edges; else the least power of
    two D with at most ``width`` slots of degree >= D; no tail at width
    0.  The result is a column from which every column has at most
    ``width`` live slots."""
    deg = torch.tensor([0, 0, 3, 1, 9, 40, 40, 2, 17, 5], dtype=torch.int32)
    assert fused.tail_start(deg, 0) == 1 << 31
    assert fused.tail_start(deg, 8) == 0         # 8 slots have edges
    assert fused.tail_start(deg, 7) == 2         # degree >= 2: 7 slots
    assert fused.tail_start(deg, 5) == 4         # >= 4: 5 slots
    assert fused.tail_start(deg, 3) == 16        # >= 8: 4, >= 16: 3
    assert fused.tail_start(deg, 2) == 32        # >= 32: 2
    assert fused.tail_start(deg, 1) == 64        # past every degree
    for width in range(1, 10):
        start = fused.tail_start(deg, width)
        assert int((deg > start).sum()) <= width
    assert fused.tail_start(torch.zeros(4, dtype=torch.int32), 1) == 0


def test_bs_split_takes_a_tail_of_at_least_four_columns(monkeypatch):
    """A one-block tail shorter than ``TAIL_MIN_COLUMNS`` columns runs
    grid-wide: it would cost more barriers than it saves."""
    monkeypatch.setattr(fused_kernel, "TAIL_WIDTH", 8)
    assert fused_kernel.TAIL_MIN_COLUMNS == 4
    deg = torch.tensor([0, 3, 3, 1], dtype=torch.int32)
    assert fused.bs_split(deg) == (3, 0)          # 3 columns from 0
    assert fused.bs_split(deg + deg) == (0, 6)    # 6 columns from 0
    wide = torch.tensor([1] * 9 + [2, 40], dtype=torch.int32)
    assert fused.bs_split(wide) == (2, 38)        # >= 2: 2 slots
    assert fused.bs_split(torch.tensor([1] * 9 + [5], dtype=torch.int32)
                          ) == (5, 0)             # from 2: 3 columns
    monkeypatch.setattr(fused_kernel, "TAIL_WIDTH", 0)
    assert fused.bs_split(wide) == (40, 0)


def test_chunks_compare_without_barriers():
    """The kernel's barrier count takes no part in a comparison with the
    plain loop's chunks, which cannot count barriers."""
    assert Chunks(5, 7, barriers=40) == Chunks(5, 7)
    assert Chunks(5, 7) != Chunks(6, 6)
