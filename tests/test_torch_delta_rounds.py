"""The delta mode's relax rounds as the fused kernel splits them between the
whole grid and one block (``core.fused.delta_round_split``), and the
port's plain epoch loop held to the reference epoch by epoch, on the CPU.

The split is held to an independent count: a numpy delta-stepping of WD
phases (each round one synchronous relax of its frontier's light edges,
as WD's single merge-path chunk, then the heavy pass) gives every round's
``(nodes, edges)``; its values equal Dijkstra's and its epochs, rounds
and edges the port's.  The plain loop's ``(dist, mask, epochs, rounds,
edges, bucket, count)`` after 1, 2, 3 epochs and at the end equals the
reference's stepped epochs (``repro.core.priority.step_epoch``) and its
fused run for the operators and widths ``tests/test_torch_priority.py``
leaves out: min_label and widest_path at an explicit Δ, every strategy.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import operators as joperators
from repro.core import priority as jpriority
from repro.data import graphs as jgraphs
from repro_torch.core import engine, fused, operators, priority
from repro_torch.core.graph import INF, CSRGraph
from repro_torch.core.strategies import make_strategy
from repro_torch.kernels import fused as fused_kernel
from repro_torch.kernels.fused import Rounds

JAX_GRAPHS = {
    "road": jgraphs.road_grid_graph(side=12, weighted=True, seed=4),
    "rmat": jgraphs.rmat_graph(scale=9, edge_factor=8, weighted=True, seed=1),
}


def _port(jg) -> CSRGraph:
    return CSRGraph.from_arrays(
        np.asarray(jg.row_ptr), np.asarray(jg.col),
        None if jg.wt is None else np.asarray(jg.wt), device="cpu")


GRAPHS = {name: _port(jg) for name, jg in JAX_GRAPHS.items()}
SOURCES = {name: int(np.argmax(np.asarray(jg.degrees)))
           for name, jg in JAX_GRAPHS.items()}


def _numpy_wd_delta(g: CSRGraph, source: int, delta: int):
    """sssp by delta-stepping with WD phases in numpy, independent of the
    port: ``(dist, epochs, rounds, edges, [(nodes, edges) a round])``."""
    rp = g.row_ptr.numpy().astype(np.int64)
    col = g.col.numpy().astype(np.int64)
    wt = g.wt.numpy().astype(np.int64)
    n = g.num_nodes
    src = np.repeat(np.arange(n), np.diff(rp))
    light = wt <= delta
    heavy = not light.all()
    dist = np.full(n, INF, np.int64)
    dist[source] = 0
    mask = np.zeros(n, bool)
    mask[source] = True

    def relax(dist, sel):
        best = np.full(n, np.iinfo(np.int64).max)
        np.minimum.at(best, col[sel], dist[src[sel]] + wt[sel])
        return np.minimum(dist, best), best < dist

    epochs = rounds = edges = 0
    trail = []
    while mask.any():
        b = (np.clip(dist, 0, INF) // delta)[mask].min()
        settled = np.zeros(n, bool)
        while True:
            cur = mask & (np.clip(dist, 0, INF) // delta == b)
            if not cur.any():
                break
            settled |= cur
            mask &= ~cur
            sel = cur[src] & light
            dist, upd = relax(dist, sel)
            mask |= upd
            rounds += 1
            edges += int(sel.sum())
            trail.append((int(cur.sum()), int(sel.sum())))
        if heavy:
            sel = settled[src] & ~light
            dist, upd = relax(dist, sel)
            mask |= upd
            if sel.any():
                rounds += 1
                trail.append((int(settled.sum()), int(sel.sum())))
            edges += int(sel.sum())
        epochs += 1
    return dist, epochs, rounds, edges, trail


def _plain(g, strategy, source, op, delta, max_iterations=100000):
    """The port's plain epoch loop (the kernel wrapper on CPU tensors)."""
    strat = make_strategy(strategy)
    plan = priority.plan_delta(strat, strat.setup(g), g, op=op, delta=delta)
    n = plan.light.num_nodes
    dist = torch.full((n,), op.identity, dtype=torch.int32)
    dist[source] = op.seed(source)
    mask = torch.zeros(n, dtype=torch.bool)
    mask[source] = True
    return plan, fused_kernel.delta_fixed_point(
        plan.kernel, plan.light, plan.heavy_graph, plan.aux, dist, mask,
        op=op, sched=plan.sched, delta=plan.delta,
        max_iterations=max_iterations)


@pytest.mark.parametrize("width", [0, 4, 1024])
@pytest.mark.parametrize("delta", [None, 25])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_round_split_matches_an_independent_count(monkeypatch, gname, delta,
                                                  width):
    """The plain loop's grid-wide and narrow rounds at widths 0, 4 and
    1,024 equal a count over the numpy rounds (narrow: at most ``width``
    nodes and ``NARROW_EDGES`` edges), and ``delta_round_split`` on those
    rounds; the numpy run equals Dijkstra and the port's epochs, rounds
    and edges.  At width 4 the rounds cross the width both ways."""
    monkeypatch.setattr(fused_kernel, "TAIL_WIDTH", width)
    g, source = GRAPHS[gname], SOURCES[gname]
    plan, got = _plain(g, "WD", source, operators.shortest_path, delta)
    want, epochs, rounds, edges, trail = _numpy_wd_delta(g, source,
                                                         plan.delta)
    np.testing.assert_array_equal(want, engine.reference_distances(g, source))
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert got[2:5] == (epochs, rounds, edges)
    narrow = [width > 0 and nodes <= width
              and e <= fused_kernel.NARROW_EDGES for nodes, e in trail]
    assert got[7] == Rounds(len(trail) - sum(narrow), sum(narrow))
    assert fused.delta_round_split("WD", trail, width) == tuple(
        (got[7].grid, got[7].narrow))
    if width == 0:
        assert got[7].narrow == 0
    if width == 4:
        steps = set(zip(narrow, narrow[1:]))
        assert (True, False) in steps and (False, True) in steps


def test_round_split_rule():
    """The rule at its edges: a round of exactly ``width`` nodes and
    ``NARROW_EDGES`` edges is narrow, one more of either is not; width 0
    and NS keep every round grid-wide; no rounds, no split."""
    cap = fused_kernel.NARROW_EDGES
    rounds = [(4, cap), (5, 1), (4, cap + 1), (1, 0), (0, 0)]
    assert fused.delta_round_split("WD", rounds, 4) == (2, 3)
    assert fused.delta_round_split("BS", rounds, 5) == (1, 4)
    assert fused.delta_round_split("AD", rounds, 0) == (5, 0)
    assert fused.delta_round_split("NS", rounds, 1024) == (5, 0)
    assert fused.delta_round_split("HP", [], 1024) == (0, 0)
    assert fused.delta_round_split("WD", iter(rounds), 1024) == (1, 4)


def _reference_epochs(jg, strategy, source, op, delta, caps):
    """The reference's stepped epochs: after each cap in ``caps``, ``(dist,
    mask, epochs, rounds, edges, bucket, count)``; then its fused run's
    ``(dist, epochs, rounds, edges)``."""
    strat = jengine.make_strategy(strategy)
    jop = joperators.resolve(op)
    plan = jpriority.plan_delta(strat, strat.setup(jg), jg, op=jop,
                                delta=delta)
    n = plan.light.num_nodes
    dist = np.full(n, jop.identity, np.int32)
    dist[source] = jop.seed(source)
    mask = np.zeros(n, bool)
    mask[source] = True
    fused_run = jpriority.run_fixed_point(plan, dist, mask, op=jop)
    out, rounds, edges, epoch, b = {}, 0, 0, 0, jpriority.worklist.NO_BUCKET
    d, m = dist, mask
    while epoch < max(caps) and np.asarray(m).any():
        d, m, b, r, e = jpriority.step_epoch(plan, d, m, op=jop)
        epoch, rounds, edges = epoch + 1, rounds + r, edges + e
        if epoch in caps:
            out[epoch] = (np.asarray(d), np.asarray(m), epoch, rounds, edges,
                          b, int(np.asarray(m).sum()))
    return out, (np.asarray(fused_run[0]), *map(int, fused_run[1:]))


CASES = ([("road", s, op) for s in ("BS", "WD", "NS", "HP", "AD")
          for op in ("min_label", "widest_path")]
         + [("rmat", s, "min_label") for s in ("WD", "NS", "AD")])


@pytest.mark.parametrize("gname,strategy,opname", CASES)
def test_plain_loop_matches_reference_epoch_by_epoch(gname, strategy,
                                                     opname):
    """min_label and widest_path at Δ = 25: the plain loop capped at 1, 2
    and 3 epochs equals the reference's stepped epochs in values, mask,
    epochs, rounds, edges, the last bucket and the frontier's count, and
    uncapped equals the reference's fused run."""
    jg, g, source = JAX_GRAPHS[gname], GRAPHS[gname], SOURCES[gname]
    op = operators.OPERATORS[opname]
    caps = (1, 2, 3)
    want, whole = _reference_epochs(jg, strategy, source, opname, 25, caps)
    assert want, "the reference settled no epoch"
    for cap, (dist, mask, *counts) in want.items():
        _, got = _plain(g, strategy, source, op, 25, max_iterations=cap)
        np.testing.assert_array_equal(got[0].numpy(), dist)
        np.testing.assert_array_equal(got[1].numpy(), mask)
        assert list(got[2:7]) == counts, cap
    _, got = _plain(g, strategy, source, op, 25)
    np.testing.assert_array_equal(got[0].numpy(), whole[0])
    assert (got[2], got[3], got[4]) == whole[1:]
    assert got[7].grid + got[7].narrow == got[3]


@pytest.mark.parametrize("delta", [None, 25])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_engine_round_split_stepped_equals_fused(monkeypatch, gname, delta):
    """``RunResult.round_split`` at width 4: the stepped run's epochs add
    up to the fused run's split (grid, narrow and frontier nodes), which
    covers every relax round and equals the numpy count; a BSP run has
    none."""
    monkeypatch.setattr(fused_kernel, "TAIL_WIDTH", 4)
    g, source = GRAPHS[gname], SOURCES[gname]
    runs = [engine.run(g, source, make_strategy("WD"), mode=mode,
                       schedule="delta", delta=delta, device="cpu")
            for mode in ("stepped", "fused")]
    stepped, fused_run = (r.round_split for r in runs)
    assert stepped == fused_run and stepped.nodes == fused_run.nodes
    assert fused_run.grid + fused_run.narrow == runs[1].relax_rounds
    trail = _numpy_wd_delta(g, source, runs[1].delta)[4]
    assert fused_run == Rounds(*fused.delta_round_split("WD", trail, 4))
    assert fused_run.nodes == sum(nodes for nodes, _ in trail)
    assert engine.run(g, source, make_strategy("WD"),
                      device="cpu").round_split is None


def test_rounds_add_up():
    """Two launches' rounds add by kind; a count one side lacks stays
    unknown."""
    total = Rounds(3, 4, 10, None) + Rounds(1, 2, 5, None)
    assert (total.grid, total.narrow, total.barriers, total.nodes) == (
        4, 6, 15, None)


@pytest.mark.parametrize("module", ["repro_torch.kernels",
                                    "repro_torch.kernels.fused",
                                    "repro_torch.core.engine"])
def test_port_imports_from_any_module_first(module):
    """A fresh interpreter imports the port starting from the kernels
    package (as the build and the tools do) or from the engine, whose
    ``RunResult`` names ``kernels.fused.Rounds``."""
    proc = subprocess.run([sys.executable, "-c", f"import {module}"],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
