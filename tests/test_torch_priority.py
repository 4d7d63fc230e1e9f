"""The port's delta-stepping (``repro_torch.core.priority``, ROADMAP A10)
against the reference's (``repro.core.priority``, ``backend="xla"``), on
the CPU, where the fused kernel's delta mode runs its plain epoch loop:
``(dist, iterations, relax_rounds, edges_relaxed, delta)`` and the stepped
``IterStats`` bucket trail bit for bit, for BS/WD/NS/HP/AD ×
shortest_path/min_label/widest_path on road (side 12) and rmat (scale 8),
at the auto Δ and at Δ = 25 (three quarters of the road's edges heavy).
The reference's stepped and fused delta runs are equal (its own tests);
each case holds the port's stepped AND fused run to the reference's
stepped run, so one reference shape compiles per case.  Plus the
degenerate split (BSP's loop), ``fixed_point`` with a multi-source
seeding and CC, the epoch cap, the batch, the gating errors, the
``auto_delta`` clamps and the bucket helpers."""

import numpy as np
import pytest
import torch

from repro.algos import connected_components as jax_cc
from repro.core import engine as jengine
from repro.core import priority as jpriority
from repro.core import worklist as jworklist
from repro.core.graph import CSRGraph as JaxCSRGraph
from repro.data import graphs as jgraphs
from repro_torch.algos import bfs, connected_components, sssp, widest_path
from repro_torch.core import engine, fused, priority, worklist
from repro_torch.core.graph import CSRGraph
from repro_torch.core.strategies import make_strategy

JAX_GRAPHS = {
    "road": jgraphs.road_grid_graph(side=12, weighted=True, seed=4),
    "rmat": jgraphs.rmat_graph(scale=8, edge_factor=8, weighted=True, seed=1),
}


def _port(jg) -> CSRGraph:
    return CSRGraph.from_arrays(
        np.asarray(jg.row_ptr), np.asarray(jg.col),
        None if jg.wt is None else np.asarray(jg.wt), device="cpu")


GRAPHS = {name: _port(jg) for name, jg in JAX_GRAPHS.items()}
SOURCES = {name: int(np.argmax(np.asarray(jg.degrees)))
           for name, jg in JAX_GRAPHS.items()}
STRATEGIES = ("BS", "WD", "NS", "HP", "AD")
OPS = ("shortest_path", "min_label", "widest_path")


def _trail(r) -> list:
    return [(s.frontier_size, s.edges_processed, s.sub_iterations,
             s.bucket, s.kernel) for s in r.iter_stats]


def _same(got, want) -> None:
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    assert (got.iterations, got.relax_rounds, got.edges_relaxed,
            got.delta, got.schedule) == (
        want.iterations, want.relax_rounds, want.edges_relaxed, want.delta,
        want.schedule)


@pytest.mark.parametrize("gname", list(JAX_GRAPHS))
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_delta_runs_match_reference(strategy, op, gname):
    """Auto Δ (every road edge light: the aliased split), stepped and
    fused, against the reference's stepped run and its bucket trail."""
    src = SOURCES[gname]
    want = jengine.run(JAX_GRAPHS[gname], src, jengine.make_strategy(
        strategy), op=op, schedule="delta")
    for mode in ("stepped", "fused"):
        got = engine.run(GRAPHS[gname], src, make_strategy(strategy),
                         mode=mode, op=op, schedule="delta", device="cpu")
        _same(got, want)
        assert got.state_bytes == want.state_bytes
        if mode == "stepped":
            assert _trail(got) == _trail(want)
            buckets = [b for *_, b, _k in _trail(got)]
            assert buckets == sorted(set(buckets))     # strictly increasing
        else:
            assert got.iter_stats == []


@pytest.mark.parametrize("gname", list(JAX_GRAPHS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_explicit_delta_with_heavy_edges(strategy, gname):
    """Δ = 25 splits the weights 1..100: the heavy pass runs every epoch."""
    src = SOURCES[gname]
    want = jengine.run(JAX_GRAPHS[gname], src,
                       jengine.make_strategy(strategy), schedule="delta",
                       delta=25)
    for mode in ("stepped", "fused"):
        got = sssp(GRAPHS[gname], src, strategy, mode=mode,
                   schedule="delta", delta=25, device="cpu")
        _same(got, want)
        if mode == "stepped":
            assert _trail(got) == _trail(want)
    strat = make_strategy(strategy)
    state = strat.setup(GRAPHS[gname])
    plan = priority.plan_delta(strat, state, GRAPHS[gname], delta=25)
    whole = fused._plan(strat, state, GRAPHS[gname]).graph
    assert plan.heavy and plan.delta == 25
    assert plan.light.num_edges + plan.heavy_graph.num_edges == (
        whole.num_edges)
    assert int(plan.light.wt.max()) <= 25 < int(plan.heavy_graph.wt.min())


@pytest.mark.parametrize("strategy", ["WD", "NS"])
def test_degenerate_split_is_bsp(strategy):
    """Every edge light (auto Δ 198 > 100 on the road): the light graph is
    the graph itself.  With one bucket too (Δ above every distance) the
    single epoch's closure is BSP's loop: rounds, edges and values."""
    g, src = GRAPHS["road"], SOURCES["road"]
    strat = make_strategy(strategy)
    state = strat.setup(g)
    plan = priority.plan_delta(strat, state, g)
    assert plan.delta == 198 and plan.heavy_graph is None
    assert plan.light is fused._plan(strat, state, g).graph
    bsp = engine.run(g, src, make_strategy(strategy), device="cpu")
    for mode in ("stepped", "fused"):
        d = engine.run(g, src, make_strategy(strategy), mode=mode,
                       schedule="delta", delta=10 ** 6, device="cpu")
        np.testing.assert_array_equal(d.dist, bsp.dist)
        assert (d.iterations, d.relax_rounds, d.edges_relaxed) == (
            1, bsp.iterations, bsp.edges_relaxed)


@pytest.mark.parametrize("mode", ["stepped", "fused"])
def test_epoch_cap_matches_reference(mode):
    g, src = "road", SOURCES["road"]
    for cap in (1, 3):
        want = jengine.run(JAX_GRAPHS[g], src, jengine.make_strategy("HP"),
                           schedule="delta", delta=25, max_iterations=cap)
        got = engine.run(GRAPHS[g], src, make_strategy("HP"), mode=mode,
                         schedule="delta", delta=25, max_iterations=cap,
                         device="cpu")
        assert got.iterations == cap
        _same(got, want)


@pytest.mark.parametrize("mode", ["stepped", "fused"])
def test_fixed_point_multi_source_and_cc(mode):
    """``fixed_point`` from three seeds, and CC (every node its own label,
    all light), against the reference."""
    jg, g = JAX_GRAPHS["rmat"], GRAPHS["rmat"]

    def init(n_alloc):
        values = np.full(n_alloc, np.iinfo(np.int32).max // 2, np.int32)
        mask = np.zeros(n_alloc, bool)
        seeds = [0, 5, 9]
        values[seeds], mask[seeds] = 0, True
        return values, mask

    for strategy in ("WD", "NS"):
        want = jengine.fixed_point(jg, jengine.make_strategy(strategy),
                                   init, schedule="delta", delta=25)
        got = engine.fixed_point(g, make_strategy(strategy), init,
                                 mode=mode, schedule="delta", delta=25,
                                 device="cpu")
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        assert got[1:] == tuple(want[1:])
    want = jax_cc(JAX_GRAPHS["road"], strategy="HP", schedule="delta")
    got = connected_components(GRAPHS["road"], strategy="HP", mode=mode,
                               schedule="delta", device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))


def test_batch_matches_reference():
    """K rows, each its own bucket sequence: the reference's vmapped
    batch; epochs and rounds the slowest row's, edges summed; each row
    its single run."""
    jg, g = JAX_GRAPHS["road"], GRAPHS["road"]
    sources = [0, 7, 77, SOURCES["road"]]
    want = jengine.run_batch(jg, sources, mode="fused", schedule="delta",
                             delta=25)
    got = engine.run_batch(g, sources, mode="fused", schedule="delta",
                           delta=25, device="cpu")
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    assert (got.iterations, got.relax_rounds, got.edges_relaxed,
            got.delta, got.schedule, got.mode) == (
        want.iterations, want.relax_rounds, want.edges_relaxed, want.delta,
        want.schedule, want.mode)
    singles = [engine.run(g, s, make_strategy("WD"), mode="fused",
                          schedule="delta", delta=25, device="cpu")
               for s in sources]
    for row, r in zip(got.dist, singles):
        np.testing.assert_array_equal(row, r.dist)
    assert got.iterations == max(r.iterations for r in singles)
    assert got.relax_rounds == max(r.relax_rounds for r in singles)
    assert got.edges_relaxed == sum(r.edges_relaxed for r in singles)


def test_batch_entry_points_and_dispatch_counts():
    g = GRAPHS["rmat"]
    before = fused.DISPATCH_COUNTS["delta:batch"]
    from repro_torch.algos import bfs_batch, sssp_batch
    s = sssp_batch(g, [1, 2], mode="fused", schedule="delta",
                   device="cpu")
    b = bfs_batch(g, [1, 2], mode="fused", schedule="delta", pad_to=4,
                  device="cpu")
    assert fused.DISPATCH_COUNTS["delta:batch"] - before == 2
    assert s.delta == 204 and b.delta == 4 and b.pad_lanes == 2
    for i, src in enumerate([1, 2]):
        np.testing.assert_array_equal(
            s.dist[i], engine.reference_distances(g, src))
        np.testing.assert_array_equal(
            b.dist[i], engine.reference_distances(g.unweighted(), src))
    before = fused.DISPATCH_COUNTS["delta:WD"]
    engine.run(g, 1, make_strategy("WD"), mode="fused", schedule="delta",
               device="cpu")
    assert fused.DISPATCH_COUNTS["delta:WD"] - before == 1


def test_algos_take_the_schedule():
    g, src = GRAPHS["road"], SOURCES["road"]
    r = sssp(g, src, "AD", schedule="delta", delta=10, device="cpu")
    np.testing.assert_array_equal(r.dist, engine.reference_distances(g, src))
    r = bfs(g, src, "BS", mode="fused", schedule="delta", device="cpu")
    np.testing.assert_array_equal(
        r.dist, engine.reference_distances(g.unweighted(), src))
    assert r.delta == 4
    from repro_torch.algos.widest import reference_widest
    r = widest_path(g, src, "NS", schedule="delta", delta=30, device="cpu")
    np.testing.assert_array_equal(r.dist, reference_widest(g, src))


def test_measured_ad_takes_the_fixed_tree_under_delta():
    """plan_delta drops the cost model: delta phases take AD's fixed tree,
    as the reference's do."""
    from repro.core import costmodel as jcostmodel
    from repro_torch.core import costmodel
    coeffs = np.array([[1.0, 1.0, 1.0], [0.0, 0.0, 0.0], [2.0, 2.0, 2.0]])
    g, src = GRAPHS["rmat"], SOURCES["rmat"]
    want = jengine.run(JAX_GRAPHS["rmat"], src, jengine.make_strategy(
        "AD", cost_model=jcostmodel.CostModel(coeffs=coeffs)),
        schedule="delta", delta=25)
    got = engine.run(g, src, make_strategy(
        "AD", cost_model=costmodel.CostModel(coeffs=coeffs)), mode="fused",
        schedule="delta", delta=25, device="cpu")
    _same(got, want)


def test_gating_errors():
    g = GRAPHS["road"]
    with pytest.raises(ValueError, match="priority_schedule"):
        engine.run(g, 0, make_strategy("EP"), schedule="delta",
                   device="cpu")
    with pytest.raises(ValueError, match="not idempotent"):
        engine.run(g, 0, make_strategy("WD"), op="reach_count",
                   schedule="delta", device="cpu")
    with pytest.raises(ValueError, match="delta="):
        engine.run(g, 0, make_strategy("WD"), delta=5, device="cpu")
    with pytest.raises(ValueError, match="schedule must be"):
        engine.run(g, 0, make_strategy("WD"), schedule="async",
                   device="cpu")
    with pytest.raises(ValueError, match="record_degrees"):
        engine.run(g, 0, make_strategy("WD"), schedule="delta",
                   record_degrees=True, device="cpu")
    with pytest.raises(ValueError, match="delta must be"):
        engine.run(g, 0, make_strategy("WD"), schedule="delta", delta=0,
                   device="cpu")
    with pytest.raises(ValueError, match="fused-only"):
        engine.run_batch(g, [0], schedule="delta", device="cpu")
    with pytest.raises(ValueError, match="not idempotent"):
        engine.run_batch(g, [0], mode="fused", op="reach_count",
                         schedule="delta", device="cpu")
    # fixed_point checks FRONTIER_INIT first, as the reference does
    with pytest.raises(ValueError, match="frontier_init"):
        engine.fixed_point(g, make_strategy("EP"), lambda n: None,
                           schedule="delta", device="cpu")
    hp = make_strategy("HP")
    plan = priority.plan_delta(hp, hp.setup(g), g, delta=25)
    with pytest.raises(ValueError, match="WD"):
        priority.run_batch_fixed_point(plan, torch.zeros(1, g.num_nodes),
                                       torch.zeros(1, g.num_nodes,
                                                   dtype=torch.bool))
    # the reference raises the same errors in the same order
    for kw in (dict(delta=5), dict(schedule="delta", op="reach_count")):
        with pytest.raises(ValueError):
            jengine.run(JAX_GRAPHS["road"], 0, jengine.make_strategy("WD"),
                        **kw)


def test_auto_delta_clamps():
    road = GRAPHS["road"]
    jroad = JAX_GRAPHS["road"]
    assert priority.auto_delta(road) == jpriority.auto_delta(jroad) == 198
    assert priority.auto_delta(road, 1) == jpriority.auto_delta(jroad, 1)
    assert priority.auto_delta(road, 0) == jpriority.auto_delta(jroad, 0)
    assert priority.auto_delta(road.unweighted()) == 4
    assert priority.auto_delta(road.unweighted(), 0) == 1
    src, dst = np.array([0, 1]), np.array([1, 2])
    zero = CSRGraph.from_edges(src, dst, np.zeros(2, np.int32), 3,
                               device="cpu")
    jzero = JaxCSRGraph.from_edges(src, dst, np.zeros(2, np.int32), 3)
    assert priority.auto_delta(zero) == jpriority.auto_delta(jzero) == 1
    # a mean whose ×4 sits on .5: Python's round, on the float64 mean
    half = CSRGraph.from_edges(src, dst, np.array([1, 2], np.int32), 3,
                               device="cpu")
    assert priority.auto_delta(half, 3) == round(3 * 1.5) == 4


@pytest.mark.parametrize("descending", [False, True])
def test_bucket_helpers_match_reference(descending):
    rng = np.random.default_rng(3)
    vals = rng.integers(-50, 2 ** 31 - 1, 300, dtype=np.int64).astype(
        np.int32)
    vals[:5] = [0, -1, 2 ** 30 - 1, 2 ** 31 - 1, 7]
    mask = rng.random(300) < 0.3
    t = torch.from_numpy(vals)
    got = worklist.bucket_index(t, 25, descending=descending)
    want = jworklist.bucket_index(vals, 25, descending=descending)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    assert worklist.min_live_bucket(torch.from_numpy(mask), got) == int(
        jworklist.min_live_bucket(mask, want))
    empty = torch.zeros(300, dtype=torch.bool)
    assert worklist.min_live_bucket(empty, got) == worklist.NO_BUCKET == int(
        jworklist.NO_BUCKET)
