"""The port's fused fixed point (``mode="fused"``) against the reference's,
on the CPU, where it runs the plain PyTorch loop over the dense step
bodies: ``(dist, iterations, edges_relaxed)`` bit for bit with no
tolerance for all six strategies on rmat, road and ER, AD's kernel
choices, bfs/CC/widest path, the fused run equal to the port's stepped
run, the reference's validation errors, the degenerate graphs, and one
``DISPATCH_COUNTS`` step a traversal.  The reference runs
``backend="xla"``, which ``tests/test_backends.py`` holds bit-identical
to its Pallas backend."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algos import bfs as jax_bfs
from repro.algos import connected_components as jax_cc
from repro.algos import widest_path as jax_widest
from repro.core import engine as jengine
from repro.core import fused as jfused
from repro.core import multi_source as jms
from repro.core.graph import CSRGraph as JaxCSRGraph
from repro.data import graphs as jgraphs
from repro_torch.algos import bfs, connected_components, widest_path
from repro_torch.core import engine, fused, multi_source
from repro_torch.core.graph import INF, CSRGraph
from repro_torch.core.strategies import StrategyBase, make_strategy

STRATEGIES = ["BS", "EP", "WD", "NS", "HP", "AD"]

JAX_GRAPHS = {
    "rmat": jgraphs.rmat_graph(scale=9, edge_factor=8, weighted=True, seed=1),
    "road": jgraphs.road_grid_graph(side=12, weighted=True, seed=4),
    "er": jgraphs.erdos_renyi_graph(scale=8, edge_factor=4, weighted=True,
                                    seed=3),
}


def _port(jg) -> CSRGraph:
    return CSRGraph.from_arrays(
        np.asarray(jg.row_ptr), np.asarray(jg.col),
        None if jg.wt is None else np.asarray(jg.wt), device="cpu")


GRAPHS = {name: _port(jg) for name, jg in JAX_GRAPHS.items()}


def _source(gname: str) -> int:
    """The highest-degree node: a source with edges."""
    return int(np.argmax(np.asarray(JAX_GRAPHS[gname].degrees)))


def _same(got, want):
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    assert got.dist.dtype == np.int32
    assert (got.iterations, got.edges_relaxed) == (want.iterations,
                                                   want.edges_relaxed)


#: strategy cases: the six with their defaults, HP with thresholds that
#: force its tiles and cursor-aware tail at these sizes, and AD with a
#: small BS window and HP threshold, so that it takes all three kernels
CASES = {name: (name, {}) for name in STRATEGIES}
CASES["HP-tiles"] = ("HP", dict(switch_threshold=4, mdt=3))
CASES["AD-all"] = ("AD", dict(small_frontier=8, hp_edges_threshold=64,
                              mdt=3))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("gname", list(JAX_GRAPHS))
def test_fused_matches_reference(gname, case):
    strategy, kwargs = CASES[case]
    src = _source(gname)
    jstrat = jengine.make_strategy(strategy, **kwargs)
    want = jengine.run(JAX_GRAPHS[gname], src, jstrat, mode="fused")
    strat = make_strategy(strategy, **kwargs)
    got = engine.run(GRAPHS[gname], src, strat, mode="fused", device="cpu")
    _same(got, want)
    assert got.mode == "fused" and got.iter_stats == []
    assert got.kernel_seconds == got.traversal_seconds
    assert got.overhead_seconds == got.setup_seconds
    if strategy == "AD":
        assert strat.kernel_counts == jstrat.kernel_counts


def test_fused_ad_reports_the_reference_kernel_schedule():
    g, jg = GRAPHS["rmat"], JAX_GRAPHS["rmat"]
    jstrat = jengine.make_strategy("AD", small_frontier=8)
    want = jengine.run(jg, 0, jstrat, mode="fused")
    strat = make_strategy("AD", small_frontier=8)
    got = engine.run(g, 0, strat, mode="fused", device="cpu")
    _same(got, want)
    assert strat.kernel_counts == jstrat.kernel_counts
    assert sum(strat.kernel_counts.values()) == got.iterations
    assert len(strat.kernel_counts) >= 2


def _symmetrized(jg):
    src = np.repeat(np.arange(jg.num_nodes), np.asarray(jg.degrees))
    dst = np.asarray(jg.col)
    return JaxCSRGraph.from_edges(np.concatenate([src, dst]),
                                  np.concatenate([dst, src]), None,
                                  jg.num_nodes, dedup=True)


CC_GRAPH = _symmetrized(jgraphs.rmat_graph(scale=8, edge_factor=8,
                                           weighted=False, seed=3))


@pytest.mark.parametrize("strategy", ["BS", "WD", "HP", "NS"])
@pytest.mark.parametrize("algo", ["bfs", "cc", "widest"])
def test_fused_operators_match_reference(algo, strategy):
    """bfs (``shortest_path`` unweighted), CC (``min_label`` through
    ``fixed_point``) and widest path (``bottleneck``)."""
    if algo == "cc":
        want = jax_cc(CC_GRAPH, strategy=strategy, mode="fused")
        got = connected_components(_port(CC_GRAPH), strategy=strategy,
                                   mode="fused", device="cpu")
        np.testing.assert_array_equal(got, np.asarray(want))
        return
    src = _source("rmat")
    jfn, fn = (jax_bfs, bfs) if algo == "bfs" else (jax_widest, widest_path)
    want = jfn(JAX_GRAPHS["rmat"], src, strategy=strategy, mode="fused")
    got = fn(GRAPHS["rmat"], src, strategy=strategy, mode="fused",
             device="cpu")
    _same(got, want)


def test_fused_fixed_point_matches_reference():
    """A custom seeding through ``fixed_point``: values and frontier on
    NS's split allocation, returned on the original nodes."""
    jg = JAX_GRAPHS["road"]

    def init(n_alloc):
        values = np.full(n_alloc, INF, np.int32)
        mask = np.zeros(n_alloc, bool)
        values[[0, 77]], mask[[0, 77]] = 0, True
        return values, mask

    for strategy in ("NS", "HP", "AD"):
        want = jengine.fixed_point(jg, jengine.make_strategy(strategy), init,
                                   mode="fused")
        got = engine.fixed_point(_port(jg), make_strategy(strategy), init,
                                 mode="fused", device="cpu")
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        assert (got[1], got[2]) == (want[1], want[2])


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_fused_matches_stepped_in_the_port(strategy):
    g, src = GRAPHS["er"], _source("er")
    stepped = engine.run(g, src, make_strategy(strategy), device="cpu")
    got = engine.run(g, src, make_strategy(strategy), mode="fused",
                     device="cpu")
    np.testing.assert_array_equal(got.dist, stepped.dist)
    assert (got.iterations, got.edges_relaxed) == (stepped.iterations,
                                                   stepped.edges_relaxed)
    assert got.state_bytes == stepped.state_bytes


def test_fused_max_iterations_cuts_the_loop():
    jg, g, src = JAX_GRAPHS["rmat"], GRAPHS["rmat"], _source("rmat")
    for strategy in ("BS", "EP", "AD"):
        want = jengine.run(jg, src, jengine.make_strategy(strategy),
                           mode="fused", max_iterations=3)
        got = engine.run(g, src, make_strategy(strategy), mode="fused",
                         max_iterations=3, device="cpu")
        _same(got, want)
        assert got.iterations == 3


def test_fused_mode_validation():
    g = GRAPHS["road"]
    with pytest.raises(ValueError, match="mode"):
        engine.run(g, 0, make_strategy("WD"), mode="warp", device="cpu")
    with pytest.raises(ValueError, match="stepped"):
        engine.run(g, 0, make_strategy("WD"), mode="fused",
                   record_degrees=True, device="cpu")
    with pytest.raises(ValueError, match="fused lowering"):
        fused.run_fixed_point(g, g, StrategyBase(), None, None)
    # unchunked EP's duplicate-push worklist has no dense equivalent
    with pytest.raises(ValueError, match="chunked"):
        engine.run(GRAPHS["rmat"], 0, make_strategy("EP", chunked=False),
                   mode="fused", device="cpu")
    # the batched fixed point (A8) has landed: it runs, equal to the
    # reference's
    sources = np.array([0, 5, 9], np.int32)
    jd, jm = jms.init_batch(g.num_nodes, jnp.asarray(sources))
    d, m = multi_source.init_batch(g.num_nodes, torch.from_numpy(sources))
    got = fused.run_batch_fixed_point(g, d, m)
    want = jfused.run_batch_fixed_point(JAX_GRAPHS["road"], jd, jm)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1:] == want[1:]


def test_fixed_point_checks_the_capability_before_the_mode():
    """EP cannot seed an arbitrary frontier, whatever the mode; an unknown
    mode string is refused first, as in the reference."""
    g = GRAPHS["road"]

    def init(n_alloc):
        return np.zeros(n_alloc, np.int32), np.ones(n_alloc, bool)
    for mode in ("stepped", "fused"):
        with pytest.raises(ValueError, match="frontier_init"):
            engine.fixed_point(g, make_strategy("EP"), init, mode=mode,
                               device="cpu")
    with pytest.raises(ValueError, match="mode"):
        engine.fixed_point(g, make_strategy("EP"), init, mode="warp",
                           device="cpu")


def test_fused_empty_graph():
    jg = JaxCSRGraph.from_edges(np.array([], np.int64),
                                np.array([], np.int64), None, 3)
    for mode in ("stepped", "fused"):
        r = engine.run(_port(jg), 1, make_strategy("WD"), mode=mode,
                       device="cpu")
        assert r.dist[1] == 0 and r.iterations == 0 and r.mode == mode
        assert (np.delete(r.dist, 1) == INF).all()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_fused_unreachable_and_edgeless_source(strategy):
    """Node 2 has no out-edges; nodes 2 and 3 are unreachable from 0."""
    jg = JaxCSRGraph.from_edges(np.array([0, 1]), np.array([1, 0]),
                                np.array([1, 1]), 4)
    for source in (0, 2):
        want = jengine.run(jg, source, jengine.make_strategy(strategy),
                           mode="fused")
        got = engine.run(_port(jg), source, make_strategy(strategy),
                         mode="fused", device="cpu")
        _same(got, want)


def test_one_dispatch_per_traversal():
    g, src = GRAPHS["rmat"], _source("rmat")
    for strategy in STRATEGIES:
        before = dict(fused.DISPATCH_COUNTS)
        r = engine.run(g, src, make_strategy(strategy), mode="fused",
                       device="cpu")
        assert r.iterations > 1
        moved = {k: fused.DISPATCH_COUNTS[k] - before.get(k, 0)
                 for k in fused.DISPATCH_COUNTS}
        assert moved == {**{k: 0 for k in moved}, strategy: 1}
