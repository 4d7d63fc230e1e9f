"""``engine.fixed_point``, ``connected_components``, ``widest_path`` and
the balance metrics of the port against the JAX reference, on the CPU:
CC labels and widest widths bit for bit with every strategy that
supports them, and equal to a union-find oracle and ``reference_widest``;
``fixed_point``'s ``(values, iterations, edges_relaxed)`` for a custom
seeding; the balance reports for all five strategy names."""

import numpy as np
import pytest

from repro.algos import connected_components as jax_cc
from repro.algos import widest_path as jax_widest
from repro.algos.widest import reference_widest as jax_reference_widest
from repro.core import balance as jbalance
from repro.core import engine as jengine
from repro.core.graph import CSRGraph as JaxCSRGraph
from repro.data import graphs as jgraphs
from repro_torch.algos import connected_components, reference_widest
from repro_torch.algos import widest_path
from repro_torch.core import balance, engine
from repro_torch.core.graph import INF, CSRGraph
from repro_torch.core.strategies import make_strategy

NODE_STRATEGIES = ["BS", "WD", "NS", "HP", "AD"]
ALL_STRATEGIES = ["BS", "EP", "WD", "NS", "HP", "AD"]


def union_find_labels(num_nodes: int, src, dst) -> np.ndarray:
    """Min-node-id component label per node, by union-find."""
    parent = np.arange(num_nodes)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in zip(src, dst):
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    return np.array([find(i) for i in range(num_nodes)])


def _symmetrized_rmat():
    g = jgraphs.rmat_graph(scale=8, edge_factor=8, weighted=False, seed=3)
    src = np.repeat(np.arange(g.num_nodes), np.asarray(g.degrees))
    dst = np.asarray(g.col)
    s2, d2 = np.concatenate([src, dst]), np.concatenate([dst, src])
    return JaxCSRGraph.from_edges(s2, d2, None, g.num_nodes,
                                  dedup=True), s2, d2


def _two_components():
    """Triangle {0,1,2} + pair {3,4} + isolated node 5 (undirected), as in
    tests/test_cc.py."""
    src = np.array([0, 1, 1, 2, 2, 0, 3, 4])
    dst = np.array([1, 0, 2, 1, 0, 2, 4, 3])
    return JaxCSRGraph.from_edges(src, dst, None, 6), src, dst


CC_GRAPHS = {"sym-rmat": _symmetrized_rmat(),
             "two-components": _two_components()}
WIDEST_GRAPHS = {
    "rmat": jgraphs.rmat_graph(scale=9, edge_factor=8, weighted=True,
                               seed=1),
    "road": jgraphs.road_grid_graph(side=12, weighted=True, seed=4),
}


def _port(jg) -> CSRGraph:
    return CSRGraph.from_arrays(
        np.asarray(jg.row_ptr), np.asarray(jg.col),
        None if jg.wt is None else np.asarray(jg.wt), device="cpu")


@pytest.mark.parametrize("strategy", NODE_STRATEGIES)
@pytest.mark.parametrize("gname", list(CC_GRAPHS))
def test_connected_components_match_reference_and_union_find(gname,
                                                             strategy):
    jg, src, dst = CC_GRAPHS[gname]
    got = connected_components(_port(jg), strategy=strategy, device="cpu")
    assert got.dtype == np.int32 and got.shape == (jg.num_nodes,)
    np.testing.assert_array_equal(got, np.asarray(jax_cc(jg,
                                                         strategy=strategy)))
    np.testing.assert_array_equal(got, union_find_labels(jg.num_nodes, src,
                                                         dst))


def test_connected_components_reject_edge_based():
    jg, _, _ = CC_GRAPHS["two-components"]
    with pytest.raises(ValueError, match="node strategy") as want:
        jax_cc(jg, strategy="EP")
    with pytest.raises(ValueError, match="node strategy") as got:
        connected_components(_port(jg), strategy="EP", device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("strategy", ["BS", "NS", "AD"])
def test_fixed_point_custom_init_matches_reference(strategy):
    """Three seeds at distance 0 (NS children seeded with INF, which the
    first mirror overwrites): the reference's ``(values, iterations,
    edges_relaxed)``."""
    jg = WIDEST_GRAPHS["rmat"]
    seeds = [3, 77, 200]

    def init(n_alloc):
        values = np.full(n_alloc, INF, np.int32)
        mask = np.zeros(n_alloc, bool)
        values[seeds], mask[seeds] = 0, True
        return values, mask

    want = jengine.fixed_point(jg, jengine.make_strategy(strategy), init)
    got = engine.fixed_point(_port(jg), make_strategy(strategy), init,
                             device="cpu")
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[0].dtype == np.int32 and got[0].shape == (jg.num_nodes,)
    assert (got[1], got[2]) == (want[1], want[2])


def test_fixed_point_and_later_slices_raise():
    g = _port(WIDEST_GRAPHS["road"])

    def init(n_alloc):
        return np.zeros(n_alloc, np.int32), np.ones(n_alloc, bool)
    with pytest.raises(ValueError, match="frontier_init"):
        engine.fixed_point(g, make_strategy("EP"), init, device="cpu")
    # the capability is checked before the mode: EP fused raises the same
    with pytest.raises(ValueError, match="frontier_init"):
        engine.fixed_point(g, make_strategy("EP"), init, mode="fused",
                           device="cpu")
    # mode="fused" (A7) has landed: it runs, equal to the stepped run
    got = engine.fixed_point(g, make_strategy("WD"), init, mode="fused",
                             device="cpu")
    want = engine.fixed_point(g, make_strategy("WD"), init, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    # run_batch (A8) has landed: it runs, equal to the reference's batch
    got = engine.run_batch(g, [0, 1], device="cpu")
    want = jengine.run_batch(WIDEST_GRAPHS["road"], [0, 1])
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    assert (got.iterations, got.edges_relaxed) == (want.iterations,
                                                   want.edges_relaxed)


@pytest.fixture(scope="module")
def jax_widest_runs():
    cache = {}

    def get(key, fn):
        if key not in cache:
            cache[key] = fn()
        return cache[key]
    return get


@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
@pytest.mark.parametrize("gname", list(WIDEST_GRAPHS))
def test_widest_path_matches_reference_and_oracle(gname, strategy,
                                                  jax_widest_runs):
    jg = WIDEST_GRAPHS[gname]
    g = _port(jg)
    src = int(np.argmax(np.asarray(jg.degrees)))
    want = jax_widest(jg, src, strategy=strategy)
    got = widest_path(g, src, strategy=strategy, device="cpu")
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    assert (got.iterations, got.edges_relaxed) == (want.iterations,
                                                   want.edges_relaxed)
    oracle = jax_widest_runs(gname, lambda: jax_reference_widest(jg, src))
    np.testing.assert_array_equal(reference_widest(g, src), oracle)
    np.testing.assert_array_equal(got.dist, oracle)


def _frontier_degrees():
    rng = np.random.default_rng(0)
    return {"skewed": np.concatenate([rng.integers(0, 6, 200), [150, 40]]),
            "uniform": np.full(64, 3), "empty": np.zeros(0, np.int64),
            "zeros": np.zeros(5, np.int64)}


@pytest.mark.parametrize("case", list(_frontier_degrees()))
@pytest.mark.parametrize("strategy", ["BS", "EP", "WD", "NS", "HP"])
def test_balance_reports_match_reference(strategy, case):
    deg = _frontier_degrees()[case]
    mdt = 4 if strategy in ("NS", "HP") else None
    np.testing.assert_array_equal(
        balance.per_slot_work(strategy, deg, mdt=mdt),
        jbalance.per_slot_work(strategy, deg, mdt=mdt))
    assert balance.analyze(strategy, deg, mdt=mdt).__dict__ == \
        jbalance.analyze(strategy, deg, mdt=mdt).__dict__


def test_graph_imbalance_matches_reference():
    jg = WIDEST_GRAPHS["rmat"]
    assert balance.graph_imbalance(_port(jg)).__dict__ == \
        jbalance.graph_imbalance(jg).__dict__
    with pytest.raises(ValueError):
        balance.per_slot_work("XX", np.ones(3))
