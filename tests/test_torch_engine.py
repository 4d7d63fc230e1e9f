"""The port's stepped engine as a whole against the JAX reference, on the
CPU: ``(dist, iterations, edges_relaxed)``, the per-iteration accounting
and AD's kernel choices must equal the reference's stepped runs for WD,
BS, HP (with forced sub-iterations and the WD tail) and AD, through
``sssp``, ``bfs`` and ``engine.run`` with every built-in operator."""

import numpy as np
import pytest
import torch

from repro.algos import bfs as jax_bfs
from repro.algos import sssp as jax_sssp
from repro.core import engine as jengine
from repro.core.graph import CSRGraph as JaxCSRGraph
from repro.data import graphs as jgraphs
from repro_torch.algos import bfs, sssp
from repro_torch.core import engine
from repro_torch.core.graph import CSRGraph
from repro_torch.core.strategies import make_strategy, strategy_capabilities

STRATEGIES = ["WD", "BS", "HP", "AD"]


def _layered_dag(seed=0):
    """Level-layered DAG — reach_count's convergence domain (the
    reference's operator tests use the same construction)."""
    rng = np.random.default_rng(seed)
    layers, start = [], 0
    for w in (1, 3, 4, 3, 2):
        layers.append(np.arange(start, start + w))
        start += w
    src, dst = [], []
    for a, b in zip(layers[:-1], layers[1:]):
        for u in a:
            picks = b[rng.random(len(b)) < 0.7]
            if len(picks) == 0:
                picks = b[:1]
            src.extend([u] * len(picks))
            dst.extend(picks)
    return JaxCSRGraph.from_edges(np.array(src), np.array(dst),
                                  rng.integers(1, 10, len(src)), start)


JAX_GRAPHS = {
    "rmat": jgraphs.rmat_graph(scale=9, edge_factor=8, weighted=True, seed=1),
    "road": jgraphs.road_grid_graph(side=12, weighted=True, seed=4),
    "er": jgraphs.erdos_renyi_graph(scale=8, edge_factor=4, weighted=True,
                                    seed=3),
    "graph500": jgraphs.graph500_graph(scale=8, edge_factor=16,
                                       weighted=True, seed=11),
    "dag": _layered_dag(),
}


def _port(jg) -> CSRGraph:
    return CSRGraph.from_arrays(np.asarray(jg.row_ptr), np.asarray(jg.col),
                                np.asarray(jg.wt), device="cpu")


GRAPHS = {name: _port(jg) for name, jg in JAX_GRAPHS.items()}


def _source(name) -> int:
    return 0 if name == "dag" else int(np.argmax(np.asarray(
        JAX_GRAPHS[name].degrees)))


def _trace(r):
    return [(s.frontier_size, s.edges_processed, s.sub_iterations, s.kernel)
            for s in r.iter_stats]


def _assert_same_run(got, want):
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    assert got.dist.dtype == np.int32
    assert got.iterations == want.iterations
    assert got.edges_relaxed == want.edges_relaxed
    assert _trace(got) == _trace(want)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX results, each computed once per module."""
    cache = {}

    def get(key, fn):
        if key not in cache:
            cache[key] = fn()
        return cache[key]
    return get


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("gname", ["rmat", "road", "er", "graph500"])
def test_sssp_matches_reference(gname, strategy, jax_runs):
    src = _source(gname)
    want = jax_runs(("sssp", gname, strategy),
                    lambda: jax_sssp(JAX_GRAPHS[gname], src,
                                     strategy=strategy))
    _assert_same_run(sssp(GRAPHS[gname], src, strategy=strategy,
                          device="cpu"), want)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("gname", ["rmat", "road"])
def test_bfs_matches_reference(gname, strategy, jax_runs):
    src = _source(gname)
    want = jax_runs(("bfs", gname, strategy),
                    lambda: jax_bfs(JAX_GRAPHS[gname], src,
                                    strategy=strategy))
    _assert_same_run(bfs(GRAPHS[gname], src, strategy=strategy,
                         device="cpu"), want)


@pytest.mark.parametrize("algo", ["sssp", "bfs"])
def test_hp_forced_sub_iterations_and_wd_tail(algo, jax_runs):
    """switch_threshold=4, mdt=3 makes HP run several [cap, 3] tiles per
    iteration and finish each with the cursor-aware WD tail."""
    jfn, tfn = (jax_sssp, sssp) if algo == "sssp" else (jax_bfs, bfs)
    src = _source("rmat")
    want = jax_runs(("hp", algo), lambda: jfn(
        JAX_GRAPHS["rmat"], src, strategy="HP", switch_threshold=4, mdt=3))
    got = tfn(GRAPHS["rmat"], src, strategy="HP", switch_threshold=4, mdt=3,
              device="cpu")
    _assert_same_run(got, want)
    assert max(s.sub_iterations for s in got.iter_stats) > 2


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("opname", ["min_label", "widest_path",
                                    "reach_count"])
def test_engine_run_operators_match_reference(opname, strategy, jax_runs):
    gname = "dag" if opname == "reach_count" else "rmat"
    src = _source(gname)

    def ref():
        strat = jengine.make_strategy(strategy)
        r = jengine.run(JAX_GRAPHS[gname], src, strat, op=opname)
        return r, getattr(strat, "kernel_counts", None)
    want, want_counts = jax_runs(("op", opname, strategy), ref)
    strat = make_strategy(strategy)
    got = engine.run(GRAPHS[gname], src, strat, op=opname, device="cpu")
    _assert_same_run(got, want)
    assert getattr(strat, "kernel_counts", None) == want_counts
    assert got.work_schedule.to_json() == want.work_schedule.to_json()


@pytest.mark.parametrize("gname,kwargs,kernels", [
    ("graph500", {}, {"BS", "WD"}),
    # thresholds low enough for these small graphs to reach HP too
    ("rmat", dict(hp_edges_threshold=256, small_frontier=4),
     {"BS", "WD", "HP"}),
])
def test_ad_kernel_counts_match_reference(gname, kwargs, kernels, jax_runs):
    src = _source(gname)

    def ref():
        strat = jengine.make_strategy("AD", **kwargs)
        r = jengine.run(JAX_GRAPHS[gname], src, strat)
        return r, strat.kernel_counts
    want, want_counts = jax_runs(("ad-counts", gname), ref)
    strat = make_strategy("AD", **kwargs)
    got = engine.run(GRAPHS[gname], src, strat, device="cpu")
    _assert_same_run(got, want)
    assert strat.kernel_counts == want_counts
    assert set(want_counts) == kernels


@pytest.mark.parametrize("gname", ["rmat", "road", "dag"])
def test_reference_distances_match(gname):
    src = _source(gname)
    np.testing.assert_array_equal(
        engine.reference_distances(GRAPHS[gname], src),
        jengine.reference_distances(JAX_GRAPHS[gname], src))


def test_result_fields():
    r = sssp(GRAPHS["road"], 0, device="cpu")
    assert r.device == "cpu" and r.mode == "stepped" and r.strategy == "WD"
    assert r.relax_rounds == r.iterations and r.mteps >= 0.0
    assert r.state_bytes == GRAPHS["road"].device_bytes()


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sssp(GRAPHS["road"], 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bfs(GRAPHS["road"], 0, strategy="BS")


@pytest.mark.parametrize("kwargs", [dict(mode="fused"), dict(shards=2),
                                    dict(schedule="delta")])
def test_later_slices_raise_not_implemented(kwargs):
    """The later slices have landed: ``mode="fused"`` (A7) runs, equal to
    the stepped run; ``schedule="delta"`` (A10) runs, equal to the
    reference's delta run; ``shards=`` (A11) raises the reference's
    ``ValueError`` in stepped mode and, fused, runs equal to the
    reference's single-device fused run."""
    if kwargs.get("schedule") == "delta":
        got = engine.run(GRAPHS["road"], 0, make_strategy("WD"),
                         device="cpu", **kwargs)
        want = jengine.run(JAX_GRAPHS["road"], 0,
                           jengine.make_strategy("WD"), **kwargs)
        np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
        assert (got.iterations, got.relax_rounds, got.edges_relaxed,
                got.delta) == (want.iterations, want.relax_rounds,
                               want.edges_relaxed, want.delta)
        assert [s.bucket for s in got.iter_stats] == [
            s.bucket for s in want.iter_stats]
        return
    if kwargs.get("mode") == "fused":
        got = engine.run(GRAPHS["road"], 0, make_strategy("WD"),
                         device="cpu", **kwargs)
        want = engine.run(GRAPHS["road"], 0, make_strategy("WD"),
                          device="cpu")
        assert got.mode == "fused" and got.iter_stats == []
        np.testing.assert_array_equal(got.dist, want.dist)
        assert (got.iterations, got.edges_relaxed) == (want.iterations,
                                                       want.edges_relaxed)
        return
    with pytest.raises(ValueError, match="mode='fused'"):
        engine.run(GRAPHS["road"], 0, make_strategy("WD"), device="cpu",
                   **kwargs)
    with pytest.raises(ValueError, match="mode='fused'"):
        jengine.run(JAX_GRAPHS["road"], 0, jengine.make_strategy("WD"),
                    **kwargs)
    got = engine.run(GRAPHS["road"], 0, make_strategy("WD"), device="cpu",
                     mode="fused", **kwargs)
    want = jengine.run(JAX_GRAPHS["road"], 0, jengine.make_strategy("WD"),
                       mode="fused")
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    assert (got.iterations, got.edges_relaxed, got.shards) == (
        want.iterations, want.edges_relaxed, 2)


def test_unported_strategies_and_options_raise():
    """Every strategy builds, with the reference's capability flags less
    PALLAS_BACKEND, which has no meaning in the port.  PRIORITY_SCHEDULE
    (A10), SHARDABLE (A11) and AD's measured cost model (A9) have
    landed."""
    from repro.core import costmodel as jcostmodel
    from repro.core import strategies as jstrategies
    from repro_torch.core import costmodel
    later = {jstrategies.PALLAS_BACKEND}
    for name in ("BS", "EP", "WD", "NS", "HP", "AD"):
        assert make_strategy(name).name == name
        assert strategy_capabilities(name) == (
            jstrategies.strategy_capabilities(name) - later)
    assert strategy_capabilities("EP") == frozenset()
    assert strategy_capabilities("NS") == frozenset(
        {"frontier_init", "priority_schedule", "shardable"})
    coeffs = np.array([[1.0, 1.0, 1.0], [0.0, 1e-3, 1e-3], [2.0, 0.0, 0.0]])
    model = costmodel.CostModel(coeffs=coeffs)
    strat = make_strategy("AD", cost_model=model)
    assert strat.cost_model is model and not strat.online
    jstrat = jengine.make_strategy(
        "AD", cost_model=jcostmodel.CostModel(coeffs=coeffs))
    got = engine.run(GRAPHS["road"], 0, strat, device="cpu")
    want = jengine.run(JAX_GRAPHS["road"], 0, jstrat)
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    assert strat.kernel_counts == jstrat.kernel_counts == {
        "WD": got.iterations}
    with pytest.raises(KeyError):
        make_strategy("XX")
    with pytest.raises(ValueError, match="weighted"):
        sssp(GRAPHS["road"].unweighted(), 0, device="cpu")
    assert strategy_capabilities("WD") == frozenset(
        {"frontier_init", "priority_schedule", "shardable"})
