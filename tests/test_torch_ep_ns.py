"""EP and NS of the port against the JAX reference, on the CPU: the COO
expansion, the node split, and ``(dist, iterations, edges_relaxed)`` with
the per-iteration accounting of EP (chunked and unchunked pushes, the
unchunked condensing pass) and NS through ``sssp``, ``bfs`` and
``engine.run`` with every built-in operator, bit for bit."""

import numpy as np
import pytest

from repro.algos import bfs as jax_bfs
from repro.algos import sssp as jax_sssp
from repro.core import engine as jengine
from repro.core import node_split as jnode_split
from repro.core import strategies as jstrategies
from repro.core.graph import CSRGraph as JaxCSRGraph
from repro.core.graph import expand_row_ptr as jax_expand_row_ptr
from repro.data import graphs as jgraphs
from repro_torch.algos import bfs, sssp
from repro_torch.core import engine, strategies
from repro_torch.core.graph import CSRGraph, coo_bytes, expand_row_ptr
from repro_torch.core.node_split import split_graph

#: (name, strategy kwargs) of the three runs this file holds
RUNS = {"EP": ("EP", {}), "EP-unchunked": ("EP", {"chunked": False}),
        "NS": ("NS", {})}


def _layered_dag(seed=0):
    """Level-layered DAG, reach_count's convergence domain (the
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


def _fan_graph(k=8):
    """Source 0 -> k middles -> k targets -> k sinks, complete between
    layers: in round 2 every target is improved by k edges, so the
    unchunked push would hold k³ = 512 entries > 2E = 272 and condenses.
    A DAG, so reach_count converges on it too."""
    mid, tgt, snk = (np.arange(1 + i * k, 1 + (i + 1) * k) for i in range(3))
    src = np.concatenate([np.zeros(k, int), np.repeat(mid, k),
                          np.repeat(tgt, k)])
    dst = np.concatenate([mid, np.tile(tgt, k), np.tile(snk, k)])
    wt = np.random.default_rng(5).integers(1, 10, src.size)
    return JaxCSRGraph.from_edges(src, dst, wt, 1 + 3 * k)


def _zero_degree_graph():
    """Isolated nodes first, in the middle and last, and one hub."""
    src = np.array([1, 1, 1, 1, 1, 3, 3, 5])
    dst = np.array([2, 3, 5, 6, 0, 1, 6, 2])
    wt = np.arange(1, 9)
    return JaxCSRGraph.from_edges(src, dst, wt, 8)


JAX_GRAPHS = {
    "rmat": jgraphs.rmat_graph(scale=9, edge_factor=8, weighted=True, seed=1),
    "road": jgraphs.road_grid_graph(side=12, weighted=True, seed=4),
    "er": jgraphs.erdos_renyi_graph(scale=8, edge_factor=4, weighted=True,
                                    seed=3),
    "graph500": jgraphs.graph500_graph(scale=8, edge_factor=16,
                                       weighted=True, seed=11),
    "dag": _layered_dag(),
    "fan": _fan_graph(),
    "zero-degree": _zero_degree_graph(),
}


def _port(jg) -> CSRGraph:
    return CSRGraph.from_arrays(np.asarray(jg.row_ptr), np.asarray(jg.col),
                                np.asarray(jg.wt), device="cpu")


GRAPHS = {name: _port(jg) for name, jg in JAX_GRAPHS.items()}


def _source(name) -> int:
    if name in ("dag", "fan"):
        return 0
    return int(np.argmax(np.asarray(JAX_GRAPHS[name].degrees)))


def _trace(r):
    return [(s.frontier_size, s.edges_processed, s.sub_iterations, s.kernel)
            for s in r.iter_stats]


def _assert_same_run(got, want):
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    assert got.dist.dtype == np.int32
    assert got.iterations == want.iterations
    assert got.edges_relaxed == want.edges_relaxed
    assert _trace(got) == _trace(want)
    assert got.state_bytes == want.state_bytes


@pytest.mark.parametrize("gname", list(JAX_GRAPHS))
def test_expand_row_ptr_and_to_coo_match_reference(gname):
    jg, g = JAX_GRAPHS[gname], GRAPHS[gname]
    want = np.asarray(jax_expand_row_ptr(jg.row_ptr, jg.num_edges))
    np.testing.assert_array_equal(
        expand_row_ptr(g.row_ptr, g.num_edges).numpy(), want)
    jc, c = jg.to_coo(), g.to_coo()
    for name in ("src", "dst", "wt", "row_ptr"):
        np.testing.assert_array_equal(getattr(c, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    assert (c.num_nodes, c.num_edges, c.max_degree) == (
        jc.num_nodes, jc.num_edges, jc.max_degree)
    assert c.device_bytes() == jc.device_bytes() == coo_bytes(g)
    assert c.to("cpu") is c
    unweighted = g.unweighted()
    assert coo_bytes(unweighted) == unweighted.to_coo().device_bytes()
    np.testing.assert_array_equal(unweighted.to_coo().weight_or_one().numpy(),
                                  np.ones(g.num_edges, np.int32))


@pytest.mark.parametrize("mdt", [None, 3])
@pytest.mark.parametrize("gname", ["rmat", "road", "graph500",
                                   "zero-degree"])
def test_split_graph_matches_reference(gname, mdt):
    jg, g = JAX_GRAPHS[gname], GRAPHS[gname]
    if mdt is None:
        mdt = jnode_split.find_mdt(np.asarray(jg.degrees))
    want, got = jnode_split.split_graph(jg, mdt), split_graph(g, mdt)
    for name in ("row_ptr", "col", "wt"):
        np.testing.assert_array_equal(getattr(got.graph, name).numpy(),
                                      np.asarray(getattr(want.graph, name)))
    np.testing.assert_array_equal(got.child_parent.numpy(),
                                  np.asarray(want.child_parent))
    assert (got.graph.num_nodes, got.graph.num_edges, got.graph.max_degree,
            got.num_original, got.mdt, got.num_children) == (
        want.graph.num_nodes, want.graph.num_edges, want.graph.max_degree,
        want.num_original, want.mdt, want.num_children)
    assert got.graph.max_degree <= mdt
    assert got.extract_original(got.child_parent).numel() == g.num_nodes


@pytest.fixture(scope="module")
def jax_runs():
    """JAX results, each computed once per module."""
    cache = {}

    def get(key, fn):
        if key not in cache:
            cache[key] = fn()
        return cache[key]
    return get


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("algo", ["sssp", "bfs"])
@pytest.mark.parametrize("gname", ["rmat", "road"])
def test_sssp_and_bfs_match_reference(gname, algo, run, jax_runs):
    strategy, kw = RUNS[run]
    jfn, tfn = (jax_sssp, sssp) if algo == "sssp" else (jax_bfs, bfs)
    src = _source(gname)
    want = jax_runs((algo, gname, run), lambda: jfn(
        JAX_GRAPHS[gname], src, strategy=strategy, **kw))
    _assert_same_run(tfn(GRAPHS[gname], src, strategy=strategy,
                         device="cpu", **kw), want)


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("opname", ["min_label", "widest_path",
                                    "reach_count"])
def test_engine_run_operators_match_reference(opname, run, jax_runs):
    """reach_count on the layered DAG: an unchunked EP worklist holds
    duplicate edges, and each adds its count, as in the reference."""
    strategy, kw = RUNS[run]
    gname = "dag" if opname == "reach_count" else "rmat"
    src = _source(gname)
    want = jax_runs(("op", opname, run), lambda: jengine.run(
        JAX_GRAPHS[gname], src, jengine.make_strategy(strategy, **kw),
        op=opname))
    got = engine.run(GRAPHS[gname], src, strategies.make_strategy(
        strategy, **kw), op=opname, device="cpu")
    _assert_same_run(got, want)
    assert got.work_schedule.to_json() == want.work_schedule.to_json()


@pytest.mark.parametrize("opname", ["shortest_path", "reach_count"])
def test_unchunked_ep_condensing_pass_matches_reference(opname,
                                                        monkeypatch):
    """The fan graph's round-2 worklist exceeds 2E, so both packages
    condense it (each improved node once, ascending)."""
    jg, g = JAX_GRAPHS["fan"], GRAPHS["fan"]
    want = jengine.run(jg, 0, jengine.make_strategy("EP", chunked=False),
                       op=opname)
    pushes = []
    real = strategies.ep_push_chunked

    def spy(*args, **kw):
        pushes.append(kw["cap_out"])
        return real(*args, **kw)
    monkeypatch.setattr(strategies, "ep_push_chunked", spy)
    got = engine.run(g, 0, strategies.make_strategy("EP", chunked=False),
                     op=opname, device="cpu")
    _assert_same_run(got, want)
    assert pushes, "the condensing pass did not run"
    assert max(s.frontier_size for s in got.iter_stats) <= 2 * g.num_edges


def test_memory_wall_raises_like_reference():
    """A budget of the CSR's bytes is below the COO's: both packages raise
    the same MemoryError, the port before the COO exists."""
    jg, g = JAX_GRAPHS["rmat"], GRAPHS["rmat"]
    budget = g.device_bytes()
    assert budget == jg.device_bytes() < coo_bytes(g)
    with pytest.raises(MemoryError) as want:
        jengine.run(jg, 0, jengine.make_strategy(
            "EP", memory_budget_bytes=budget))
    with pytest.raises(MemoryError) as got:
        sssp(g, 0, strategy="EP", memory_budget_bytes=budget, device="cpu")
    assert str(got.value) == str(want.value)
    assert "memory wall" in str(got.value)
    ok = sssp(g, 0, strategy="EP", memory_budget_bytes=coo_bytes(g),
              device="cpu")
    assert ok.state_bytes == coo_bytes(g)


def test_ns_state_bytes_and_schedule_match_reference():
    g = GRAPHS["rmat"]
    ns = strategies.make_strategy("NS")
    sg = ns.setup(g)
    jns = jstrategies.make_strategy("NS")
    jsg = jns.setup(JAX_GRAPHS["rmat"])
    assert ns.state_bytes(sg) == jns.state_bytes(jsg)
    assert ns.resolved_schedule.to_json() == jns.resolved_schedule.to_json()
    assert strategies.make_strategy("NS", mdt=5).setup(g).mdt == 5
