"""User-defined operators through the port's engines against the
reference's, on the CPU: ``(dist, iterations, edges_relaxed)`` bit for
bit, for the reference's slack operator (an ``update`` predicate), a
weight penalty above ``T`` (``weight_additive``), a budget spent along
the path (max, ``value_min`` 0) and the reference's longest-path DAG
operator (``tests/test_operators.py``), through all six strategies
stepped and fused, K = 4 batches, delta-stepping and a two-shard lockstep
run.  The reference runs ``backend="xla"``; on the card the same
operators run the kernels built for them (``tests/test_torch_cuda.py``,
``chip_smoke.py``'s custom_ops phase)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import multi_source as jms
from repro.core import operators as jops
from repro.core.graph import CSRGraph as JaxCSRGraph
from repro.data import graphs as jgraphs
from repro_torch.core import engine
from repro_torch.core import operators as tops
from repro_torch.core.engine import reference_distances
from repro_torch.core.graph import CSRGraph
from repro_torch.core.strategies import make_strategy

#: the penalty's weight threshold, inside rmat's weights [1, 100]
T = 50


def _layered_dag(seed=0):
    """``tests/test_operators.py``'s layered DAG."""
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


def _port(jg) -> CSRGraph:
    return CSRGraph.from_arrays(
        np.asarray(jg.row_ptr), np.asarray(jg.col),
        None if jg.wt is None else np.asarray(jg.wt), device="cpu")


JAX_GRAPHS = {
    "rmat": jgraphs.rmat_graph(scale=8, edge_factor=8, weighted=True,
                               seed=7),
    "road": jgraphs.road_grid_graph(side=12, weighted=True, seed=4),
    "dag": _layered_dag(),
}
GRAPHS = {name: _port(jg) for name, jg in JAX_GRAPHS.items()}
SOURCES = {"rmat": int(np.argmax(np.asarray(JAX_GRAPHS["rmat"].degrees))),
           "road": 5, "dag": 0}

#: the budget: the median finite distance from rmat's source
_D = reference_distances(GRAPHS["rmat"], SOURCES["rmat"])
BUDGET = int(np.median(_D[_D < tops.INF]))


def _pair(name, combine, identity, source_value, jmessage, tmessage,
          jupdate=None, tupdate=None, **kw):
    """The same operator for both packages."""
    return (jops.EdgeOp(name=name, combine=combine, identity=identity,
                        source_value=source_value, message=jmessage,
                        update=jupdate, **kw),
            tops.EdgeOp(name=name, combine=combine, identity=identity,
                        source_value=source_value, message=tmessage,
                        update=tupdate, **kw))


#: name -> (reference op, port op, graph)
OPS = {
    "slack": (*_pair("slack", "min", tops.INF, 0, lambda v, w: v + w,
                     lambda v, w: v + w,
                     jupdate=lambda cand, cur: cand + 2 < cur,
                     tupdate=lambda cand, cur: cand + 2 < cur), "rmat"),
    "penalty": (*_pair(
        "penalty", "min", tops.INF, 0,
        lambda v, w: jnp.where(w > T, v + 2 * w, v + w),
        lambda v, w: torch.where(w > T, v + 2 * w, v + w),
        weight_additive=True), "rmat"),
    "budget": (*_pair(
        "budget", "max", 0, BUDGET,
        lambda v, w: jnp.maximum(v - w, 0),
        lambda v, w: (v - w).clamp(min=0), value_min=0), "rmat"),
    "longest": (*_pair("longest", "max", -1, 0, jops._sum_message,
                       lambda v, w: v + w), "dag"),
}

STRATEGIES = ["BS", "EP", "WD", "NS", "HP", "AD"]


def _same(got, want):
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    assert got.dist.dtype == np.int32
    assert (got.iterations, got.edges_relaxed) == (want.iterations,
                                                   want.edges_relaxed)


@functools.lru_cache(maxsize=None)
def _reference(opname, strategy, mode, schedule="bsp", gname=None):
    jop, _, g = OPS[opname]
    g = gname or g
    return jengine.run(JAX_GRAPHS[g], SOURCES[g],
                       jengine.make_strategy(strategy), op=jop, mode=mode,
                       schedule=schedule)


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("opname", list(OPS))
def test_engines_match_reference(opname, strategy, mode):
    _, top, g = OPS[opname]
    got = engine.run(GRAPHS[g], SOURCES[g], make_strategy(strategy), op=top,
                     mode=mode, device="cpu")
    want = _reference(opname, strategy, mode)
    _same(got, want)
    assert got.iterations > 1


def test_operators_compute_what_they_say():
    """The oracles: penalty is Dijkstra over the penalised weights,
    budget is max(B - d, 0), longest path is the DAG's DP; slack keeps
    values no smaller than the true distances."""
    g = GRAPHS["rmat"]
    src = SOURCES["rmat"]
    wt = g.wt.numpy()
    pen = CSRGraph.from_arrays(g.row_ptr.numpy(), g.col.numpy(),
                               np.where(wt > T, 2 * wt, wt), device="cpu")
    runs = {name: engine.run(GRAPHS[OPS[name][2]],
                             SOURCES[OPS[name][2]], make_strategy("WD"),
                             op=OPS[name][1], mode="fused", device="cpu")
            for name in OPS}
    np.testing.assert_array_equal(runs["penalty"].dist,
                                  reference_distances(pen, src))
    d = reference_distances(g, src).astype(np.int64)
    np.testing.assert_array_equal(runs["budget"].dist,
                                  np.maximum(BUDGET - d, 0))
    assert (runs["slack"].dist >= d).all()
    dag = GRAPHS["dag"]
    ref = np.full(dag.num_nodes, -1, np.int64)
    ref[0] = 0
    rp, col, w = dag.row_ptr.numpy(), dag.col.numpy(), dag.wt.numpy()
    for u in range(dag.num_nodes):
        if ref[u] >= 0:
            for e in range(rp[u], rp[u + 1]):
                ref[col[e]] = max(ref[col[e]], ref[u] + w[e])
    np.testing.assert_array_equal(runs["longest"].dist, ref)


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("opname", list(OPS))
def test_batch_matches_reference(opname, mode):
    """K = 4 (a duplicate source among them), stepped (B1's union
    contract) and fused (one traversal a row)."""
    jop, top, g = OPS[opname]
    sources = [SOURCES[g], 0, 3, 3]
    want = jms.run_batch(JAX_GRAPHS[g], sources, mode=mode, op=jop)
    got = engine.run_batch(GRAPHS[g], sources, mode=mode, op=top,
                           device="cpu")
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    assert (got.iterations, got.edges_relaxed) == (want.iterations,
                                                   want.edges_relaxed)


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("strategy", ["BS", "WD", "NS", "HP", "AD"])
def test_delta_penalty_matches_reference(strategy, mode):
    """``schedule="delta"`` with the penalty (weight-additive: its heavy
    edges are deferred) on road12: the reference's dist, epochs and
    edges, and Dijkstra over the penalised weights."""
    _, top, _ = OPS["penalty"]
    got = engine.run(GRAPHS["road"], SOURCES["road"],
                     make_strategy(strategy), op=top, mode=mode,
                     schedule="delta", device="cpu")
    _same(got, _reference("penalty", strategy, mode, "delta", "road"))
    g = GRAPHS["road"]
    wt = g.wt.numpy()
    pen = CSRGraph.from_arrays(g.row_ptr.numpy(), g.col.numpy(),
                               np.where(wt > T, 2 * wt, wt), device="cpu")
    np.testing.assert_array_equal(got.dist,
                                  reference_distances(pen, SOURCES["road"]))


@pytest.mark.parametrize("opname", ["slack", "penalty"])
@pytest.mark.parametrize("strategy", ["BS", "WD", "HP", "NS"])
def test_two_shards_match_one_device(opname, strategy):
    """A two-shard lockstep run equals the reference's single-device fused
    run (its own sharded engine fails under jax 0.9, ROADMAP queue C)."""
    _, top, g = OPS[opname]
    got = engine.run(GRAPHS[g], SOURCES[g], make_strategy(strategy),
                     op=top, mode="fused", shards=2, device="cpu")
    _same(got, _reference(opname, strategy, "fused"))
    assert got.shards == 2
