"""The port's sharded fixed points (``repro_torch.core.shard``, ROADMAP
A11) against the reference, on the CPU, where every held shard runs the
plain versions of B1/B2.

The reference's own sharded engine cannot run under the installed JAX
(its ``shard_map`` out_specs, ROADMAP queue C), and it states that a
lockstep sharded run is bit-identical to its single-device fused run.  So
the port's lockstep runs are held to the reference's single-device
``engine.run(mode="fused")`` in ``(dist, iterations, edges_relaxed)``
with no tolerance, for BS/WD/HP/NS x S in {1, 2, 3} x both partition
methods x every built-in operator (``reach_count`` on a level-layered
DAG, its convergence domain); async runs to the single-device values and
Dijkstra.  The partitioner is the reference's (numpy and ``jnp.asarray``
only, so it runs here) array for array.  One spawn of two gloo ranks,
one shard each, equals the one-process run."""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.algos import bfs as jax_bfs
from repro.algos import connected_components as jax_cc
from repro.core import engine as jengine
from repro.core import multi_source as jms
from repro.core import shard as jshard
from repro.core.graph import CSRGraph as JaxCSRGraph
from repro.data import graphs as jgraphs
from repro_torch.algos import bfs, connected_components, sssp, widest_path
from repro_torch.core import engine, fused, shard
from repro_torch.core.engine import reference_distances
from repro_torch.core.graph import CSRGraph
from repro_torch.core.strategies import (SHARDABLE, make_strategy,
                                         strategy_capabilities)

ROOT = Path(__file__).resolve().parents[1]


def _port(jg) -> CSRGraph:
    return CSRGraph.from_arrays(
        np.asarray(jg.row_ptr), np.asarray(jg.col),
        None if jg.wt is None else np.asarray(jg.wt), device="cpu")


def _layered_dag(seed=0):
    """Level-layered DAG (``tests/test_backends.py``'s): reach_count's
    documented convergence domain."""
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


def _symmetrized(jg):
    src = np.repeat(np.arange(jg.num_nodes), np.asarray(jg.degrees))
    dst = np.asarray(jg.col)
    return JaxCSRGraph.from_edges(np.concatenate([src, dst]),
                                  np.concatenate([dst, src]), None,
                                  jg.num_nodes, dedup=True)


JAX_GRAPHS = {
    "rmat": jgraphs.rmat_graph(scale=8, edge_factor=8, weighted=True,
                               seed=7),
    "road": jgraphs.road_grid_graph(side=12, weighted=True, seed=4),
    "dag": _layered_dag(),
    # a hub at node 0 with degree >= E/S
    "star": JaxCSRGraph.from_edges(np.array([0, 0, 0, 0, 1]),
                                   np.array([1, 2, 3, 4, 0]),
                                   np.ones(5, np.int64), 5),
}
GRAPHS = {name: _port(jg) for name, jg in JAX_GRAPHS.items()}


def _source(gname: str) -> int:
    return int(np.argmax(np.asarray(JAX_GRAPHS[gname].degrees)))


#: the four SHARDABLE strategies; HP with thresholds that force its tiles
#: and its cursor-aware tail at these sizes
CASES = {"BS": ("BS", {}), "WD": ("WD", {}),
         "HP": ("HP", dict(switch_threshold=4, mdt=3)), "NS": ("NS", {})}
#: S = 1 is one partition whatever the method
PARTS = [(1, "degree"), (2, "degree"), (3, "degree"), (2, "contiguous"),
         (3, "contiguous")]
OPS = ["shortest_path", "min_label", "widest_path", "reach_count"]


@functools.lru_cache(maxsize=None)
def _reference(case: str, op: str):
    """The reference's single-device fused run: rmat for the monotone
    operators, the DAG for reach_count."""
    strategy, kwargs = CASES[case]
    gname = "dag" if op == "reach_count" else "rmat"
    src = 0 if gname == "dag" else _source(gname)
    return jengine.run(JAX_GRAPHS[gname], src,
                       jengine.make_strategy(strategy, **kwargs),
                       mode="fused", op=op), gname, src


def _same(got, want):
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    assert (got.iterations, got.edges_relaxed) == (want.iterations,
                                                   want.edges_relaxed)


# ---------------------------------------------------------------------------
# the partitioner, array for array
# ---------------------------------------------------------------------------

def _same_partition(gname, num_shards, method):
    got, ginfo = shard.partition(GRAPHS[gname], num_shards, method=method)
    want, winfo = jshard.partition(JAX_GRAPHS[gname], num_shards,
                                   method=method)
    for field in ("row_ptr", "col", "wt", "node_base", "num_local"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert a.dtype == torch.int32, field
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=field)
    for field in ("num_nodes", "num_edges", "num_shards", "nodes_per_shard",
                  "edges_per_shard"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.device_bytes() == want.device_bytes()
    for field in ("boundaries", "nodes", "edges", "cut_edges"):
        np.testing.assert_array_equal(getattr(ginfo, field),
                                      getattr(winfo, field), err_msg=field)
    assert ginfo.method == winfo.method
    assert len(ginfo.ghosts) == len(winfo.ghosts)
    for a, b in zip(ginfo.ghosts, winfo.ghosts):
        np.testing.assert_array_equal(a, b)
    for field in ("num_shards", "cut_share", "halo_total", "halo_bytes",
                  "edge_imbalance"):
        assert getattr(ginfo, field) == getattr(winfo, field), field


@pytest.mark.parametrize("method", ["degree", "contiguous"])
@pytest.mark.parametrize("num_shards", [1, 2, 3, 8])
@pytest.mark.parametrize("gname", ["rmat", "road"])
def test_partition_matches_reference(gname, num_shards, method):
    _same_partition(gname, num_shards, method)


@pytest.mark.parametrize("method", ["degree", "contiguous"])
def test_partition_leading_hub_and_more_shards_than_nodes(method):
    """A hub at node 0 with degree >= E/S keeps its own shard; 8 shards of
    a 5-node graph leave empty shards riding along, as in the
    reference."""
    for num_shards in (3, 8):
        _same_partition("star", num_shards, method)
    _, info = shard.partition(GRAPHS["star"], 3, method="degree")
    assert info.edges.max() == 4 and (info.nodes > 0).sum() >= 2
    sharded, info = shard.partition(GRAPHS["star"], 8, method=method)
    assert sharded.num_shards == 8 and info.nodes.sum() == 5


def test_partition_validation():
    for bad in (dict(num_shards=0), dict(num_shards=2, method="metis")):
        with pytest.raises(ValueError) as got:
            shard.partition(GRAPHS["rmat"], **bad)
        with pytest.raises(ValueError) as want:
            jshard.partition(JAX_GRAPHS["rmat"], **bad)
        assert str(got.value).split()[:2] == str(want.value).split()[:2]


# ---------------------------------------------------------------------------
# lockstep: bit-identical to the reference's single-device fused run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", PARTS, ids=lambda p: f"{p[1]}{p[0]}")
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("case", list(CASES))
def test_lockstep_matches_reference_fused(case, op, parts):
    num_shards, method = parts
    want, gname, src = _reference(case, op)
    strategy, kwargs = CASES[case]
    key = f"shard:{strategy}"
    before = fused.DISPATCH_COUNTS[key]
    got = engine.run(GRAPHS[gname], src, make_strategy(strategy, **kwargs),
                     mode="fused", op=op, shards=num_shards,
                     partition=method, device="cpu")
    _same(got, want)
    assert got.relax_rounds == got.iterations
    assert (got.shards, got.mode, got.async_shards) == (num_shards, "fused",
                                                        False)
    assert fused.DISPATCH_COUNTS[key] == before + 1


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_state_bytes_include_partition(case):
    """``state_bytes`` = the reference's single-device bytes plus its
    partition's ``device_bytes()`` (of the split graph for NS)."""
    strategy, kwargs = CASES[case]
    jstrat = jengine.make_strategy(strategy, **kwargs)
    single = jengine.run(JAX_GRAPHS["rmat"], 0, jstrat, mode="fused")
    plan_graph = (jstrat.split_info.graph if strategy == "NS"
                  else JAX_GRAPHS["rmat"])
    sharded, _ = jshard.partition(plan_graph, 2)
    got = engine.run(GRAPHS["rmat"], 0, make_strategy(strategy, **kwargs),
                     mode="fused", shards=2, device="cpu")
    assert got.state_bytes == single.state_bytes + sharded.device_bytes()


# ---------------------------------------------------------------------------
# async: exact values, epochs of their own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["shortest_path", "min_label",
                                "widest_path"])
@pytest.mark.parametrize("case", list(CASES))
def test_async_matches_single_device_and_dijkstra(case, op):
    want, gname, src = _reference(case, op)
    strategy, kwargs = CASES[case]
    oracle = (reference_distances(GRAPHS[gname], src)
              if op == "shortest_path" else np.asarray(want.dist))
    for num_shards in (1, 2, 3):
        got = engine.run(GRAPHS[gname], src,
                         make_strategy(strategy, **kwargs), mode="fused",
                         op=op, shards=num_shards, async_shards=True,
                         device="cpu")
        np.testing.assert_array_equal(got.dist, oracle)
        np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
        assert got.async_shards and got.shards == num_shards
        if num_shards == 1:
            # one shard drains the whole frontier in its first epoch
            assert (got.iterations, got.relax_rounds, got.edges_relaxed) == (
                1, want.iterations, want.edges_relaxed)
        else:
            assert 1 <= got.iterations <= got.relax_rounds


def test_async_epochs_are_capped():
    strat = make_strategy("WD")
    got = engine.run(GRAPHS["rmat"], _source("rmat"), strat, mode="fused",
                     shards=3, async_shards=True, max_iterations=2,
                     device="cpu")
    assert got.iterations == 2


# ---------------------------------------------------------------------------
# batches and the algorithms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [(2, "degree"), (3, "contiguous")],
                         ids=lambda p: f"{p[1]}{p[0]}")
@pytest.mark.parametrize("op", ["shortest_path", "widest_path"])
def test_sharded_batch_matches_reference_fused_batch(op, parts):
    num_shards, method = parts
    sources = [_source("rmat"), 0, 17, 17, 200]
    want = jms.run_batch(JAX_GRAPHS["rmat"], sources, mode="fused", op=op)
    before = fused.DISPATCH_COUNTS["shard:batch"]
    got = engine.run_batch(GRAPHS["rmat"], sources, mode="fused", op=op,
                           shards=num_shards, partition=method,
                           device="cpu")
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    assert (got.iterations, got.edges_relaxed) == (want.iterations,
                                                   want.edges_relaxed)
    assert (got.shards, got.mode) == (num_shards, "fused")
    assert fused.DISPATCH_COUNTS["shard:batch"] == before + 1
    # each row equals its own single-device run
    for row, s in zip(got.dist, sources):
        np.testing.assert_array_equal(
            row, engine.run(GRAPHS["rmat"], s, make_strategy("WD"), op=op,
                            mode="fused", device="cpu").dist)


def test_algorithms_accept_shards():
    jg, g = JAX_GRAPHS["rmat"], GRAPHS["rmat"]
    src = _source("rmat")
    for fn, jfn in ((sssp, "shortest_path"), (widest_path, "widest_path")):
        want = jengine.run(jg, src, jengine.make_strategy("HP"),
                           mode="fused", op=jfn)
        for kw in (dict(shards=2), dict(shards=3, async_shards=True,
                                        partition="contiguous")):
            got = fn(g, src, strategy="HP", mode="fused", device="cpu", **kw)
            np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    want = jax_bfs(jg, src, strategy="BS", mode="fused")
    got = bfs(g, src, strategy="BS", mode="fused", shards=2, device="cpu")
    _same(got, want)
    sym = _symmetrized(jgraphs.rmat_graph(scale=7, edge_factor=4,
                                          weighted=False, seed=3))
    want = jax_cc(sym, strategy="NS", mode="fused")
    for kw in (dict(shards=2), dict(shards=3, async_shards=True)):
        got = connected_components(_port(sym), strategy="NS", mode="fused",
                                   device="cpu", **kw)
        np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# the reference's errors
# ---------------------------------------------------------------------------

ERRORS = {
    "EP": dict(strategy="EP", mode="fused", shards=2),
    "AD": dict(strategy="AD", mode="fused", shards=2),
    "stepped": dict(strategy="WD", mode="stepped", shards=2),
    "delta": dict(strategy="WD", mode="fused", shards=2, schedule="delta"),
    "async-unsharded": dict(strategy="WD", mode="fused",
                            async_shards=True),
    "async-reach_count": dict(strategy="WD", mode="fused", shards=2,
                              async_shards=True, op="reach_count"),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_sharding_errors_match_reference(name):
    kw = dict(ERRORS[name])
    strategy = kw.pop("strategy")
    with pytest.raises(ValueError):
        jengine.run(JAX_GRAPHS["rmat"], 0, jengine.make_strategy(strategy),
                    **kw)
    with pytest.raises(ValueError):
        engine.run(GRAPHS["rmat"], 0, make_strategy(strategy), device="cpu",
                   **kw)


def test_batch_and_capability_errors():
    g = GRAPHS["rmat"]
    with pytest.raises(ValueError, match="fused"):
        engine.run_batch(g, [0], shards=2, device="cpu")
    with pytest.raises(ValueError, match="delta"):
        engine.run_batch(g, [0], mode="fused", shards=2, schedule="delta",
                         device="cpu")
    for name in ("BS", "WD", "HP", "NS"):
        assert SHARDABLE in strategy_capabilities(name)
    for name in ("EP", "AD"):
        assert SHARDABLE not in strategy_capabilities(name)
    with pytest.raises(ValueError, match="num_shards"):
        shard.shard_group(0, "cpu")


# ---------------------------------------------------------------------------
# one rank a shard: two gloo processes on the CPU
# ---------------------------------------------------------------------------

def spawn_ranks(tmp_path, what: str, gname: str, src: int,
                world: int = 2) -> list:
    """Run ``tests/torch_shard_ranks.py`` as ``world`` gloo ranks joined
    by a FileStore under ``tmp_path``; returns each rank's outputs."""
    jg = JAX_GRAPHS[gname]
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, row_ptr=np.asarray(jg.row_ptr), col=np.asarray(jg.col),
             wt=np.asarray(jg.wt), source=src)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_shard_ranks.py"),
         "--rank", str(r), "--world", str(world),
         "--store", str(tmp_path / "store"), "--inputs", str(inputs),
         "--out", str(tmp_path / f"rank{r}.npz"), "--what", what],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        errs = [p.communicate(timeout=120)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The module's one spawn of two gloo ranks, one shard each."""
    return spawn_ranks(tmp_path_factory.mktemp("ranks"), "shard", "rmat",
                       _source("rmat"))


def test_two_gloo_ranks_match_one_process(ranks):
    g, src = GRAPHS["rmat"], _source("rmat")
    for name, kw in (("WD", {}), ("BS", {}),
                     ("WD-async", dict(async_shards=True))):
        one = sssp(g, src, strategy=name.split("-")[0], mode="fused",
                   shards=2, device="cpu", **kw)
        for out in ranks:
            np.testing.assert_array_equal(out[name], one.dist)
            assert out[name + "-counts"].tolist() == [
                one.iterations, one.edges_relaxed, one.relax_rounds, 2]
    for out in ranks:
        assert "3 shards" in str(out["error"]) and "has 2" in str(
            out["error"])


def test_a_rank_holds_only_its_shard(ranks):
    """A rank of a two-rank run holds the shard of its rank and nothing
    more: each held tensor has a storage of its own, one shard's slice of
    the partition (half the stack), equal to the stack's row."""
    for rank, out in enumerate(ranks):
        assert out["held"].tolist() == [rank]
        assert out["held-equal"].tolist() == [True]
        np.testing.assert_array_equal(out["held-storage"],
                                      out["stack-bytes"][None, :] // 2)
