"""The port's batched multi-source fixed point (``run_batch``) against the
reference's, on the CPU, where B1's batch contract and the fused batch
run their plain versions: ``(dist, iterations,
edges_relaxed, iter_stats)`` bit for bit with no tolerance, stepped and
fused, on rmat (scale 9), road (side 12) and ER (scale 8), for the four
built-in operators, ``max_iterations`` of 1-3, ``pad_to``, duplicate and
disconnected sources, the empty batch and the edgeless graph;
``sssp_batch``/``bfs_batch``, ``init_batch``/``refill_slot``, the error
cases, B1's batch contract (its plain version) against its single-row
plain version, and one
``DISPATCH_COUNTS["batch"]`` step a fused batch.  The reference runs
``backend="xla"``, which ``tests/test_backends.py`` holds bit-identical
to its Pallas backend."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algos import bfs_batch as jax_bfs_batch
from repro.algos import sssp_batch as jax_sssp_batch
from repro.core import engine as jengine
from repro.core import multi_source as jms
from repro.core import operators as joperators
from repro.core.graph import CSRGraph as JaxCSRGraph
from repro.data import graphs as jgraphs
from repro_torch.algos import bfs_batch, sssp_batch
from repro_torch.core import engine, fused, multi_source, operators
from repro_torch.core.graph import CSRGraph
from repro_torch.core.strategies import make_strategy
from repro_torch.kernels import relax

OP_NAMES = ("shortest_path", "min_label", "widest_path", "reach_count")

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


def _sources(gname: str) -> list:
    """The issue's fixed sources and the highest-degree node."""
    return [0, 3, 17, 42,
            int(np.argmax(np.asarray(JAX_GRAPHS[gname].degrees)))]


def _stats(r) -> list:
    return [(s.frontier_size, s.edges_processed, s.kernel)
            for s in r.iter_stats]


def _same(got, want):
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    assert got.dist.dtype == np.int32
    np.testing.assert_array_equal(got.sources, np.asarray(want.sources))
    assert (got.iterations, got.edges_relaxed, got.pad_lanes, got.mode) == (
        want.iterations, want.edges_relaxed, want.pad_lanes, want.mode)
    assert _stats(got) == _stats(want)


def _both(gname, sources, **kw):
    want = jengine.run_batch(JAX_GRAPHS[gname], sources, **kw)
    got = engine.run_batch(GRAPHS[gname], sources, device="cpu", **kw)
    _same(got, want)
    return got


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("gname", list(JAX_GRAPHS))
def test_run_batch_matches_reference(gname, mode):
    got = _both(gname, _sources(gname), mode=mode)
    assert got.iterations > 1 and got.device == "cpu"
    assert got.strategy == "WD-batch"


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("op", OP_NAMES)
def test_run_batch_operators(op, mode):
    # reach_count (add) never reaches a fixed point: cap its iterations
    kw = dict(max_iterations=3) if op == "reach_count" else {}
    _both("rmat", _sources("rmat"), mode=mode, op=op, **kw)


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("max_iterations", [1, 2, 3])
def test_run_batch_max_iterations(max_iterations, mode):
    got = _both("road", _sources("road"), mode=mode,
                max_iterations=max_iterations)
    assert got.iterations == max_iterations


@pytest.mark.parametrize("mode", ["stepped", "fused"])
def test_run_batch_pad_to(mode):
    got = _both("er", [3, 17, 42], mode=mode, pad_to=8)
    assert got.pad_lanes == 5 and got.dist.shape[0] == 8
    for row in got.dist[3:]:
        np.testing.assert_array_equal(row, got.dist[0])
    # an empty batch pads with node 0
    _both("er", [], mode=mode, pad_to=2)
    with pytest.raises(ValueError, match="pad_to"):
        engine.run_batch(GRAPHS["er"], [1, 2, 3], pad_to=2, device="cpu")


@pytest.mark.parametrize("mode", ["stepped", "fused"])
def test_duplicate_and_disconnected_sources(mode):
    deg = np.asarray(JAX_GRAPHS["rmat"].degrees)
    sink = int(np.flatnonzero(deg == 0)[0])       # no out-edges
    hub = int(np.argmax(deg))
    got = _both("rmat", [hub, sink, hub, sink], mode=mode)
    np.testing.assert_array_equal(got.dist[0], got.dist[2])
    assert (got.dist[1] != operators.shortest_path.identity).sum() == 1


@pytest.mark.parametrize("mode", ["stepped", "fused"])
def test_empty_batch_and_edgeless_graph(mode):
    got = _both("rmat", [], mode=mode)
    assert got.dist.shape == (0, GRAPHS["rmat"].num_nodes)
    jg = JaxCSRGraph.from_edges(np.array([], np.int64),
                                np.array([], np.int64), None, 3)
    for op in OP_NAMES:
        want = jengine.run_batch(jg, [1, 2], mode=mode, op=op)
        got = engine.run_batch(_port(jg), [1, 2], mode=mode, op=op,
                               device="cpu")
        _same(got, want)


@pytest.mark.parametrize("mode", ["stepped", "fused"])
def test_batch_rows_equal_single_source_runs(mode):
    """Each row is its source's WD run; the batch runs as long as its
    slowest row and relaxes the rows' edges together."""
    g, sources = GRAPHS["rmat"], _sources("rmat")
    got = engine.run_batch(g, sources, mode=mode, device="cpu")
    single = [engine.run(g, s, make_strategy("WD"), mode="fused",
                         device="cpu") for s in sources]
    for row, r in zip(got.dist, single):
        np.testing.assert_array_equal(row, r.dist)
    assert got.iterations == max(r.iterations for r in single)
    assert got.edges_relaxed == sum(r.edges_relaxed for r in single)


@pytest.mark.parametrize("mode", ["stepped", "fused"])
def test_sssp_and_bfs_batch(mode):
    jg, g = JAX_GRAPHS["rmat"], GRAPHS["rmat"]
    sources = _sources("rmat")
    _same(sssp_batch(g, sources, mode=mode, device="cpu"),
          jax_sssp_batch(jg, sources, mode=mode))
    _same(bfs_batch(g, sources, mode=mode, device="cpu"),
          jax_bfs_batch(jg, sources, mode=mode))
    with pytest.raises(ValueError, match="weighted"):
        sssp_batch(g.unweighted(), sources, device="cpu")


@pytest.mark.parametrize("op", OP_NAMES)
def test_init_batch_and_refill_slot(op):
    n, sources = 37, np.array([4, 0, 36, 4], np.int32)
    want_d, want_m = jms.init_batch(n, jnp.asarray(sources),
                                    op=joperators.resolve(op))
    top = operators.resolve(op)
    got_d, got_m = multi_source.init_batch(n, torch.from_numpy(sources),
                                           op=top)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    want_d, want_m = jms.refill_slot(want_d, want_m, jnp.int32(2),
                                     jnp.int32(11),
                                     op=joperators.resolve(op))
    before = got_d.clone()
    got_d2, got_m2 = multi_source.refill_slot(got_d, got_m, 2, 11, op=top)
    np.testing.assert_array_equal(got_d2.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_m2.numpy(), np.asarray(want_m))
    assert torch.equal(got_d, before)             # the inputs stay as they were


def test_run_batch_errors():
    g = GRAPHS["road"]
    n = g.num_nodes
    for bad in ([n], [0, -1], [n + 3]):
        with pytest.raises(ValueError, match="sources"):
            engine.run_batch(g, bad, device="cpu")
    # sharded batches (A11) have landed: fused runs, equal to the
    # reference's single-device fused batch; stepped raises its ValueError
    got = engine.run_batch(g, [0, 9], mode="fused", shards=2, device="cpu")
    want = jengine.run_batch(JAX_GRAPHS["road"], [0, 9], mode="fused")
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    assert (got.iterations, got.edges_relaxed) == (want.iterations,
                                                   want.edges_relaxed)
    with pytest.raises(ValueError, match="fused"):
        engine.run_batch(g, [0], shards=2, device="cpu")
    # delta batches (A10) have landed: fused runs, equal to the
    # reference's; stepped raises the reference's ValueError
    got = engine.run_batch(g, [0, 9], mode="fused", schedule="delta",
                           device="cpu")
    want = jengine.run_batch(JAX_GRAPHS["road"], [0, 9], mode="fused",
                             schedule="delta")
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    assert (got.iterations, got.relax_rounds, got.edges_relaxed,
            got.delta) == (want.iterations, want.relax_rounds,
                           want.edges_relaxed, want.delta)
    with pytest.raises(ValueError, match="fused"):
        engine.run_batch(g, [0], schedule="delta", device="cpu")
    # the mode is checked first, as in the reference
    with pytest.raises(ValueError, match="mode"):
        engine.run_batch(g, [n], mode="warp", shards=2, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        engine.run_batch(g, [0], mode="warp", device="cpu")


def test_one_dispatch_per_fused_batch():
    g, sources = GRAPHS["road"], _sources("road")
    before = fused.DISPATCH_COUNTS["batch"]
    engine.run_batch(g, sources, mode="fused", device="cpu")
    engine.run_batch(g, sources, mode="fused", pad_to=8, device="cpu")
    assert fused.DISPATCH_COUNTS["batch"] == before + 2
    engine.run_batch(g, sources, mode="stepped", device="cpu")
    assert fused.DISPATCH_COUNTS["batch"] == before + 2


def _row_tables(g: CSRGraph, rows_of_nodes, cap: int):
    """``[K, cap]`` WD slot tables of each row's sorted frontier (an
    empty list: an empty row)."""
    f = torch.full((len(rows_of_nodes), cap), -1, dtype=torch.int32)
    for r, nodes in enumerate(rows_of_nodes):
        f[r, :len(nodes)] = torch.as_tensor(sorted(nodes), dtype=torch.int32)
    live = f >= 0
    fi = torch.where(live, f, 0)
    deg = torch.where(live, g.row_ptr[fi + 1] - g.row_ptr[fi], 0)
    prefix = torch.cumsum(deg, 1, dtype=torch.int32)
    return prefix, prefix - deg, g.row_ptr[fi], fi


@pytest.mark.parametrize("op", OP_NAMES)
def test_plain_b1_batch_equals_its_rows(op):
    """B1's batch contract (the union frontier, node-major; its plain
    version here) is B1's single-row plain version on every row; an
    empty row relaxes nothing, and a ``cap_work`` short of a row's total
    leaves that row's tail."""
    g = GRAPHS["rmat"]
    top = operators.resolve(op)
    rng = np.random.default_rng(7)
    n = g.num_nodes
    rows = [rng.choice(n, 40, replace=False), [], rng.choice(n, 3,
                                                             replace=False)]
    mask = torch.zeros((3, n), dtype=torch.bool)
    for r, nodes in enumerate(rows):
        mask[r, torch.as_tensor(nodes, dtype=torch.long)] = True
    prefix, excl, start, src = _row_tables(g, rows, 64)
    dist = torch.from_numpy(rng.integers(0, 50, (3, n)).astype(np.int32))
    for cap_work in (1000, 37):
        nxt, updated = multi_source.batched_wd_relax(
            g, dist, mask, cap=64, cap_work=cap_work, op=top)
        for r in range(3):
            p1, u1, _ = relax.wd_relax_lanes_plain(
                dist[r], prefix[r], excl[r], start[r], src[r], g.col, g.wt,
                cap_work=cap_work, op=top)
            assert torch.equal(updated[r], u1)
            assert torch.equal(nxt[r], relax.apply_proposal(dist[r], p1,
                                                            top))
        assert not updated[1].any() and torch.equal(nxt[1], dist[1])
        assert updated[0].any()
    empty = multi_source.batched_wd_relax(g, dist[:0], mask[:0], cap=64,
                                          cap_work=8, op=top)
    assert empty[0].shape == (0, n) and empty[1].shape == (0, n)
