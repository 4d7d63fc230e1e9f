"""float32 operators through the port's engines against the reference's,
on the CPU.

Three float32 operators, built once for each package:

* ``half_sssp``: SSSP in half units, ``min``, ``v + w * 0.5``
  (weight-additive);
* ``reliable``: the most reliable path, ``max``, ``v * (w / (w + 1.0))``,
  identity 0.0, source 1.0 (``value_min`` 0);
* ``damped``: damped path counts, ``add``, ``v * 0.5``, source 1.0.

``half_sssp`` and ``reliable`` equal the reference (``backend="xla"``) bit
for bit in ``(dist, iterations, edges_relaxed)`` through the six
strategies stepped and fused, delta-stepping, a K = 4 batch and a
two-shard lockstep run.  Their messages cannot be contracted into an FMA
(a product by 0.5 is exact; the other multiplies a quotient).

``scaled_sssp`` (``min``, ``v + w * 0.01``) can be, and XLA contracts it
in some of the reference's jitted loops and not in others, so the
reference's own strategies disagree on it (ROADMAP queue C, "The
reference's faults": the reference's float multiply-add).  The port
rounds each operation once, as torch does, on the CPU and on the card;
it is held to a float32 Dijkstra that rounds the same way, and
``test_reference_contracts_the_multiply_add`` pins the reference's
disagreement.

``damped`` is not bit-exact: float addition depends on the order of its
terms, and the reference's strategies sum a node's messages in different
orders (its BS and WD runs differ among themselves); the port's
``iterations`` and ``edges_relaxed`` are exact and ``dist`` is held at
rtol 1e-5 (2.1e-7 was measured at rmat8 after 6 iterations).

Also: an edgeless graph's ``dist`` keeps the operator's dtype and
identity, and the fold of −0.0 against +0.0 and of a NaN (admitted by a
custom ``update``) equals the reference's ``.at[].min/max``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import multi_source as jms
from repro.core import operators as jops
from repro.core import strategies as jstrategies
from repro.core.graph import CSRGraph as JaxCSRGraph
from repro.data import graphs as jgraphs
from repro_torch.core import engine
from repro_torch.core import operators as tops
from repro_torch.core.graph import INF, CSRGraph
from repro_torch.core.strategies import make_strategy
from repro_torch.kernels import relax

STRATEGIES = ["BS", "EP", "WD", "NS", "HP", "AD"]


def _layered_dag(seed=0):
    """A layered DAG of 6 layers (every node reached once a layer)."""
    rng = np.random.default_rng(seed)
    layers, start = [], 0
    for w in (1, 4, 6, 6, 5, 3):
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
                               seed=1),
    "road": jgraphs.road_grid_graph(side=12, weighted=True, seed=4),
    "dag": _layered_dag(),
}
GRAPHS = {name: _port(jg) for name, jg in JAX_GRAPHS.items()}
SOURCES = {"rmat": int(np.argmax(np.asarray(JAX_GRAPHS["rmat"].degrees))),
           "road": 5, "dag": 0}


def _pair(name, combine, identity, source_value, jmessage, tmessage,
          jupdate=None, tupdate=None, **kw):
    """The same float32 operator for both packages."""
    return (jops.EdgeOp(name=name, combine=combine, identity=identity,
                        source_value=source_value, message=jmessage,
                        update=jupdate, dtype=jnp.float32, **kw),
            tops.EdgeOp(name=name, combine=combine, identity=identity,
                        source_value=source_value, message=tmessage,
                        update=tupdate, dtype=torch.float32, **kw))


#: name -> (reference op, port op, graph)
OPS = {
    "half_sssp": (*_pair("half_sssp", "min", float(INF), 0.0,
                         lambda v, w: v + w * 0.5, lambda v, w: v + w * 0.5,
                         weight_additive=True), "rmat"),
    "reliable": (*_pair("reliable", "max", 0.0, 1.0,
                        lambda v, w: v * (w / (w + 1.0)),
                        lambda v, w: v * (w / (w + 1.0)), value_min=0),
                 "rmat"),
    "scaled_sssp": (*_pair("scaled_sssp", "min", float(INF), 0.0,
                           lambda v, w: v + w * 0.01,
                           lambda v, w: v + w * 0.01,
                           weight_additive=True), "rmat"),
    "damped": (*_pair("damped", "add", 0.0, 1.0, lambda v, w: v * 0.5,
                      lambda v, w: v * 0.5), "dag"),
}

#: the operators held to the reference bit for bit
EXACT = ["half_sssp", "reliable"]


def _same(got, want):
    """``(dist, iterations, edges_relaxed)`` bit for bit, NaN for NaN."""
    want_dist = np.asarray(want.dist)
    assert got.dist.dtype == np.float32 == want_dist.dtype
    np.testing.assert_array_equal(got.dist.view(np.int32),
                                  want_dist.view(np.int32))
    assert (got.iterations, got.edges_relaxed) == (want.iterations,
                                                   want.edges_relaxed)


@functools.lru_cache(maxsize=None)
def _reference(opname, strategy, mode, schedule="bsp", gname=None,
               max_iterations=100000):
    jop, _, g = OPS[opname]
    g = gname or g
    return jengine.run(JAX_GRAPHS[g], SOURCES[g],
                       jengine.make_strategy(strategy), op=jop, mode=mode,
                       schedule=schedule, delta=4 if schedule == "delta"
                       else None, max_iterations=max_iterations)


def _run(opname, strategy, mode, gname=None, **kw):
    _, top, g = OPS[opname]
    g = gname or g
    return engine.run(GRAPHS[g], SOURCES[g], make_strategy(strategy),
                      op=top, mode=mode, device="cpu", **kw)


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("opname", EXACT)
def test_engines_match_reference(opname, strategy, mode):
    got = _run(opname, strategy, mode)
    _same(got, _reference(opname, strategy, mode))
    assert got.iterations > 1


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("strategy", ["BS", "WD", "NS", "HP", "AD"])
def test_delta_matches_reference(strategy, mode):
    """``schedule="delta"`` at Δ = 4 on road12 with the half-unit SSSP
    (weight-additive: its heavy edges are deferred): the reference's
    dist, epochs and edges."""
    got = _run("half_sssp", strategy, mode, gname="road", schedule="delta",
               delta=4)
    _same(got, _reference("half_sssp", strategy, mode, "delta", "road"))


@pytest.mark.parametrize("mode", ["stepped", "fused"])
def test_delta_max_matches_reference(mode):
    """The max monoid's buckets reflect the rank (``INF - v`` over
    float32); WD at Δ = 4 on rmat8."""
    got = _run("reliable", "WD", mode, schedule="delta", delta=4)
    _same(got, _reference("reliable", "WD", mode, "delta"))


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("opname", EXACT)
def test_batch_matches_reference(opname, mode):
    """K = 4 (a duplicate source among them), stepped (B1's union
    contract) and fused (one traversal a row)."""
    jop, top, g = OPS[opname]
    sources = [SOURCES[g], 0, 3, 3]
    want = jms.run_batch(JAX_GRAPHS[g], sources, mode=mode, op=jop)
    got = engine.run_batch(GRAPHS[g], sources, mode=mode, op=top,
                           device="cpu")
    assert got.dist.dtype == np.float32
    np.testing.assert_array_equal(got.dist.view(np.int32),
                                  np.asarray(want.dist).view(np.int32))
    assert (got.iterations, got.edges_relaxed) == (want.iterations,
                                                   want.edges_relaxed)


@pytest.mark.parametrize("strategy", ["BS", "WD", "HP", "NS"])
@pytest.mark.parametrize("opname", EXACT)
def test_two_shards_match_one_device(opname, strategy):
    """A two-shard lockstep run equals the reference's single-device fused
    run (its own sharded engine fails under jax 0.9, ROADMAP queue C)."""
    got = _run(opname, strategy, "fused", shards=2)
    _same(got, _reference(opname, strategy, "fused"))
    assert got.shards == 2


def _float32_dijkstra(g: CSRGraph, source: int, c: float) -> np.ndarray:
    """Dijkstra over float32 values with ``v + float32(w) * float32(c)``,
    each operation rounded once to float32: exact for this message, which
    is monotone and never below ``v`` for w >= 0."""
    import heapq
    rp, col, wt = g.row_ptr.numpy(), g.col.numpy(), g.wt.numpy()
    step = (wt.astype(np.float32) * np.float32(c)).astype(np.float32)
    dist = np.full(g.num_nodes, np.float32(INF), np.float32)
    dist[source] = 0.0
    done = np.zeros(g.num_nodes, bool)
    heap = [(0.0, source)]
    while heap:
        d, u = heapq.heappop(heap)
        if done[u]:
            continue
        done[u] = True
        for e in range(rp[u], rp[u + 1]):
            nd = np.float32(dist[u] + step[e])
            if nd < dist[col[e]]:
                dist[col[e]] = nd
                heapq.heappush(heap, (float(nd), int(col[e])))
    return dist


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_scaled_sssp_matches_float32_dijkstra(strategy, mode):
    """``v + w * 0.01`` through every strategy equals a float32 Dijkstra
    that rounds each operation once (the port never contracts it)."""
    got = _run("scaled_sssp", strategy, mode)
    want = _float32_dijkstra(GRAPHS["rmat"], SOURCES["rmat"], 0.01)
    np.testing.assert_array_equal(got.dist.view(np.int32),
                                  want.view(np.int32))


def test_reference_contracts_the_multiply_add():
    """The reference's fault (ROADMAP queue C, "The reference's faults"):
    its strategies disagree on ``v + w * 0.01``, consistent with XLA
    contracting the multiply-add into an FMA inside some jitted loops.
    Its EP fused run rounds each operation once and equals the port; its
    WD stepped run differs from both.  If this starts failing, the
    reference has become consistent and the caveat can go."""
    ep = np.asarray(_reference("scaled_sssp", "EP", "fused").dist)
    wd = np.asarray(_reference("scaled_sssp", "WD", "stepped").dist)
    port = _run("scaled_sssp", "WD", "stepped").dist
    np.testing.assert_array_equal(port.view(np.int32), ep.view(np.int32))
    assert (wd != ep).any()


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("gname,cap", [("dag", 100000), ("rmat", 6)])
def test_damped_add_matches_reference(gname, cap, strategy, mode):
    """Damped path counts on the layered DAG (to the fixed point) and on
    rmat8 (capped at 6 iterations: the counts of a cyclic graph only stop
    when they underflow): ``iterations`` and ``edges_relaxed`` exact,
    ``dist`` at rtol 1e-5 (float addition has no order in the reference's
    contract)."""
    got = _run("damped", strategy, mode, gname=gname, max_iterations=cap)
    want = _reference("damped", strategy, mode, gname=gname,
                      max_iterations=cap)
    assert got.dist.dtype == np.float32
    np.testing.assert_allclose(got.dist, np.asarray(want.dist), rtol=1e-5,
                               atol=0)
    assert (got.iterations, got.edges_relaxed) == (want.iterations,
                                                   want.edges_relaxed)


def test_edgeless_graph_keeps_the_operator_dtype():
    """An edgeless graph returns ``dist`` in the operator's dtype, holding
    its identity (2.5 here: an int32 array would truncate it) and the
    source's seed, as the reference does; one run and a batch."""
    _, top, _ = OPS["half_sssp"]
    jop, _, _ = OPS["half_sssp"]
    import dataclasses
    top = dataclasses.replace(top, identity=2.5)
    jop = dataclasses.replace(jop, identity=2.5)
    rp = np.zeros(5, np.int32)
    g = CSRGraph.from_arrays(rp, np.zeros(0, np.int32), device="cpu")
    jg = JaxCSRGraph.from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                None, 4)
    got = engine.run(g, 1, make_strategy("WD"), op=top, device="cpu")
    want = jengine.run(jg, 1, jengine.make_strategy("WD"), op=jop)
    assert got.dist.dtype == np.float32 == np.asarray(want.dist).dtype
    np.testing.assert_array_equal(got.dist, [2.5, 0.0, 2.5, 2.5])
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    batch = engine.run_batch(g, [0, 3], op=top, device="cpu")
    assert batch.dist.dtype == np.float32
    np.testing.assert_array_equal(batch.dist, [[0.0, 2.5, 2.5, 2.5],
                                               [2.5, 2.5, 2.5, 0.0]])
    assert engine.run(g, 1, make_strategy("WD"), op="shortest_path",
                      device="cpu").dist.dtype == np.int32


NAN = float("nan")
#: values whose folds order matters for a careless min/max: both zeros,
#: NaN of both signs, infinities
FOLD_VALUES = np.array([0.0, -0.0, NAN, -NAN, 1.0, -1.0, np.inf, -np.inf,
                        2.5], np.float32)


@pytest.mark.parametrize("combine", ["min", "max"])
def test_fold_of_signed_zeros_and_nan_matches_reference(combine):
    """B2's plain fold (``EdgeOp.scatter``, then ``apply_proposal``) and
    the fold into a copy of dist, against the reference's ``.at[].min/max``
    relax (``strategies._apply_relax``): random lanes over −0.0, +0.0,
    NaN and ±inf, with an ``update`` that admits a NaN candidate
    (``cand != cand``) beside the combine's own test, and the identity
    ±inf.  −0.0 ranks below
    +0.0 whatever the lanes' order; NaN absorbs (compared NaN for NaN:
    its payload is the hardware's)."""
    better = (lambda c, cur: c < cur) if combine == "min" else \
        (lambda c, cur: c > cur)
    # the identities bound the values (a proposal's untouched entries are
    # the identity, which apply_proposal folds into dist)
    ident = np.inf if combine == "min" else -np.inf
    jop, top = _pair(f"nan_{combine}", combine, ident, 0.0,
                     lambda v, w: v * 1.0, lambda v, w: v * 1.0,
                     jupdate=lambda c, cur: better(c, cur) | (c != c),
                     tupdate=lambda c, cur: better(c, cur) | (c != c))
    rng = np.random.default_rng(7)
    for trial in range(40):
        n, lanes = 6, 24
        dist = rng.choice(FOLD_VALUES, n)
        src = rng.integers(0, n, lanes).astype(np.int32)
        dst = rng.integers(0, n, lanes).astype(np.int32)
        w = np.ones(lanes, np.int32)
        valid = rng.random(lanes) < 0.8
        want, _, want_imp = jstrategies._apply_relax(
            jnp.asarray(dist), jnp.zeros(n, bool), jnp.asarray(src),
            jnp.asarray(dst), jnp.asarray(w), jnp.asarray(valid), op=jop)
        want = np.asarray(want)
        args = (torch.from_numpy(src), torch.from_numpy(dst),
                torch.from_numpy(w), torch.from_numpy(valid))
        for got, imp in (
                relax.apply_relax_plain(torch.from_numpy(dist.copy()),
                                        torch.zeros(n, dtype=torch.bool),
                                        *args, op=top)[::2],
                relax.apply_relax(torch.from_numpy(dist.copy()),
                                  torch.zeros(n, dtype=torch.bool), *args,
                                  op=top)[::2]):
            got = got.numpy()
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            real = ~np.isnan(want)
            np.testing.assert_array_equal(got[real], want[real])
            np.testing.assert_array_equal(np.signbit(got[real]),
                                          np.signbit(want[real]))
            np.testing.assert_array_equal(imp.numpy(), np.asarray(want_imp))


@pytest.mark.parametrize("combine", ["min", "max"])
def test_fold_values_orders_zeros(combine):
    """``apply_proposal``'s elementwise fold gives −0.0 (min) or +0.0
    (max) for a pair of zeros in either order and at any length (torch's
    own minimum/maximum return either zero by the loop that takes the
    element), and propagates NaN."""
    op = tops.EdgeOp(name="z", combine=combine, identity=0.0,
                     source_value=0.0, message=lambda v, w: v,
                     dtype=torch.float32)
    for n in (1, 7, 64, 1000):
        a = torch.tensor([0.0, -0.0, NAN, 1.0] * n)
        b = torch.tensor([-0.0, 0.0, 1.0, NAN] * n)
        for x, y in ((a, b), (b, a)):
            out = op.fold_values(x, y)
            zero = out[0::4].tolist() + out[1::4].tolist()
            sign = torch.tensor(zero).signbit()
            assert bool(sign.all() if combine == "min" else (~sign).all())
            assert bool(out[2::4].isnan().all() & out[3::4].isnan().all())
