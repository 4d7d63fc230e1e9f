"""Sub-word and 64-bit operators through the port's engines against the
reference's, on the CPU.

Seven operators, built once for each package (the same callables; where
JAX's weak types and torch's promotion part, noted):

* ``bf16_sssp``: SSSP in bfloat16, ``min``, ``v + w`` (the weight rounds
  to bfloat16 in both);
* ``i16_sssp``: SSSP in int16, ``min``, identity 32767, ``v + w`` (an
  int32 message, narrowed by the fold in both);
* ``i8_levels``: BFS levels in int8, ``min``, identity 127, ``v + 1``;
* ``u8_widest``: the widest path in uint8, ``max``, source 255,
  ``minimum(v, clip(w, 0, 255) as uint8)``;
* ``f16_reliable``: the most reliable path in float16, ``max``,
  ``v * (w / (w + 1.0))``.  torch promotes the float16 value times the
  float32 quotient to float32 (the fold narrows it); JAX's weak type
  rounds the quotient to float16 first, so the two differ by an ulp here
  and there (``test_reference_rounds_the_quotient_to_float16``).
  ``f16_cast`` writes the reference's rounding out (``.to(float16)``)
  and equals it bit for bit; ``f16_reliable`` is held to a float16
  Dijkstra that rounds as torch does, and to the reference at 4e-3;
* ``u8_count``: path counts in uint8, ``add`` (wrapping mod 256, in any
  order: bit for bit);
* ``bf16_damped``: damped counts in bfloat16, ``add``, ``v * 0.5``, held
  at rtol 2e-2 (a float sum's order; bfloat16 keeps 8 bits).

The first four equal the reference (``backend="xla"``) bit for bit in
``(dist, iterations, edges_relaxed)`` through the six strategies, stepped
and fused (``f16_cast`` through BS, WD and AD); ``bf16_sssp`` and
``i16_sssp`` also
through delta-stepping at Δ = 4 on road12, a K = 4 batch and a two-shard
lockstep run.  float64 and int64 operators run as float32 and int32, as
the reference (x64 off) runs them, and return its values and dtypes.

Also the repairs: the fold of −0.0 against +0.0 and of a NaN in bfloat16
and float16 against the reference's ``.at[].min/max``; a bfloat16
``dist`` reaching the host as float32; ``worklist.bucket_index`` in each
value type against the reference's; and the reference's fault of ``add``
with a nonzero identity, whose answer depends on its schedule.

No bfloat16 chain was found in which XLA keeps excess float32 precision
(``v * 1.5 + w``, ``(v + w) * 0.75``, ``v + w * 0.3``, ``v * 0.9 + w *
0.7`` and ``(v + w) + w`` each equal the port's once-a-node rounding in
WD stepped and EP fused), so no such disagreement is pinned."""

import functools
import heapq

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import multi_source as jms
from repro.core import operators as jops
from repro.core import strategies as jstrategies
from repro.core import worklist as jworklist
from repro_torch.core import engine
from repro_torch.core import operators as tops
from repro_torch.core import worklist
from repro_torch.core.graph import INF
from repro_torch.core.strategies import make_strategy
from repro_torch.kernels import relax

from test_torch_float_ops import GRAPHS, JAX_GRAPHS, SOURCES, STRATEGIES

BF16, F16 = torch.bfloat16, torch.float16


def _pair(name, combine, identity, source_value, jmessage, tmessage,
          jdtype, tdtype, **kw):
    """One operator for both packages."""
    return (jops.EdgeOp(name=name, combine=combine, identity=identity,
                        source_value=source_value, message=jmessage,
                        dtype=jdtype, **kw),
            tops.EdgeOp(name=name, combine=combine, identity=identity,
                        source_value=source_value, message=tmessage,
                        dtype=tdtype, **kw))


def _same_message(f):
    return f, f


#: name -> (reference op, port op, graph)
OPS = {
    "bf16_sssp": (*_pair("bf16_sssp", "min", float("inf"), 0.0,
                         *_same_message(lambda v, w: v + w), jnp.bfloat16,
                         BF16, weight_additive=True), "rmat"),
    "i16_sssp": (*_pair("i16_sssp", "min", 32767, 0,
                        *_same_message(lambda v, w: v + w), jnp.int16,
                        torch.int16, weight_additive=True), "rmat"),
    "i8_levels": (*_pair("i8_levels", "min", 127, 0,
                         *_same_message(lambda v, w: v + 1), jnp.int8,
                         torch.int8), "rmat"),
    "u8_widest": (*_pair(
        "u8_widest", "max", 0, 255,
        lambda v, w: jnp.minimum(v, jnp.clip(w, 0, 255).astype(jnp.uint8)),
        lambda v, w: torch.minimum(v, w.clamp(0, 255).to(torch.uint8)),
        jnp.uint8, torch.uint8, value_min=0), "rmat"),
    "f16_cast": (*_pair(
        "f16_cast", "max", 0.0, 1.0, lambda v, w: v * (w / (w + 1.0)),
        lambda v, w: v * (w / (w + 1.0)).to(F16), jnp.float16, F16,
        value_min=0), "rmat"),
    "f16_reliable": (*_pair("f16_reliable", "max", 0.0, 1.0,
                            *_same_message(lambda v, w: v * (w / (w + 1.0))),
                            jnp.float16, F16, value_min=0), "rmat"),
    "u8_count": (*_pair("u8_count", "add", 0, 1,
                        *_same_message(lambda v, w: v), jnp.uint8,
                        torch.uint8), "dag"),
    "bf16_damped": (*_pair("bf16_damped", "add", 0.0, 1.0,
                           *_same_message(lambda v, w: v * 0.5),
                           jnp.bfloat16, BF16), "dag"),
}

#: the operators held to the reference bit for bit
EXACT = ["bf16_sssp", "i16_sssp", "i8_levels", "u8_widest", "f16_cast"]
#: the result dtype on the host: bfloat16 widens to float32
HOST = {"bf16_sssp": np.float32, "i16_sssp": np.int16, "i8_levels": np.int8,
        "u8_widest": np.uint8, "f16_cast": np.float16,
        "f16_reliable": np.float16, "u8_count": np.uint8,
        "bf16_damped": np.float32}


def _host(a) -> np.ndarray:
    """The reference's ``dist`` on the host, a bfloat16 one widened to
    float32 exactly (as the port returns it)."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _same(got, want, opname):
    """``(dist, iterations, edges_relaxed)`` bit for bit, NaN for NaN."""
    want_dist = _host(want.dist)
    assert got.dist.dtype == HOST[opname] == want_dist.dtype
    np.testing.assert_array_equal(_bits(got.dist), _bits(want_dist))
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
@pytest.mark.parametrize("opname", EXACT[:4])
def test_engines_match_reference(opname, strategy, mode):
    got = _run(opname, strategy, mode)
    _same(got, _reference(opname, strategy, mode), opname)
    assert got.iterations > 1


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("strategy", ["BS", "WD", "AD"])
def test_f16_cast_matches_reference(strategy, mode):
    """float16 bit for bit, where the port's callable rounds as the
    reference's weak type does."""
    got = _run("f16_cast", strategy, mode)
    _same(got, _reference("f16_cast", strategy, mode), "f16_cast")


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("strategy", ["BS", "WD", "AD"])
@pytest.mark.parametrize("opname", ["bf16_sssp", "i16_sssp"])
def test_delta_matches_reference(opname, strategy, mode):
    """``schedule="delta"`` at Δ = 4 on road12 (weight-additive: heavy
    edges deferred).  The buckets are computed in the value type, as the
    reference computes them: int16's clip bound is INF's low bits (-1),
    so every int16 rank is -1 and the epochs are those of one bucket;
    bfloat16's ranks round."""
    got = _run(opname, strategy, mode, gname="road", schedule="delta",
               delta=4)
    _same(got, _reference(opname, strategy, mode, "delta", "road"), opname)


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("opname", ["bf16_sssp", "i16_sssp"])
def test_batch_matches_reference(opname, mode):
    """K = 4 (a duplicate source among them), stepped (B1's union
    contract) and fused (one traversal a row)."""
    jop, top, g = OPS[opname]
    sources = [SOURCES[g], 0, 3, 3]
    want = jms.run_batch(JAX_GRAPHS[g], sources, mode=mode, op=jop)
    got = engine.run_batch(GRAPHS[g], sources, mode=mode, op=top,
                           device="cpu")
    assert got.dist.dtype == HOST[opname]
    np.testing.assert_array_equal(_bits(got.dist), _bits(_host(want.dist)))
    assert (got.iterations, got.edges_relaxed) == (want.iterations,
                                                   want.edges_relaxed)


@pytest.mark.parametrize("strategy", ["BS", "WD"])
@pytest.mark.parametrize("opname", ["bf16_sssp", "i16_sssp"])
def test_two_shards_match_one_device(opname, strategy):
    """A two-shard lockstep run equals the reference's single-device fused
    run (its own sharded engine fails under jax 0.9, ROADMAP queue C)."""
    got = _run(opname, strategy, "fused", shards=2)
    _same(got, _reference(opname, strategy, "fused"), opname)
    assert got.shards == 2


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_u8_count_wraps_as_the_reference(strategy, mode):
    """uint8 path counts on the layered DAG: the sums wrap mod 256, in
    any order of the terms, so the reference's answer is exact."""
    got = _run("u8_count", strategy, mode)
    _same(got, _reference("u8_count", strategy, mode), "u8_count")
    assert int(got.dist.max()) > 1


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("strategy", ["BS", "WD"])
def test_bf16_damped_matches_reference(strategy, mode):
    """bfloat16 damped counts on the layered DAG: ``iterations`` and
    ``edges_relaxed`` exact, ``dist`` at rtol 2e-2 (a float sum has no
    order in the reference's contract; bfloat16 keeps 8 bits)."""
    got = _run("bf16_damped", strategy, mode)
    want = _reference("bf16_damped", strategy, mode)
    assert got.dist.dtype == np.float32
    np.testing.assert_allclose(got.dist, _host(want.dist), rtol=2e-2,
                               atol=0)
    assert (got.iterations, got.edges_relaxed) == (want.iterations,
                                                   want.edges_relaxed)


def _f16_reliable_dijkstra(source: int) -> np.ndarray:
    """The most reliable path over float16 values as torch computes
    ``v * (w / (w + 1.0))``: the quotient in float32, the product in
    float32, then narrowed to float16 by the fold.  The message never
    exceeds ``v`` and is monotone in it, so a max-first Dijkstra is
    exact."""
    g = GRAPHS["rmat"]
    rp, col, wt = g.row_ptr.numpy(), g.col.numpy(), g.wt.numpy()
    w = wt.astype(np.float32)
    q = (w / (w + np.float32(1.0))).astype(np.float32)
    best = np.zeros(g.num_nodes, np.float16)
    best[source] = 1.0
    done = np.zeros(g.num_nodes, bool)
    heap = [(-1.0, source)]
    while heap:
        d, u = heapq.heappop(heap)
        if done[u]:
            continue
        done[u] = True
        for e in range(rp[u], rp[u + 1]):
            c = np.float16(np.float32(best[u]) * q[e])
            if c > best[col[e]]:
                best[col[e]] = c
                heapq.heappush(heap, (-float(c), int(col[e])))
    return best


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("strategy", ["WD", "AD"])
def test_f16_reliable_matches_float16_dijkstra(strategy, mode):
    """The float32 message narrowed to float16 by the fold: every strategy
    equals a Dijkstra that rounds as torch does, and the reference within
    4e-3 (its weak type rounds the quotient to float16 first)."""
    got = _run("f16_reliable", strategy, mode)
    assert got.dist.dtype == np.float16
    want = _f16_reliable_dijkstra(SOURCES["rmat"])
    np.testing.assert_array_equal(_bits(got.dist), _bits(want))
    ref = _host(_reference("f16_reliable", strategy, mode).dist)
    np.testing.assert_allclose(got.dist.astype(np.float32),
                               ref.astype(np.float32), rtol=4e-3, atol=0)


def test_reference_rounds_the_quotient_to_float16():
    """JAX's weak float32 quotient takes the float16 value's type, so the
    reference's message rounds ``w / (w + 1.0)`` to float16 before the
    product; torch promotes the product to float32.  The two results
    differ somewhere on rmat8; the port's ``f16_cast`` writes the
    reference's rounding out and equals it.  If this starts failing,
    JAX has changed its promotion and ``f16_reliable`` may be held
    exactly."""
    promoted = _run("f16_reliable", "WD", "stepped").dist
    ref = _host(_reference("f16_reliable", "WD", "stepped").dist)
    assert (promoted != ref).any()
    cast = _run("f16_cast", "WD", "stepped").dist
    np.testing.assert_array_equal(_bits(cast), _bits(ref))


WIDE = {
    "f64": (jnp.float64, torch.float64, lambda v, w: v + w * 0.5,
            float(INF), 0.0, np.float32),
    "i64": (jnp.int64, torch.int64, lambda v, w: v + w, INF, 0, np.int32),
}


@pytest.mark.parametrize("mode", ["stepped", "fused"])
@pytest.mark.parametrize("strategy", ["WD"])
@pytest.mark.parametrize("wide", list(WIDE))
def test_64_bit_operators_run_as_the_reference(wide, strategy, mode):
    """float64 and int64 operators run as float32 and int32 values
    (``operators.value_dtype``), as the reference with x64 off runs them:
    its values and dtypes, bit for bit."""
    jd, td, msg, ident, seed, host = WIDE[wide]
    jop, top = _pair(wide, "min", ident, seed, msg, msg, jd, td,
                     weight_additive=True)
    assert tops.value_dtype(top) == {np.float32: torch.float32,
                                     np.int32: torch.int32}[host]
    want = jengine.run(JAX_GRAPHS["rmat"], SOURCES["rmat"],
                       jengine.make_strategy(strategy), op=jop, mode=mode)
    got = engine.run(GRAPHS["rmat"], SOURCES["rmat"],
                     make_strategy(strategy), op=top, mode=mode,
                     device="cpu")
    assert got.dist.dtype == host == np.asarray(want.dist).dtype
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    assert (got.iterations, got.edges_relaxed) == (want.iterations,
                                                   want.edges_relaxed)
    batch = engine.run_batch(GRAPHS["rmat"], [0, 3], op=top, mode=mode,
                             device="cpu")
    assert batch.dist.dtype == host


def test_64_bit_kernel_codes_take_the_narrow_type():
    """``kernel_codes`` maps float64 to a float32 build and int64 to the
    int32 kernels (the built-in sum keeps its code)."""
    f64 = tops.EdgeOp(name="f64", combine="min", identity=float(INF),
                      source_value=0.0, message=lambda v, w: v + w,
                      dtype=torch.float64)
    assert f64.kernel_codes() == (tops.MSG_CUSTOM, 0, torch.float32)
    i64 = tops.EdgeOp(name="i64", combine="min", identity=INF,
                      source_value=0, message=tops._sum_message,
                      dtype=torch.int64)
    assert i64.kernel_codes() == (0, 0, torch.int32)


def test_bf16_dist_reaches_the_host_as_float32():
    """numpy has no bfloat16: a bfloat16 run's ``dist`` (and a batch's)
    is a float32 array of the exact bfloat16 values, NaN and −0.0 kept;
    float16 and the integer types keep their numpy dtypes."""
    t = torch.tensor([0.0, -0.0, float("nan"), 1.0078125, float("inf"),
                      3.3895e38], dtype=BF16)
    h = tops.host_values(t)
    assert h.dtype == np.float32
    np.testing.assert_array_equal(h.view(np.uint32) >> 16,
                                  t.view(torch.int16).numpy().view(np.uint16))
    for dtype, want in ((F16, np.float16), (torch.int8, np.int8),
                        (torch.uint8, np.uint8), (torch.int16, np.int16)):
        assert tops.host_values(torch.zeros(2, dtype=dtype)).dtype == want
    got = _run("bf16_sssp", "WD", "stepped")
    assert got.dist.dtype == np.float32
    np.testing.assert_array_equal(
        torch.from_numpy(got.dist).to(BF16).float().numpy(), got.dist)
    batch = engine.run_batch(GRAPHS["rmat"], [0, 1], op=OPS["bf16_sssp"][1],
                             device="cpu")
    assert batch.dist.dtype == np.float32


NAN = float("nan")
#: values whose folds order matters for a careless min/max
FOLD_VALUES = np.array([0.0, -0.0, NAN, -NAN, 1.0, -1.0, np.inf, -np.inf,
                        2.5], np.float32)


@pytest.mark.parametrize("combine", ["min", "max"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16_bit_fold_of_signed_zeros_and_nan_matches_reference(dtype,
                                                               combine):
    """B2's plain fold (``EdgeOp.scatter``, then ``apply_proposal``) at
    the width of a 16-bit float, against the reference's ``.at[].min/max``
    relax: random lanes over −0.0, +0.0, NaN and ±inf, with an ``update``
    that admits a NaN candidate.  −0.0 ranks below +0.0 whatever the
    lanes' order; NaN absorbs (NaN for NaN).  ``_scatter_ordered``
    once viewed every float's values as int32 and raised here."""
    jd, td = {"bfloat16": (jnp.bfloat16, BF16),
              "float16": (jnp.float16, F16)}[dtype]
    better = (lambda c, cur: c < cur) if combine == "min" else \
        (lambda c, cur: c > cur)
    ident = np.inf if combine == "min" else -np.inf
    jop, top = _pair(f"nan_{combine}", combine, ident, 0.0,
                     lambda v, w: v * 1.0, lambda v, w: v * 1.0, jd, td)
    import dataclasses
    jop = dataclasses.replace(jop, update=lambda c, cur: better(c, cur)
                              | (c != c))
    top = dataclasses.replace(top, update=lambda c, cur: better(c, cur)
                              | (c != c))
    rng = np.random.default_rng(7)
    for trial in range(40):
        n, lanes = 6, 24
        dist = rng.choice(FOLD_VALUES, n)
        src = rng.integers(0, n, lanes).astype(np.int32)
        dst = rng.integers(0, n, lanes).astype(np.int32)
        w = np.ones(lanes, np.int32)
        valid = rng.random(lanes) < 0.8
        want, _, want_imp = jstrategies._apply_relax(
            jnp.asarray(dist, jd), jnp.zeros(n, bool), jnp.asarray(src),
            jnp.asarray(dst), jnp.asarray(w), jnp.asarray(valid), op=jop)
        want = np.asarray(want).astype(np.float32)
        args = (torch.from_numpy(src), torch.from_numpy(dst),
                torch.from_numpy(w), torch.from_numpy(valid))
        tdist = torch.from_numpy(dist).to(td)
        for got, imp in (
                relax.apply_relax_plain(tdist.clone(),
                                        torch.zeros(n, dtype=torch.bool),
                                        *args, op=top)[::2],
                relax.apply_relax(tdist.clone(),
                                  torch.zeros(n, dtype=torch.bool), *args,
                                  op=top)[::2]):
            assert got.dtype == td
            got = got.float().numpy()
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            real = ~np.isnan(want)
            np.testing.assert_array_equal(got[real], want[real])
            np.testing.assert_array_equal(np.signbit(got[real]),
                                          np.signbit(want[real]))
            np.testing.assert_array_equal(imp.numpy(), np.asarray(want_imp))


@pytest.mark.parametrize("combine", ["min", "max"])
@pytest.mark.parametrize("dtype", [BF16, F16])
def test_16_bit_scatter_writes_the_fold_nan(dtype, combine):
    """A NaN candidate leaves the 16-bit fold's NaN (``FOLD_NAN_BITS[16]``,
    the pattern the card's fold writes); a NaN already in dist keeps its
    bits; −0.0 and +0.0 fold to the combine's zero."""
    op = tops.EdgeOp(name="z", combine=combine, identity=0.0,
                     source_value=0.0, message=lambda v, w: v, dtype=dtype)
    nan_in = torch.tensor([NAN], dtype=dtype)
    dist = torch.tensor([1.0, NAN, 0.0, 0.0], dtype=dtype)
    kept = dist.view(torch.int16)[1].item()
    vals = torch.cat([nan_in, torch.tensor([2.0, -0.0, 0.0], dtype=dtype)])
    out = op.scatter(dist, torch.tensor([0, 1, 2, 3]), vals,
                     torch.ones(4, dtype=torch.bool))
    bits = out.view(torch.int16).tolist()
    assert bits[0] == tops.FOLD_NAN_BITS[16][combine]
    assert bits[1] == kept
    zero = out[2:].signbit().tolist()
    assert zero == ([True, False] if combine == "min" else [False, False])


BUCKET_CASES = {
    "int16": (jnp.int16, torch.int16),
    "int8": (jnp.int8, torch.int8),
    "uint8": (jnp.uint8, torch.uint8),
    "bfloat16": (jnp.bfloat16, BF16),
    "float16": (jnp.float16, F16),
}


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", list(BUCKET_CASES))
def test_bucket_index_matches_reference_in_each_type(dtype, descending):
    """``worklist.bucket_rank``/``bucket_index`` computed in the value
    type, as the reference computes them: INF converted as JAX's weak
    clip bound converts it (int16 and int8: -1, so every rank is -1 and
    its reflection 0; uint8: 255; bfloat16: 2^30; float16: inf), the
    reflection wrapping or rounding, a float16 rank that is not finite in
    bucket 0.  (torch refuses a clip bound outside the type, so the
    bound is converted first.)"""
    jd, td = BUCKET_CASES[dtype]
    if td.is_floating_point:
        vals = np.array([-3.0, -0.0, 0.0, 5.0, 17.0, 255.0, 1000.0, 32767.0,
                         65504.0, 2.0 ** 30, np.inf, 3.0e38], np.float32)
        tv = torch.from_numpy(vals).to(td)
        jv = jnp.asarray(vals, jd)
    else:
        info = np.iinfo(np.dtype(jd))
        vals = np.array([info.min, -3, 0, 5, 17, 100, info.max], np.int64)
        tv = torch.from_numpy(vals).to(td)
        jv = jnp.asarray(vals).astype(jd)
    for delta in (1, 4, 25):
        want = np.asarray(jworklist.bucket_index(
            jv, jnp.int32(delta), descending=descending))
        got = worklist.bucket_index(tv, delta, descending=descending)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    rank = worklist.bucket_rank(tv, descending=descending)
    assert rank.dtype == td
    want_rank = np.asarray(jworklist.bucket_rank(jv, descending=descending))
    np.testing.assert_array_equal(rank.float().numpy(),
                                  want_rank.astype(np.float32))


def test_reference_add_with_nonzero_identity_depends_on_its_schedule():
    """The reference's fault (ROADMAP queue C, "The reference's faults"):
    ``add`` with identity 7 on the layered DAG (source 1, message ``v``)
    adds the identity at every masked lane, so its answer at node 1
    depends on the strategy and the mode.  No kernel ports it:
    ``kernel_codes`` raises, naming the fault.  If this starts failing,
    the reference folds a monoid and the port can follow."""
    jop = jops.EdgeOp(name="add7", combine="add", identity=7,
                      source_value=1, message=lambda v, w: v)
    top = tops.EdgeOp(name="add7", combine="add", identity=7,
                      source_value=1, message=lambda v, w: v)
    got = {}
    for strategy in ("WD", "BS"):
        for mode in ("stepped", "fused"):
            got[(strategy, mode)] = int(np.asarray(jengine.run(
                JAX_GRAPHS["dag"], 1, jengine.make_strategy(strategy),
                op=jop, mode=mode).dist)[1])
    assert len(set(got.values())) > 2, got
    with pytest.raises(NotImplementedError, match="reference's faults"):
        top.kernel_codes()
