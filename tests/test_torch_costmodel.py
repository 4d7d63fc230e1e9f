"""The port's measured cost model for AD (``repro_torch.core.costmodel``,
ROADMAP A9) against the reference's (``repro.core.costmodel``), on the
CPU: ``fit``, ``predict``, ``choose`` and ``observe`` equal on the same
rows and times; the save/load/cache round trip and the foreign-payload
error; the kernel order; and AD driven by the same fitted model, stepped
and fused (the fused kernel's plain loop), equal to the reference's
``dist``, iterations, edges and ``kernel_counts``.  The selector's float32
order is held on ties and near ties, where a fused multiply-add would
round once and flip the argmin."""

import json

import numpy as np
import pytest
import torch

from repro.core import costmodel as jcostmodel
from repro.core import engine as jengine
from repro.core import fused as jfused
from repro.data import graphs as jgraphs
from repro_torch.core import costmodel, engine, fused
from repro_torch.core.graph import CSRGraph
from repro_torch.core.strategies import make_strategy
from repro_torch.kernels import fused as fused_kernel

JAX_RMAT = jgraphs.rmat_graph(scale=9, edge_factor=8, weighted=True, seed=1)
RMAT = CSRGraph.from_arrays(np.asarray(JAX_RMAT.row_ptr),
                            np.asarray(JAX_RMAT.col),
                            np.asarray(JAX_RMAT.wt), device="cpu")


def _synthetic():
    """The reference's calibration rows on rmat9, and times that make BS
    cheap on small edge totals, HP on large ones and WD between."""
    degrees = np.asarray(JAX_RMAT.degrees)
    rows = np.asarray([jcostmodel._features(int(degrees[m].sum()),
                                            int(m.sum()))
                       for m in jcostmodel._calibration_masks(
                           JAX_RMAT.num_nodes, degrees)])
    es, cn = rows[:, 1], rows[:, 2]
    times = np.stack([1e-5 + 4e-8 * es + 1e-9 * cn,
                      4e-5 + 1e-8 * es + 2e-8 * cn,
                      9e-5 + 2e-9 * es + 5e-8 * cn], axis=1)
    return rows, times


def test_kernel_order_and_constants():
    assert costmodel.KERNELS == fused._AD_KERNEL_ORDER == jcostmodel.KERNELS
    assert jfused._AD_KERNEL_ORDER == costmodel.KERNELS
    assert (costmodel.VERSION, costmodel.DENSITIES, costmodel.RIDGE) == (
        jcostmodel.VERSION, jcostmodel.DENSITIES, jcostmodel.RIDGE)
    degrees = RMAT.degrees.numpy()
    for got, want in zip(
            costmodel._calibration_masks(RMAT.num_nodes, degrees),
            jcostmodel._calibration_masks(RMAT.num_nodes, degrees)):
        np.testing.assert_array_equal(got, want)


def test_fit_predict_choose_observe_match_reference():
    rows, times = _synthetic()
    got = costmodel.fit(rows, times)
    want = jcostmodel.fit(rows, times)
    np.testing.assert_array_equal(got.coeffs, want.coeffs)
    np.testing.assert_array_equal(got.xtx, want.xtx)
    np.testing.assert_array_equal(got.coeff_array(), want.coeff_array())
    rng = np.random.default_rng(0)
    pairs = [(0, 0), (0, 5), (5, 0), (1, 1)] + [
        (int(c), int(e)) for c, e in zip(rng.integers(1, 600, 40),
                                         rng.integers(1, 60000, 40))]
    chosen = set()
    for count, es in pairs:
        np.testing.assert_array_equal(got.predict(count, es),
                                      want.predict(count, es))
        assert got.choose(count, es) == want.choose(count, es)
        chosen.add(got.choose(count, es))
    assert chosen == {"BS", "WD", "HP"}
    for k, (count, es) in enumerate(pairs[4:14]):
        kernel = costmodel.KERNELS[k % 3]
        got.observe(kernel, es, count, 1e-5 * (k + 1))
        want.observe(kernel, es, count, 1e-5 * (k + 1))
    got.observe("EP", 1, 1, 1.0)                 # ignored, as the reference
    got.observe("WD", 1, 1, float("nan"))
    np.testing.assert_array_equal(got.coeffs, want.coeffs)
    fresh = costmodel.CostModel.fresh()
    assert fresh.choose(10, 100) == "BS"         # all-zero: ties take BS


def _fma_flips(coeffs, n: int = 4000, seed: int = 0) -> list:
    """``(count, degree_sum)`` pairs whose argmin changes when each cost is
    contracted into FMAs (``fma(c, cn, fma(b, es, a))``, one rounding
    each) instead of rounded after every operation."""
    rng = np.random.default_rng(seed)
    c = np.asarray(coeffs, np.float32)
    es = rng.integers(1, 2 ** 31 - 1, n).astype(np.float32)
    cn = rng.integers(1, 2 ** 20, n).astype(np.float32)
    sep = c[None, :, 0] + c[None, :, 1] * es[:, None] + (
        c[None, :, 2] * cn[:, None])
    f64 = np.float64
    inner = (f64(c[None, :, 1]) * f64(es[:, None])
             + f64(c[None, :, 0])).astype(np.float32)
    fma = (f64(c[None, :, 2]) * f64(cn[:, None]) + f64(inner)).astype(
        np.float32)
    flip = np.argmin(sep, 1) != np.argmin(fma, 1)
    return [(int(a), int(b)) for a, b in zip(cn[flip], es[flip])]


#: BS and WD differ by -1 in a: where b·es is large, rounding after each
#: operation makes them tie (BS wins), while contracted WD's cost can
#: round below BS's
NEAR_TIE = np.array([[0.0, 1.0 / 3.0, 0.0],
                     [-1.0, 1.0 / 3.0, 0.0],
                     [1e12, 0.0, 0.0]])


def test_ties_and_the_float32_order():
    """Exact ties take the first kernel; on pairs where an FMA would flip
    the argmin, the reference's separately rounded order holds; the
    probe's plain version equals ``choose``."""
    flips = _fma_flips(NEAR_TIE)
    assert len(flips) >= 10
    tie = np.array([[1.0, 2.0, 3.0]] * 3)
    for coeffs, pairs in ((NEAR_TIE, flips), (tie, [(5, 50), (1, 1)])):
        got = costmodel.CostModel(coeffs=coeffs)
        want = jcostmodel.CostModel(coeffs=coeffs)
        pairs = pairs + [(0, 5), (5, 0)]
        counts = torch.tensor([c for c, _ in pairs], dtype=torch.int32)
        sums = torch.tensor([e for _, e in pairs], dtype=torch.int32)
        probe = fused_kernel.ad_choice_probe(got.coeff_array(), counts, sums)
        for (c, e), p in zip(pairs, probe.tolist()):
            assert got.choose(c, e) == want.choose(c, e)
            assert costmodel.KERNELS[p] == got.choose(c, e)
    assert costmodel.CostModel(coeffs=tie).choose(5, 50) == "BS"


def test_save_load_and_cache(tmp_path):
    rows, times = _synthetic()
    model = costmodel.fit(rows, times, calibrated_on={"n": 1})
    path = str(tmp_path / "m.json")
    model.save(path)
    back = costmodel.CostModel.load(path)
    np.testing.assert_array_equal(back.coeffs, model.coeffs)
    np.testing.assert_array_equal(back.xty, model.xty)
    assert back.calibrated_on == {"n": 1}
    # the reference's payload has the same layout: either side reads it
    jpath = str(tmp_path / "j.json")
    jcostmodel.fit(rows, times).save(jpath)
    np.testing.assert_array_equal(costmodel.CostModel.load(jpath).coeffs,
                                  model.coeffs)
    foreign = dict(model.to_dict(), version=costmodel.VERSION + 1)
    with pytest.raises(ValueError, match="incompatible"):
        costmodel.CostModel.from_dict(foreign)
    with pytest.raises(ValueError, match="incompatible"):
        costmodel.CostModel.from_dict(dict(model.to_dict(),
                                           kernels=["BS", "WD"]))

    small = CSRGraph.from_arrays(*(np.asarray(a) for a in (
        JAX_RMAT.row_ptr, JAX_RMAT.col, JAX_RMAT.wt)), device="cpu")
    cache = str(tmp_path / "cache")
    m1, hit1 = costmodel.calibrate(small, device="cpu", cache_dir=cache,
                                   repeats=1)
    m2, hit2 = costmodel.calibrate(small, device="cpu", cache_dir=cache,
                                   repeats=1)
    assert (hit1, hit2) == (False, True)
    np.testing.assert_array_equal(m1.coeffs, m2.coeffs)
    sig = costmodel.graph_signature(small, "cpu")
    assert sig["device"] == "cpu" and m2.calibrated_on == sig
    path = costmodel.cache_path(cache, sig)
    jsig = jcostmodel.graph_signature(JAX_RMAT, "xla")
    assert path != jcostmodel.cache_path(cache, jsig)   # never collide
    # a foreign payload in the cache file is timed anew, not trusted
    with open(path, "w") as fh:
        json.dump(foreign, fh)
    _, hit3 = costmodel.calibrate(small, device="cpu", cache_dir=cache,
                                  repeats=1)
    assert not hit3
    rows, times = costmodel.measure(small, device="cpu", repeats=1)
    assert rows.shape == (9, 3) and times.shape == (9, 3)
    assert (times > 0).all()


def test_main_reports_the_cache(tmp_path, capsys):
    args = ["--cache", str(tmp_path), "--scale", "5", "--device", "cpu",
            "--repeats", "1"]
    assert costmodel.main(args) == 0
    assert costmodel.main(args) == 0
    out = capsys.readouterr().out
    assert out.count("cache: miss") == 1 and out.count("cache: hit") == 1


def test_block_feasibility_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        costmodel.block_feasibility("cpu")


@pytest.mark.parametrize("mode", ["stepped", "fused"])
def test_measured_ad_matches_reference(mode):
    """The same fitted model in both engines: equal values, iterations,
    edges and choices, which span BS, WD and HP."""
    rows, times = _synthetic()
    src = int(np.argmax(np.asarray(JAX_RMAT.degrees)))
    jstrat = jengine.make_strategy("AD",
                                   cost_model=jcostmodel.fit(rows, times))
    want = jengine.run(JAX_RMAT, src, jstrat, mode=mode)
    strat = make_strategy("AD", cost_model=costmodel.fit(rows, times))
    got = engine.run(RMAT, src, strat, mode=mode, device="cpu")
    np.testing.assert_array_equal(got.dist, np.asarray(want.dist))
    assert (got.iterations, got.edges_relaxed) == (want.iterations,
                                                   want.edges_relaxed)
    assert strat.kernel_counts == jstrat.kernel_counts
    assert len(strat.kernel_counts) >= 2
    if mode == "stepped":
        assert [s.kernel for s in got.iter_stats] == [
            s.kernel for s in want.iter_stats]
        np.testing.assert_array_equal(
            got.dist, engine.reference_distances(RMAT, src))


def test_online_refinement_observes_each_iteration():
    model = costmodel.CostModel.fresh()
    strat = make_strategy("AD", cost_model=model, online=True)
    src = int(RMAT.degrees.argmax())
    r = engine.run(RMAT, src, strat, device="cpu")
    np.testing.assert_array_equal(r.dist,
                                  engine.reference_distances(RMAT, src))
    # every iteration folded one row [1, es, cn] into its kernel's
    # equations: the constant terms count the iterations
    observed = model.xtx[:, 0, 0] - costmodel.RIDGE
    assert round(float(observed.sum())) == r.iterations
    assert model.coeffs.any()
