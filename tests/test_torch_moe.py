"""The port's MoE serving path against the JAX reference, on the CPU.

``repro_torch.moe.balancing`` (routing, capacity calibration, the four
dispatch policies), ``repro_torch.models.moe`` and the smoke-size
``granite_moe_3b_a800m`` and ``jamba_1_5_large_398b`` models are held to
``repro.moe.balancing``, ``repro.models.moe`` and ``repro.models.model``
on the same numpy inputs and weights (drawn by the reference's init
rules).

Integers are held bit for bit: routing ids, and each assignment's position
in its expert's queue (so the keep masks of every policy, also where
assignments drop).  Floats, in float32: one MoE layer within 1e-5 of the
largest magnitude (the same products in another summation order); the
drop statistics within 1e-7 (XLA folds ``1 - kept / n`` into one fused
multiply-add with the reciprocal of ``n``, PyTorch divides: the last bit
may differ).  The smoke models within 1e-3 of the largest logit: neither
has qk-norm, its attention logits reach ~50, where one float32 ulp of a
logit moves a softmax weight by ~4e-6, and both packages are that far
from a float64 attention; four to eight layers take the difference to
2.5e-4 (granite) and 1.2e-4 (jamba) of the largest logit.  bfloat16 as
loosely as ``tests/test_torch_models.py`` holds its models.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models.model import LanguageModel as JModel
from repro.models.moe import moe_capacity as j_moe_capacity
from repro.models.moe import moe_ffn as j_moe_ffn
from repro.models.moe import moe_specs as j_moe_specs
from repro.moe import balancing as jb
from repro_torch.configs import get_config
from repro_torch.models.layers import rmsnorm
from repro_torch.models.model import LanguageModel
from repro_torch.models.moe import moe_capacity, moe_ffn, moe_specs
from repro_torch.models.params import from_reference, leaves, to_tensor
from repro_torch.moe import balancing as tb

B, S = 2, 40
#: the reference's routing, compiled once (eager, each op compiles alone)
j_topk_route = jax.jit(jb.topk_route, static_argnums=1)
DECODE_POS = np.array([S, S - 7])      # ragged: slot 1 rewinds 7 positions
STEPS = 2
MODEL_TOL = 1e-3
LAYER_TOL = 1e-5
STAT_TOL = 1e-7


def _t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a))


def _close(got, want, tol, err_msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, err_msg
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=err_msg)


def _logits(shape, seed, scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# routing and capacity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,k", [(8, 2), (40, 8), (16, 2)])
def test_topk_route_matches_reference(e, k):
    logits = _logits((B, S, e), e * 10 + k)
    jw, jid, jaux = j_topk_route(jnp.asarray(logits), k)
    tw, tid, taux = tb.topk_route(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    _close(tw.numpy(), jw, LAYER_TOL)
    for key in ("lb_loss", "z_loss"):
        _close(taux[key].numpy(), jaux[key], LAYER_TOL, key)


def test_topk_route_ties_take_the_lower_index():
    """A zero router gives every expert the same probability: both
    packages take experts 0..k-1, with equal weights."""
    logits = np.zeros((B, 5, 40), np.float32)
    logits[1, 2, [7, 9, 30]] = 1.0          # three tied winners, then ties
    jw, jid, jaux = j_topk_route(jnp.asarray(logits), 8)
    tw, tid, taux = tb.topk_route(torch.from_numpy(logits), 8)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(tid[0, 0].numpy(), np.arange(8))
    np.testing.assert_array_equal(tid[1, 2, :4].numpy(), [7, 9, 30, 0])
    _close(tw.numpy(), jw, LAYER_TOL)
    _close(taux["lb_loss"].numpy(), jaux["lb_loss"], LAYER_TOL)


@pytest.mark.parametrize("loads", [
    [], [0, 0], [1, 1, 0], [3, 9, 27, 2, 2, 2, 5, 0, 1],
    list(np.random.default_rng(3).poisson(12, 40)),
    list(np.random.default_rng(4).zipf(1.6, 64) % 500)])
def test_calibrate_capacity_matches_reference(loads):
    loads = np.asarray(loads, np.int64)
    for bins in (4, 10):
        assert tb.calibrate_capacity(loads, bins) == jb.calibrate_capacity(
            loads, bins)


def test_moe_capacity_matches_reference():
    for arch in ("granite_moe_3b_a800m", "jamba_1_5_large_398b"):
        for cfg_t, cfg_j in ((get_config(arch), j_get_config(arch)),
                             (get_config(arch).smoke(),
                              j_get_config(arch).smoke())):
            for seq in (1, 7, 40, 256, 2048):
                assert moe_capacity(cfg_t, seq) == j_moe_capacity(cfg_j, seq)
    assert moe_capacity(get_config("granite_moe_3b_a800m"), 1) == 4
    assert moe_capacity(get_config("granite_moe_3b_a800m"), 2048) == 513


# ---------------------------------------------------------------------------
# the four dispatch policies
# ---------------------------------------------------------------------------

E, K, D, FF = 8, 2, 32, 48


def _experts(seed, activation="swiglu"):
    rng = np.random.default_rng(seed)
    ex = {"w_up": rng.standard_normal((E, D, FF)) / np.sqrt(D),
          "w_gate": rng.standard_normal((E, D, FF)) / np.sqrt(D),
          "w_down": rng.standard_normal((E, FF, D)) / np.sqrt(FF)}
    if activation != "swiglu":
        del ex["w_gate"]
    return {k: v.astype(np.float32) for k, v in ex.items()}


def _routing(seed, skew):
    """x [B,S,D] and a top-K routing whose expert loads are skewed
    (``skew`` > 0 piles assignments on the low experts)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    logits = _logits((B, S, E), seed + 1) - skew * np.arange(E)
    jw, jid, _ = j_topk_route(jnp.asarray(logits), K)
    return x, np.asarray(jid), np.asarray(jw)


@pytest.mark.parametrize("method", tb.DISPATCH_METHODS)
@pytest.mark.parametrize("capacity", [4, 40], ids=["drops", "no_drop"])
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_moe_dispatch_matches_reference(method, capacity, activation):
    x, ids, w = _routing(11, skew=0.6)
    ex = _experts(12, activation)
    jy, jst = jb.moe_dispatch(
        jnp.asarray(x), jnp.asarray(ids), jnp.asarray(w),
        {k: jnp.asarray(v) for k, v in ex.items()}, num_experts=E,
        capacity=capacity, activation=activation, method=method)
    ty, tst = tb.moe_dispatch(
        torch.from_numpy(x), torch.from_numpy(ids), torch.from_numpy(w),
        {k: torch.from_numpy(v) for k, v in ex.items()}, num_experts=E,
        capacity=capacity, activation=activation, method=method)
    _close(ty.numpy(), jy, LAYER_TOL, method)
    for key in ("dropped_frac", "padding_waste"):
        assert tst[key].dtype == torch.float32
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   rtol=0, atol=STAT_TOL, err_msg=key)
    if method != "sorted_block":
        want_drop = 0.0 if capacity == 40 else None
        if want_drop is not None:
            assert float(tst["dropped_frac"]) == want_drop
        else:
            assert float(tst["dropped_frac"]) > 0


def test_positions_and_keep_masks_are_bit_identical():
    """Each assignment's place in its expert's queue of its row, in
    token-major, k-minor order: the keep masks of every capacity agree
    with the reference's, also where assignments drop."""
    _, ids, _ = _routing(21, skew=0.9)
    ida = ids.reshape(B, S * K)
    jpos, _ = jb._positions(jnp.asarray(ida), E)
    tpos, _ = tb._positions(torch.from_numpy(ida), E)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for cap in (1, 3, 4, 10, 80):
        keep = tpos.numpy() < cap
        np.testing.assert_array_equal(keep, np.asarray(jpos) < cap)
    assert (np.asarray(jpos) >= 4).any()        # a capacity of 4 drops


def test_unknown_dispatch_method_raises():
    x, ids, w = _routing(1, skew=0.0)
    with pytest.raises(ValueError, match="unknown dispatch method"):
        tb.moe_dispatch(torch.from_numpy(x), torch.from_numpy(ids),
                        torch.from_numpy(w),
                        {k: torch.from_numpy(v)
                         for k, v in _experts(2).items()},
                        num_experts=E, capacity=4, method="greedy")


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shared", [
    ("granite_moe_3b_a800m", 0), ("jamba_1_5_large_398b", 0),
    ("granite_moe_3b_a800m", 1)])
def test_moe_ffn_matches_reference(arch, shared):
    jcfg = j_get_config(arch).smoke(dtype="float32",
                                    num_shared_experts=shared)
    tcfg = get_config(arch).smoke(dtype="float32",
                                  num_shared_experts=shared)
    jp = jax.tree_util.tree_map(np.asarray,
                                _numpy_params(j_moe_specs(jcfg), 3))
    tspecs = dict(leaves(moe_specs(tcfg)))
    tp = jax.tree_util.tree_map(_t, jp)
    assert {p: tuple(s.shape) for p, s in tspecs.items()} == {
        p: tuple(a.shape) for p, a in leaves(tp)}
    x = np.random.default_rng(4).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    jy, jaux = j_moe_ffn(jp, jcfg, jnp.asarray(x))
    ty, taux = moe_ffn(tp, tcfg, torch.from_numpy(x))
    _close(ty.numpy(), jy, LAYER_TOL)
    for key in ("lb_loss", "z_loss"):
        _close(taux[key].numpy(), jaux[key], LAYER_TOL, key)
    for key in ("dropped_frac", "padding_waste"):
        np.testing.assert_allclose(taux[key].numpy(), np.asarray(jaux[key]),
                                   rtol=0, atol=STAT_TOL, err_msg=key)
    assert taux["ids"].shape == (B, S, tcfg.experts_per_token)


# ---------------------------------------------------------------------------
# the smoke models through from_reference
# ---------------------------------------------------------------------------

def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(2, vocab, shape).astype(
        np.int32)


def _numpy_params(specs, seed):
    """The reference's parameter tree drawn with numpy, by the reference's
    init rules (its own ``init_params`` draws each leaf shape eagerly and
    takes ~15 s for the jamba smoke model)."""
    rng = np.random.default_rng(seed)

    def make(s):
        if s.init == "zeros":
            return jnp.zeros(s.shape, s.dtype)
        if s.init == "ones":
            return jnp.ones(s.shape, s.dtype)
        std = s.scale
        if s.init == "scaled":
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            std = s.scale / np.sqrt(max(fan_in, 1))
        a = rng.standard_normal(s.shape, dtype=np.float32) * np.float32(std)
        return jnp.asarray(a).astype(s.dtype)
    return jax.tree_util.tree_map(make, specs,
                                  is_leaf=lambda x: hasattr(x, "pspec"))


def _models(arch, dtype):
    jcfg = dataclasses.replace(j_get_config(arch).smoke(dtype=dtype),
                               remat=False)
    jm = JModel(jcfg)
    jparams = _numpy_params(jm.param_specs(), 0)
    tm = LanguageModel(get_config(arch).smoke(dtype=dtype), device="cpu")
    from_reference(tm, jax.tree_util.tree_map(np.asarray, jparams))
    return jm, jparams, tm


@pytest.fixture(scope="module",
                params=["granite_moe_3b_a800m", "jamba_1_5_large_398b"])
def f32_run(request):
    """Prefill + STEPS ragged decode steps through both packages: the
    (port, reference) logits of each call, and the port's routing."""
    jm, jparams, tm = _models(request.param, "float32")
    cfg = tm.cfg
    max_len = S + 8
    prompt = _tokens(cfg.vocab_size, (B, S), 1)
    steps = _tokens(cfg.vocab_size, (STEPS, B, 1), 2)
    jcache = _numpy_params(jm.cache_specs(B, max_len), 0)
    jl, jcache, _ = jax.jit(jm.forward, static_argnames="mode")(
        jparams, {"tokens": jnp.asarray(prompt)}, mode="prefill",
        cache=jcache)
    tl, tcache = tm(torch.from_numpy(prompt).long(),
                    cache=tm.new_cache(B, max_len))
    out = [(tl.numpy(), np.asarray(jl))]
    decode = jax.jit(jm.decode_step)
    for t in range(STEPS):
        pos = DECODE_POS + t
        jl, jcache = decode(jparams, jcache, jnp.asarray(steps[t]),
                            jnp.asarray(pos, jnp.int32))
        tl, tcache = tm.decode_step(tcache, torch.from_numpy(steps[t]).long(),
                                    torch.from_numpy(pos))
        out.append((tl.numpy(), np.asarray(jl)))
    return request.param, tm, out


def test_moe_prefill_logits_match_reference(f32_run):
    _, _, out = f32_run
    got, want = out[0]
    assert got.shape == want.shape == (B, S, got.shape[-1])
    _close(got, want, MODEL_TOL)


def test_moe_ragged_decode_logits_match_reference(f32_run):
    _, _, out = f32_run
    for got, want in out[1:]:
        assert got.shape == want.shape == (B, 1, got.shape[-1])
        _close(got, want, MODEL_TOL)


def test_moe_routing_is_recorded_for_every_moe_layer(f32_run):
    """Each MoE layer's block returns its routing (router logits, ids) in
    its aux, a dense layer None; the layers run one by one give the
    prefill's logits."""
    arch, tm, out = f32_run
    cfg = tm.cfg
    prompt = torch.from_numpy(_tokens(cfg.vocab_size, (B, S), 1)).long()
    positions = torch.arange(S, dtype=torch.int32).expand(B, S)
    h, routing = tm.embed_tokens(prompt), []
    for i in range(cfg.num_layers):
        h, aux = tm._block(i, h, positions, None, "prefill", None)
        assert (aux is None) == (not cfg.layer_is_moe(i)), (arch, i)
        if aux is not None:
            routing.append((i, aux["router_logits"], aux["ids"]))
    logits = tm.unembed(rmsnorm(tm.final_norm, h))
    np.testing.assert_array_equal(logits.numpy(), out[0][0])
    assert [i for i, _, _ in routing] == [
        i for i in range(cfg.num_layers) if cfg.layer_is_moe(i)]
    for i, logits, ids in routing:
        assert logits.dtype == torch.float32
        assert logits.shape == (B, S, tm.cfg.num_experts)
        assert ids.shape == (B, S, tm.cfg.experts_per_token)
        want = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True,
                          stable=True).indices[..., :ids.shape[-1]]
        assert torch.equal(ids, want), (arch, i)


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m"])
def test_moe_bf16_smoke_matches_reference_loosely(arch):
    """bfloat16 prefill, as loosely as the dense models are held
    (tests/test_torch_models.py): the frameworks round at other points.
    Upstream of a router such a difference can flip a near-tied expert,
    which moves that token's logits by up to ~30% of their scale
    (measured: 2 of 80 positions past 20%, RMS error 8.8%, greedy tokens
    96% equal), so the largest error is held per position: at most 5% of
    the positions past 20% of the scale."""
    jm, jparams, tm = _models(arch, "bfloat16")
    prompt = _tokens(tm.cfg.vocab_size, (B, S), 1)
    jl, _, _ = jm.forward(jparams, {"tokens": jnp.asarray(prompt)},
                          mode="prefill")
    tl, _ = tm(torch.from_numpy(prompt).long())
    got, want = tl.float().numpy(), np.asarray(jl, np.float32)
    rms = np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean())
    assert rms <= 0.1, rms
    far = np.abs(got - want).max(-1) > 0.2 * np.abs(want).max()
    assert far.mean() <= 0.05, far.sum()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


@pytest.mark.parametrize("arch,count", [
    ("granite_moe_3b_a800m", 3_374_295_552), ("jamba_1_5_large_398b", None)])
def test_moe_param_counts_equal_reference(arch, count):
    want = j_get_config(arch).num_params()
    assert get_config(arch).num_params() == want
    assert get_config(arch).active_params() == j_get_config(
        arch).active_params()
    if count is not None:
        assert want == count
