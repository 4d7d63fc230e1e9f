"""The port's language models against the JAX reference, on the CPU.

Smoke-size ``qwen3_0_6b`` (dense GQA, qk-norm, B4 on the prefill path) and
``mamba2_780m`` (SSD, B5 on the prefill path) run with the reference's own
weights (``init_params(..., PRNGKey(0))``), carried across by
``from_reference``.  Prefill logits over a 40-token prompt (mamba: two
32-token chunks and a ragged tail) and three decode steps at ragged
per-slot positions must agree in logits and in the updated caches.

Tolerance, float32: rtol = 1e-4 and atol = 1e-4 of the largest magnitude
of the compared tensor — the same math in another summation order (einsum
contraction order, the port's plain B4/B5 versions against XLA's blocked
attention and einsums, XLA's and Sleef's exp).  One smoke mamba layer
differs by ~1e-6 of its output's scale; four layers and the unembedding
take that to ~2e-5 of the logits' scale, so an absolute 1e-4 would fail
on logits near 0 while the largest are ~10.  bfloat16: the two
frameworks round at other points (XLA fuses elementwise chains in float32,
PyTorch rounds after every op), and at smoke size the activations reach
20-50, where a bfloat16 step is 0.125-0.25: logits are held to an RMS
error of 10% and a largest error of 20% (prefill) or 10% (one decode
step) of the logits' scale, and 90% of the prefill's greedy tokens must
be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.models.model import LanguageModel as JModel
from repro.models.params import init_params as j_init_params
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.models.model import LanguageModel
from repro_torch.models.params import from_reference, leaves, to_tensor

B, S, STEPS = 2, 40, 3
DECODE_POS = np.array([S, S - 7])      # ragged: slot 1 rewinds 7 positions


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(
        got, want, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(want).max())),
        err_msg=err_msg)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(2, vocab, shape).astype(
        np.int32)


def _ref_layer_cache(jmodel, cache, i):
    """Layer i's mixer cache from the reference's prefix/stacked-body
    layout."""
    if i < jmodel.prefix_len:
        return cache["prefix"][i]["self"]
    r, j = divmod(i - jmodel.prefix_len, jmodel.period)
    return jax.tree_util.tree_map(lambda a: a[r], cache["body"][j]["self"])


def _run_both(arch, dtype):
    """Prefill + STEPS ragged decode steps through both packages.  Returns
    lists of (port, reference) numpy pairs: logits per call, and the final
    cache leaves."""
    jcfg = dataclasses.replace(j_get_config(arch).smoke(dtype=dtype),
                               remat=False)
    tcfg = get_config(arch).smoke(dtype=dtype)
    jm = JModel(jcfg)
    jparams = j_init_params(jm.param_specs(), jax.random.PRNGKey(0))
    tm = LanguageModel(tcfg, device="cpu")
    from_reference(tm, jax.tree_util.tree_map(np.asarray, jparams))

    max_len = S + 8
    prompt = _tokens(tcfg.vocab_size, (B, S), 1)
    steps = _tokens(tcfg.vocab_size, (STEPS, B, 1), 2)
    jcache = j_init_params(jm.cache_specs(B, max_len), jax.random.PRNGKey(0))
    jl, jcache, _ = jm.forward(jparams, {"tokens": jnp.asarray(prompt)},
                               mode="prefill", cache=jcache)
    tcache = tm.new_cache(B, max_len)
    tl, tcache = tm(torch.from_numpy(prompt).long(), cache=tcache)
    logits = [(tl.float().numpy(), np.asarray(jl, np.float32))]
    decode = jax.jit(jm.decode_step)
    for t in range(STEPS):
        pos = DECODE_POS + t
        jl, jcache = decode(jparams, jcache, jnp.asarray(steps[t]),
                            jnp.asarray(pos, jnp.int32))
        tl, tcache = tm.decode_step(tcache, torch.from_numpy(steps[t]).long(),
                                    torch.from_numpy(pos))
        logits.append((tl.float().numpy(), np.asarray(jl, np.float32)))
    caches = []
    for i in range(tcfg.num_layers):
        ref = _ref_layer_cache(jm, jcache, i)
        for key, leaf in tcache["layers"][i].items():
            caches.append((f"layer{i}.{key}", leaf.float().numpy(),
                           np.asarray(ref[key], np.float32)))
    return logits, caches


@pytest.fixture(scope="module", params=["qwen3_0_6b", "mamba2_780m"])
def f32_run(request):
    return request.param, _run_both(request.param, "float32")


def test_prefill_logits_match_reference(f32_run):
    _, (logits, _) = f32_run
    got, want = logits[0]
    assert got.shape == want.shape == (B, S, got.shape[-1])
    _close(got, want)


def test_ragged_decode_logits_match_reference(f32_run):
    _, (logits, _) = f32_run
    for got, want in logits[1:]:
        assert got.shape == want.shape == (B, 1, got.shape[-1])
        _close(got, want)


def test_decode_caches_match_reference(f32_run):
    arch, (_, caches) = f32_run
    keys = {name.split(".")[1] for name, _, _ in caches}
    assert keys == ({"k", "v"} if arch == "qwen3_0_6b"
                    else {"ssm", "conv_x", "conv_B", "conv_C"})
    for name, got, want in caches:
        assert got.shape == want.shape, name
        _close(got, want, err_msg=name)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "mamba2_780m"])
def test_bf16_smoke_matches_reference_loosely(arch):
    """bfloat16: the prefill, and one ragged decode step from the
    reference's own prefill cache (carried into the port), so that the
    rounding differences of the prefill do not compound through the
    recurrent state.  Measured: prefill RMS error 0.6% (qwen3) and 3.9%
    (mamba2) of the logits' RMS; decode max error 5% of the largest
    logit (mamba2)."""
    jcfg = dataclasses.replace(j_get_config(arch).smoke(dtype="bfloat16"),
                               remat=False)
    tcfg = get_config(arch).smoke(dtype="bfloat16")
    jm = JModel(jcfg)
    jparams = j_init_params(jm.param_specs(), jax.random.PRNGKey(0))
    tm = LanguageModel(tcfg, device="cpu")
    from_reference(tm, jax.tree_util.tree_map(np.asarray, jparams))
    prompt = _tokens(tcfg.vocab_size, (B, S), 1)
    jcache = j_init_params(jm.cache_specs(B, S + 8), jax.random.PRNGKey(0))
    jl, jcache, _ = jm.forward(jparams, {"tokens": jnp.asarray(prompt)},
                               mode="prefill", cache=jcache)
    tl, _ = tm(torch.from_numpy(prompt).long(), cache=tm.new_cache(B, S + 8))
    got, want = tl.float().numpy(), np.asarray(jl, np.float32)
    rms = np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean())
    assert rms <= 0.1, rms
    assert np.abs(got - want).max() <= 0.2 * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9

    tcache = {"layers": [
        {key: to_tensor(np.asarray(_ref_layer_cache(jm, jcache, i)[key]))
         for key in layer} for i, layer in enumerate(
            tm.new_cache(B, S + 8)["layers"])]}
    step = _tokens(tcfg.vocab_size, (B, 1), 2)
    jl, _ = jm.decode_step(jparams, jcache, jnp.asarray(step),
                           jnp.asarray(DECODE_POS, jnp.int32))
    tl, _ = tm.decode_step(tcache, torch.from_numpy(step).long(),
                           torch.from_numpy(DECODE_POS))
    got, want = tl.float().numpy(), np.asarray(jl, np.float32)
    assert np.abs(got - want).max() <= 0.1 * np.abs(want).max()


# ---------------------------------------------------------------------------
# configs, parameter counts, unported features
# ---------------------------------------------------------------------------

def test_config_registry_equals_reference():
    assert ARCHITECTURES == J_ARCHS
    for arch in ARCHITECTURES:
        t, j = get_config(arch), j_get_config(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), arch
        assert (dataclasses.asdict(t.smoke())
                == dataclasses.asdict(j.smoke())), arch
        for i in range(t.num_layers):
            assert (t.layer_kind(i), t.layer_is_moe(i),
                    t.layer_is_cross_attn(i)) == (
                j.layer_kind(i), j.layer_is_moe(i),
                j.layer_is_cross_attn(i))
        if t.num_heads:
            assert t.resolved_head_dim == j.resolved_head_dim


@pytest.mark.parametrize("arch,count", [
    ("qwen3_0_6b", 596_049_920), ("mamba2_780m", 780_062_976),
    ("deepseek_7b", None), ("qwen1_5_4b", None), ("starcoder2_15b", None)])
def test_param_counts_equal_reference(arch, count):
    want = j_get_config(arch).num_params()
    assert get_config(arch).num_params() == want
    if count is not None:
        assert want == count


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "mamba2_780m"])
def test_param_tree_matches_reference_specs(arch):
    """Shapes and dtypes of every leaf equal the reference's (unstacked)."""
    cfg = get_config(arch).smoke()
    jm = JModel(j_get_config(arch).smoke())
    tm = LanguageModel(cfg, device="cpu")
    specs = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, jnp.dtype(s.dtype)), jm.param_specs(),
        is_leaf=lambda x: hasattr(x, "pspec"))
    from_reference(tm, specs)          # raises on any mismatch
    assert all(float(p.abs().sum()) == 0 for p in tm.parameters())


def test_full_width_mamba_has_zero_width_ffn():
    cfg = get_config("mamba2_780m")
    from repro_torch.models.model import model_param_specs
    specs = model_param_specs(cfg)["layers"][0]["ffn"]
    assert specs["w_up"].shape == (1536, 0)
    assert get_config("mamba2_780m").smoke().d_ff == 256


def _loss_against_reference(arch, **overrides):
    """The smoke config's float32 loss through both packages on one set of
    weights (``test_torch_train._init``) and one batch: (port, reference).
    A vision config gets seeded image embeddings."""
    from test_torch_train import _init
    jm = JModel(j_get_config(arch).smoke(dtype="float32", **overrides))
    jparams = _init(jm.param_specs())
    tm = LanguageModel(get_config(arch).smoke(dtype="float32", **overrides),
                       device="cpu")
    from_reference(tm, jax.tree_util.tree_map(np.asarray, jparams))
    cfg = tm.cfg
    rng = np.random.default_rng(5)
    shape = (2, 12) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    batch = {k: rng.integers(2, cfg.vocab_size, shape).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.cross_attn_every:
        batch["vision_embeds"] = rng.standard_normal(
            (2, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    want, _ = jax.jit(jm.loss)(jparams, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    with torch.no_grad():
        got, _ = tm.loss({k: torch.from_numpy(v) if v.dtype == np.float32
                          else torch.from_numpy(v).long()
                          for k, v in batch.items()})
    return float(got), float(want)


@pytest.mark.parametrize("arch,what", [
    ("deepseek_v3_671b", "MLA"),
    ("llama_3_2_vision_11b", "cross-attention"),
    ("musicgen_large", "audio")])
def test_unported_features_raise(arch, what):
    """The configs whose features were ported last (MLA, cross-attention,
    the audio frontend) build, with their features in the parameter tree
    as the reference's specs have them; training, ported since, gives
    the reference's loss (finite, within 1e-5; deepseek's with its MTP
    loss), and ``forward`` refuses ``mode="train"`` (training goes through
    ``loss``)."""
    cfg = get_config(arch).smoke()
    tm = LanguageModel(cfg, device="cpu")
    jm = JModel(j_get_config(arch).smoke())
    specs = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, jnp.dtype(s.dtype)), jm.param_specs(),
        is_leaf=lambda x: hasattr(x, "pspec"))
    from_reference(tm, specs)          # raises on any mismatch
    tree = tm.param_tree()
    if what == "MLA":
        assert {"wq_a", "wkv_a", "wk_b", "wv_b"} <= set(tree["layers"][0][
            "mixer"])
        assert "mtp" in tree
    elif what == "cross-attention":
        assert [i for i, blk in enumerate(tree["layers"])
                if "cross" in blk] == [4]
    else:
        assert tree["embed"].dim() == 3 and tree["lm_head"].dim() == 3
    with pytest.raises(ValueError, match="loss"):
        tm(torch.zeros(1, 4, dtype=torch.long), mode="train")
    got, want = _loss_against_reference(arch)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m",
                                  "jamba_1_5_large_398b"])
def test_moe_configs_build(arch):
    """The MoE configs build (MoE is ported); their MoE layers hold a
    router and experts in place of the dense FFN, as the reference's
    parameter specs do."""
    cfg = get_config(arch).smoke()
    tm = LanguageModel(cfg, device="cpu")
    jm = JModel(j_get_config(arch).smoke())
    specs = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, jnp.dtype(s.dtype)), jm.param_specs(),
        is_leaf=lambda x: hasattr(x, "pspec"))
    from_reference(tm, specs)          # raises on any mismatch
    tree = tm.param_tree()["layers"]
    for i in range(cfg.num_layers):
        assert ("moe" in tree[i]) == cfg.layer_is_moe(i)
        assert ("ffn" in tree[i]) != cfg.layer_is_moe(i)


def test_pad_heads_and_training_raise():
    """``pad_heads`` builds the padded layout (qwen3's smoke 4/2 heads:
    16 query slots over 16 KV heads); training, ported since, runs on it
    and gives the reference's padded-head loss (finite, within 1e-5), and
    so does the MTP loss (deepseek's ``mtp_loss`` term)."""
    cfg = get_config("qwen3_0_6b").smoke(pad_heads=True)
    m = LanguageModel(cfg, device="cpu")
    mixer = m.param_tree()["layers"][0]["mixer"]
    assert tuple(mixer["wq"].shape[1:]) == (16, 32)
    assert tuple(mixer["wk"].shape[1:]) == (2, 32)
    assert tuple(m.new_cache(1, 8)["layers"][0]["k"].shape) == (1, 16, 8, 32)
    got, want = _loss_against_reference("qwen3_0_6b", pad_heads=True)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    mtp = LanguageModel(get_config("deepseek_v3_671b").smoke(), device="cpu")
    tokens = torch.randint(2, mtp.cfg.vocab_size, (1, 8))
    with torch.no_grad():
        total, metrics = mtp.loss({"tokens": tokens, "labels": tokens})
    assert set(metrics) >= {"mtp_loss", "lb_loss", "z_loss", "ce_loss"}
    assert bool(torch.isfinite(total)) and float(metrics["mtp_loss"]) > 0


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_every_config_builds_and_serves_a_step(arch):
    """Every config the repo defines builds at smoke width on the CPU,
    holds the reference's parameter tree leaf for leaf, and runs a
    prefill and a decode step to finite logits."""
    cfg = get_config(arch).smoke(dtype="float32")
    tm = LanguageModel(cfg, device="cpu")
    jm = JModel(j_get_config(arch).smoke(dtype="float32"))
    specs = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, jnp.dtype(s.dtype)), jm.param_specs(),
        is_leaf=lambda x: hasattr(x, "pspec"))
    want = {p: a.shape for p, a in leaves(specs_unstacked(jm, specs))}
    got = {p: tuple(a.shape) for p, a in leaves(tm.param_tree())}
    assert got == want
    shape = (1, 6) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    tok = torch.full(shape, 3, dtype=torch.long)
    kw = ({"vision_embeds": torch.randn(1, cfg.num_image_tokens,
                                        cfg.d_model)}
          if cfg.cross_attn_every else {})
    cache = tm.new_cache(1, 8)
    logits, cache = tm(tok, cache=cache, **kw)
    logits, _ = tm.decode_step(cache, tok[:, :1], 6)
    assert bool(torch.isfinite(logits).all())


def specs_unstacked(jm, specs) -> dict:
    """The reference's spec tree with its stacked body laid out a layer
    at a time, as the port's ``layers``."""
    layers = list(specs["prefix"])
    for r in range(jm.n_repeats):
        for blk in specs["body"]:
            layers.append(jax.tree_util.tree_map(lambda a: a[r], blk))
    flat = {k: v for k, v in specs.items() if k not in ("prefix", "body")}
    flat["layers"] = layers
    return flat


def test_seed_gives_the_same_weights_and_bf16_carries_bit_for_bit():
    cfg = get_config("qwen3_0_6b").smoke()
    a = LanguageModel(cfg, seed=3, device="cpu")
    b = LanguageModel(cfg, seed=3, device="cpu")
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    jm = JModel(j_get_config("qwen3_0_6b").smoke())
    jp = j_init_params(jm.param_specs(), jax.random.PRNGKey(0))
    from_reference(a, jax.tree_util.tree_map(np.asarray, jp))
    want = np.asarray(jp["embed"]).view(np.uint16)
    assert a.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(a.embed.view(torch.int16).numpy().view(
        np.uint16), want)


def test_init_params_draws_large_leaves_in_seeded_pieces(monkeypatch):
    """A leaf's values depend on the seed, its index and its shape alone:
    a small leaf is one draw of its own generator, a large one (here
    above a lowered ``PIECE``) pieces of whole rows, each from its own;
    the same on every call (the pieces are drawn on a thread pool)."""
    from repro_torch.models import params as tp
    specs = {"big": tp.ParamSpec((10, 4, 3), "bfloat16", "scaled"),
             "small": tp.ParamSpec((5, 2), "float32", "normal")}
    monkeypatch.setattr(tp, "PIECE", 30)
    a = tp.init_params(specs, torch.Generator().manual_seed(7))
    b = tp.init_params(specs, torch.Generator().manual_seed(7))
    assert all(torch.equal(a[k], b[k]) for k in specs)
    g = torch.Generator().manual_seed(7 * 1_000_003 + 1)
    assert torch.equal(a["small"], torch.randn(5, 2, generator=g))
    leaf_seed = 7 * 1_000_003
    pieces = [torch.randn(2, 4, 3, generator=torch.Generator().manual_seed(
        leaf_seed * 65_537 + j + 1)) for j in range(5)]
    want = (torch.cat(pieces) * (1 / np.sqrt(4))).to(torch.bfloat16)
    assert torch.equal(a["big"], want)
