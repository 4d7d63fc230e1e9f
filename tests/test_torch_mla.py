"""MLA (deepseek-v3's multi-head latent attention) and the padded GQA head
layout (``pad_heads``) of the port against the JAX reference, on the CPU.

Smoke-size ``deepseek_v3_671b`` (3 dense MLA layers and one MoE layer;
its MTP block carried but not run), and ``granite_moe_3b_a800m`` and
``qwen3_0_6b`` with ``pad_heads=True`` run with the reference's own
weights (``init_params(..., PRNGKey(0))``) carried across by
``from_reference``: a 40-token prefill and three decode steps at ragged
per-slot positions, then one lockstep step (a scalar position), must agree
in logits and in every updated cache leaf.  MLA's prefill runs B4's plain
version at q/k head dim ``nope + rope`` = 48 and v head dim 32; its
decode is the weight-absorbed product over the compressed cache.

Tolerance, float32: ``tests/test_torch_models.py``'s rule, rtol = 1e-4
and atol = 1e-4 of the largest magnitude of the compared tensor (the same
math in another summation order).  B4's plain version at MLA's head dims
is held to ``blocked_attention`` as ``tests/test_torch_lm_kernels.py``
holds it at GQA's: 2e-6 (float32) and 2e-2 (bfloat16).

``run_both`` is shared with ``tests/test_torch_multimodal.py``.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as jattn
from repro.models.layers import blocked_attention
from repro.models.model import LanguageModel as JModel
from repro.models.params import init_params as j_init_params
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn
from repro_torch.models.model import LanguageModel
from repro_torch.models.params import from_reference, leaves, to_tensor

B, S, STEPS = 2, 40, 3
DECODE_POS = np.array([S, S - 7])      # ragged: slot 1 rewinds 7 positions
TOL = 1e-4


def close(got, want, err_msg="", tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=tol, atol=tol * max(1.0, float(np.abs(want).max())),
        err_msg=err_msg)


def _rng(*key):
    return np.random.default_rng(zlib.crc32("-".join(map(str, key)).encode()))


def _tokens(cfg, shape, seed):
    if cfg.family == "audio":
        shape = (*shape, cfg.num_codebooks)
    return _rng("tokens", seed).integers(2, cfg.vocab_size, shape).astype(
        np.int32)


def _set_gates(tree, value: float):
    """The tree with every cross layer's ``gate`` at ``value`` (its init
    is zero: tanh(0) would close the cross path)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: (jnp.full_like(v, value)
                        if k == "gate" else walk(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node
    return walk(tree)


def _ref_layer_cache(jm, cache, i) -> dict:
    """Layer i's cache from the reference's prefix/stacked-body layout, as
    the port's flat dict of a layer (``cross`` keys prefixed)."""
    if i < jm.prefix_len:
        blk = cache["prefix"][i]
    else:
        r, j = divmod(i - jm.prefix_len, jm.period)
        blk = jax.tree_util.tree_map(lambda a: a[r], cache["body"][j])
    flat = {k: v for k, v in blk["self"].items() if k != "length"}
    flat.update({f"cross_{k}": v for k, v in blk.get("cross", {}).items()})
    return flat


def build_both(arch, *, dtype="float32", gate=None, **overrides):
    """The smoke config of ``arch`` in both packages on the reference's
    weights: (reference model, its params, port model)."""
    jcfg = dataclasses.replace(
        j_get_config(arch).smoke(dtype=dtype, **overrides), remat=False)
    tcfg = get_config(arch).smoke(dtype=dtype, **overrides)
    jm = JModel(jcfg)
    jparams = j_init_params(jm.param_specs(), jax.random.PRNGKey(0))
    if gate is not None:
        jparams = _set_gates(jparams, gate)
    tm = LanguageModel(tcfg, device="cpu")
    from_reference(tm, jax.tree_util.tree_map(np.asarray, jparams))
    return jm, jparams, tm


def run_both(arch, *, dtype="float32", gate=None, **overrides) -> dict:
    """A prefill with a cache, STEPS ragged decode steps and one lockstep
    step through both packages.  Returns ``logits`` (port, reference)
    numpy pairs, one a call, and ``caches`` (name, port, reference)
    after the last step."""
    jm, jparams, tm = build_both(arch, dtype=dtype, gate=gate, **overrides)
    cfg = tm.cfg
    max_len = S + 8
    prompt = _tokens(cfg, (B, S), 1)
    steps = _tokens(cfg, (STEPS + 1, B, 1), 2)
    jbatch, kw = {"tokens": jnp.asarray(prompt)}, {}
    if cfg.cross_attn_every:
        vis = (_rng("vision", arch).standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)) * 0.5)
        jbatch["vision_embeds"] = jnp.asarray(vis, jnp.dtype(dtype))
        kw["vision_embeds"] = to_tensor(np.asarray(jbatch["vision_embeds"]))
    jcache = j_init_params(jm.cache_specs(B, max_len), jax.random.PRNGKey(0))
    jl, jcache, _ = jm.forward(jparams, jbatch, mode="prefill", cache=jcache)
    tl, tcache = tm(torch.from_numpy(prompt).long(),
                    cache=tm.new_cache(B, max_len), **kw)
    logits = [(tl.float().numpy(), np.asarray(jl, np.float32))]
    decode = jax.jit(jm.decode_step)
    positions = [DECODE_POS + t for t in range(STEPS)] + [S + STEPS]
    for t, pos in enumerate(positions):
        jpos = jnp.asarray(pos, jnp.int32)
        tpos = torch.from_numpy(pos) if np.ndim(pos) else int(pos)
        jl, jcache = decode(jparams, jcache, jnp.asarray(steps[t]), jpos)
        tl, tcache = tm.decode_step(tcache, torch.from_numpy(steps[t]).long(),
                                    tpos)
        logits.append((tl.float().numpy(), np.asarray(jl, np.float32)))
    caches = []
    for i, layer in enumerate(tcache["layers"]):
        ref = _ref_layer_cache(jm, jcache, i)
        assert set(ref) == set(layer), (i, set(ref), set(layer))
        for key, leaf in layer.items():
            caches.append((f"layer{i}.{key}", leaf.float().numpy(),
                           np.asarray(ref[key], np.float32)))
    return {"logits": logits, "caches": caches, "cfg": cfg}


# ---------------------------------------------------------------------------
# B4's plain version at MLA's head dims
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,hd_v,Hq,Hkv", [(48, 32, 4, 4), (192, 128, 4, 2),
                                             (48, 32, 6, 2)])
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 2e-6),
                                       (jnp.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_at_mla_head_dims(hd, hd_v, Hq, Hkv, dtype,
                                                tol, causal):
    """v narrower than q/k (the reference's ``hdv != hd``), with MLA's own
    scale ``hd^-0.5`` passed explicitly as the reference passes it."""
    rng = _rng("mla-attn", hd, hd_v, Hq, causal, str(dtype))
    Sq = Sk = 72
    jq, jk, jv = (jnp.asarray(rng.standard_normal(s), dtype) for s in
                  [(1, Hq, Sq, hd), (1, Hkv, Sk, hd), (1, Hkv, Sk, hd_v)])
    q, k, v = (to_tensor(np.asarray(a)) for a in (jq, jk, jv))
    scale = hd ** -0.5
    got = tfa.flash_attention(q, k, v, causal=causal, scale=scale)
    assert got.shape == (1, Hq, Sq, hd_v) and got.dtype == q.dtype
    want = blocked_attention(jq, jk, jv, causal=causal, scale=scale,
                             block_q=32, block_k=32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(
        tfa.flash_attention(q, k, v, causal=causal), got, atol=0, rtol=0)


def test_flash_attention_takes_only_its_head_dim_pairs():
    pairs = set(tfa.HEAD_DIMS)
    assert {(192, 128), (48, 32), (128, 128), (64, 64)} <= pairs
    for arch in ARCHITECTURES:
        cfg = get_config(arch)
        if cfg.attention == "mla":
            for c in (cfg, cfg.smoke()):
                assert (c.resolved_head_dim, c.v_head_dim) in pairs
    q = torch.zeros(1, 2, 8, 48)
    with pytest.raises(ValueError, match="hd_v"):
        tfa.flash_attention(q, q, torch.zeros(1, 2, 9, 32))


# ---------------------------------------------------------------------------
# deepseek_v3_671b: MLA prefill, absorbed decode, MTP carried
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deepseek():
    return run_both("deepseek_v3_671b")


def test_mla_prefill_logits_match_reference(deepseek):
    got, want = deepseek["logits"][0]
    assert got.shape == (B, S, deepseek["cfg"].vocab_size)
    close(got, want)


@pytest.mark.parametrize("step", range(STEPS + 1))
def test_mla_decode_logits_match_reference(deepseek, step):
    """Three ragged steps (a [B] position) and one lockstep step (an
    int)."""
    got, want = deepseek["logits"][1 + step]
    assert got.shape == (B, 1, deepseek["cfg"].vocab_size)
    close(got, want)


def test_mla_caches_match_reference(deepseek):
    keys = {name.split(".")[1] for name, _, _ in deepseek["caches"]}
    assert keys == {"c_kv", "k_rope"}
    for name, got, want in deepseek["caches"]:
        close(got, want, err_msg=name)


def test_absorbed_decode_agrees_with_the_expanded_prefill():
    """Decode step t's logits (absorbed, over the compressed cache) equal
    a prefill's last-position logits over the same t + 1 tokens (the
    latents expanded, B4): two forms of one function.  The MoE layer's
    capacity factor is E / K, so that no prefill drops an assignment (a
    decode step of one token never does)."""
    cfg = get_config("deepseek_v3_671b").smoke(dtype="float32")
    cfg = dataclasses.replace(cfg, moe_capacity_factor=(
        cfg.num_experts / cfg.experts_per_token))
    tm = LanguageModel(cfg, seed=4, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (1, 24), 9)).long()
    cache = tm.new_cache(1, 32)
    tm(toks[:, :20], cache=cache)
    for t in range(20, 24):
        got, _ = tm.decode_step(cache, toks[:, t:t + 1], t)
        want, _ = tm(toks[:, :t + 1])
        close(got[:, 0].numpy(), want[:, -1].numpy(), err_msg=f"t={t}")


def test_mtp_block_is_carried_from_the_reference():
    jm, jparams, tm = build_both("deepseek_v3_671b")
    tree = tm.param_tree()["mtp"]
    assert set(tree) == {"norm_h", "norm_e", "proj", "block"}
    assert "moe" in tree["block"] and "mixer" in tree["block"]
    np.testing.assert_array_equal(
        tree["proj"].float().numpy(),
        np.asarray(jparams["mtp"]["proj"], np.float32))
    np.testing.assert_array_equal(
        tree["block"]["moe"]["router"].numpy(),
        np.asarray(jparams["mtp"]["block"]["moe"]["router"]))


def test_deepseek_param_count_equals_reference():
    assert (get_config("deepseek_v3_671b").num_params()
            == j_get_config("deepseek_v3_671b").num_params())


# ---------------------------------------------------------------------------
# pad_heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_head_layout_equals_reference(arch):
    for cfg, jcfg in ((get_config(arch), j_get_config(arch)),
                      (get_config(arch).smoke(), j_get_config(arch).smoke())):
        cfg = dataclasses.replace(cfg, pad_heads=True)
        jcfg = dataclasses.replace(jcfg, pad_heads=True)
        lay = tattn.head_layout(cfg)
        assert lay == jattn.head_layout(jcfg)
        if lay is not None:
            assert tattn.q_head_map(cfg) == jattn.q_head_map(jcfg)


@pytest.fixture(scope="module", params=["granite_moe_3b_a800m",
                                        "qwen3_0_6b"])
def padded(request):
    """granite: 24/8 heads -> 32 query slots over 16 KV heads; qwen3's
    smoke 4/2 heads -> 16 slots over 16 (G = 2 over r = 8: half pads)."""
    return request.param, run_both(request.param, pad_heads=True)


def test_pad_heads_logits_match_reference(padded):
    arch, run = padded
    assert tattn.head_layout(run["cfg"]) is not None
    for i, (got, want) in enumerate(run["logits"]):
        close(got, want, err_msg=f"{arch} call {i}")


def test_pad_heads_caches_match_reference(padded):
    arch, run = padded
    hkv_p = tattn.head_layout(run["cfg"])[1]
    for name, got, want in run["caches"]:
        if name.endswith((".k", ".v")):
            assert got.shape[1] == hkv_p, name
        close(got, want, err_msg=f"{arch} {name}")


def test_pad_heads_computes_the_unpadded_function():
    """Weight surgery (``tests/test_head_padding.py``'s): the padded
    model's real query slots, moved to the canonical order, make the
    unpadded model, which gives the same logits."""
    cfg0 = dataclasses.replace(
        get_config("granite_moe_3b_a800m").smoke(), num_heads=24,
        num_kv_heads=8, head_dim=16, dtype="float32",
        moe_balance="sorted_block")
    cfg1 = dataclasses.replace(cfg0, pad_heads=True)
    m0 = LanguageModel(cfg0, device="cpu")
    m1 = LanguageModel(cfg1, seed=1, device="cpu")
    qmap = tattn.q_head_map(cfg1)
    sel = [i for i, h in enumerate(qmap) if h >= 0]
    idx = torch.tensor(np.array(sel)[np.argsort([qmap[i] for i in sel])])
    unpadded = dict(leaves(m0.param_tree()))
    with torch.no_grad():
        for path, param in leaves(m1.param_tree()):
            if path.endswith("mixer.wq"):
                param = param.index_select(1, idx)
            elif path.endswith("mixer.wo"):
                param = param.index_select(0, idx)
            unpadded[path].copy_(param)
    tok = torch.from_numpy(_tokens(cfg0, (2, 16), 5)).long()
    close(m1(tok)[0].numpy(), m0(tok)[0].numpy(), tol=5e-4)
