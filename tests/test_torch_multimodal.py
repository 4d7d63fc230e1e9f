"""Cross-attention and the vision and audio frontends of the port against
the JAX reference, on the CPU.

Smoke-size ``llama_3_2_vision_11b`` (four self-attention layers and one
gated cross-attention layer over 16 stub image embeddings) and
``musicgen_large`` (tokens ``[B,S,4]`` embedded as the sum of four
codebooks, logits ``[B,S,4,V]``) run with the reference's own weights
carried across by ``from_reference``, through ``tests/test_torch_mla.py``'s
``run_both``: a 40-token prefill, three ragged decode steps and one
lockstep step, in logits and every updated cache leaf (the cross layer's
image K/V included).  Every cross layer's ``gate`` is set to 0.5 on both
sides: at init it is zero, and ``tanh(0) = 0`` would hide the whole cross
path.  Cross-attention's prefill runs B4's plain version non-causal over
``Sk = 16`` image tokens for ``Sq = 40`` text tokens.

Tolerance, float32: 1e-3 of the largest magnitude (rtol 1e-3), as
``tests/test_torch_moe.py`` holds its models that have no qk-norm, and for
the same reason: the reference's init scales ``wq``/``wk`` by
1/sqrt(heads), so with no qk-norm the attention logits reach ~100 and
float32 alone cannot pin the answer tighter.  Measured against the
reference run in float64 on the same weights, inputs and prompt: the
reference's own float32 logits are 2.0e-4 (audio) and 3.8e-4 (vision) of
the largest logit away from it, the port's 3.2e-4 and 5.7e-4, and the two
packages 4.0e-4 and 3.8e-4 from each other.  (deepseek's MLA norms its
latents: there the three agree within 2e-5, and ``tests/test_torch_mla.py``
holds it to 1e-4.)
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import LanguageModel
from repro_torch.runtime.serve import ServeLoop
from test_torch_mla import B, S, STEPS, close, run_both

#: float32, conditioning-bound (above)
TOL = 1e-3


@pytest.fixture(scope="module")
def vision():
    return run_both("llama_3_2_vision_11b", gate=0.5)


@pytest.fixture(scope="module")
def audio():
    return run_both("musicgen_large")


def test_vision_prefill_logits_match_reference(vision):
    got, want = vision["logits"][0]
    assert got.shape == (B, S, vision["cfg"].vocab_size)
    close(got, want, tol=TOL)


@pytest.mark.parametrize("step", range(STEPS + 1))
def test_vision_decode_logits_match_reference(vision, step):
    got, want = vision["logits"][1 + step]
    close(got, want, tol=TOL)


def test_vision_caches_match_reference(vision):
    cfg = vision["cfg"]
    names = {name for name, _, _ in vision["caches"]}
    cross = [i for i in range(cfg.num_layers) if cfg.layer_is_cross_attn(i)]
    assert cross == [4]
    assert {f"layer4.cross_{k}" for k in "kv"} <= names
    for name, got, want in vision["caches"]:
        if "cross" in name:
            assert got.shape == (B, cfg.num_kv_heads, cfg.num_image_tokens,
                                 cfg.resolved_head_dim), name
        close(got, want, err_msg=name, tol=TOL)


def test_vision_gate_opens_the_cross_path():
    """With the init gate (zero) the cross layer adds exact zeros: the
    logits do not depend on the image; with a gate of 0.5 they do."""
    cfg = get_config("llama_3_2_vision_11b").smoke(dtype="float32")
    tm = LanguageModel(cfg, device="cpu")
    g = torch.Generator().manual_seed(2)
    tok = torch.randint(2, cfg.vocab_size, (1, 12), generator=g)
    vis = [torch.randn(1, cfg.num_image_tokens, cfg.d_model, generator=g)
           for _ in range(2)]
    a, b = (tm(tok, vision_embeds=v)[0] for v in vis)
    assert torch.equal(a, b)
    with torch.no_grad():
        tm.layers[4]["cross"]["gate"].fill_(0.5)
    a, b = (tm(tok, vision_embeds=v)[0] for v in vis)
    assert not torch.allclose(a, b)


def test_vision_prefill_needs_the_embeddings():
    cfg = get_config("llama_3_2_vision_11b").smoke()
    tm = LanguageModel(cfg, device="cpu")
    with pytest.raises(ValueError, match="vision_embeds"):
        tm(torch.zeros(1, 4, dtype=torch.long))


def test_audio_prefill_logits_match_reference(audio):
    got, want = audio["logits"][0]
    cfg = audio["cfg"]
    assert got.shape == (B, S, cfg.num_codebooks, cfg.vocab_size)
    close(got, want, tol=TOL)


@pytest.mark.parametrize("step", range(STEPS + 1))
def test_audio_decode_logits_match_reference(audio, step):
    got, want = audio["logits"][1 + step]
    cfg = audio["cfg"]
    assert got.shape == (B, 1, cfg.num_codebooks, cfg.vocab_size)
    close(got, want, tol=TOL)


def test_audio_caches_match_reference(audio):
    for name, got, want in audio["caches"]:
        close(got, want, err_msg=name, tol=TOL)


def test_audio_embeds_the_sum_of_its_codebooks():
    cfg = get_config("musicgen_large").smoke(dtype="float32")
    tm = LanguageModel(cfg, device="cpu")
    assert tuple(tm.embed.shape) == (cfg.num_codebooks, cfg.vocab_size,
                                     cfg.d_model)
    assert tuple(tm.lm_head.shape) == (cfg.num_codebooks, cfg.d_model,
                                       cfg.vocab_size)
    tok = torch.tensor([[[3, 5, 7, 9]]])
    want = sum(tm.embed[k, tok[0, 0, k]] for k in range(4))
    torch.testing.assert_close(tm.embed_tokens(tok)[0, 0], want, atol=0,
                               rtol=0)


@pytest.mark.parametrize("arch,reason", [
    ("llama_3_2_vision_11b", "vision_embeds"),
    ("musicgen_large", "codebook")])
def test_serve_loop_refuses_vision_and_audio(arch, reason):
    """The reference's loop takes these configs and fails inside them; the
    port's refuses them up front, naming why."""
    tm = LanguageModel(get_config(arch).smoke(), device="cpu")
    with pytest.raises(ValueError, match=reason):
        ServeLoop(tm, num_slots=2, max_len=16, device="cpu")


def test_lockstep_prefill_and_decode_drive_vision_and_audio():
    """A batch prefill and lockstep decode, as the reference's
    ``build_prefill_step``/``build_serve_step`` drive the families the
    loop refuses: finite logits of the right shapes, and greedy tokens
    inside the vocabulary."""
    for arch in ("llama_3_2_vision_11b", "musicgen_large"):
        cfg = get_config(arch).smoke()
        tm = LanguageModel(cfg, device="cpu")
        shape = (2, 10) + ((cfg.num_codebooks,) if cfg.num_codebooks
                           else ())
        tok = torch.from_numpy(np.random.default_rng(1).integers(
            2, cfg.vocab_size, shape))
        kw = ({"vision_embeds": torch.randn(2, cfg.num_image_tokens,
                                            cfg.d_model)}
              if cfg.cross_attn_every else {})
        cache = tm.new_cache(2, 16)
        logits, cache = tm(tok, cache=cache, **kw)
        for t in range(10, 13):
            nxt = logits[:, -1:].argmax(-1)
            logits, cache = tm.decode_step(cache, nxt, t)
            assert bool(torch.isfinite(logits.float()).all())
            assert int(nxt.max()) < cfg.vocab_size
        assert logits.shape[:2] == (2, 1)
