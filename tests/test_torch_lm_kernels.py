"""The port's LM kernels (B4 flash attention, B5 SSD chunk) against the JAX
reference, on the CPU.

Here the wrappers run their plain PyTorch versions (the CUDA kernels run
only on the card, where ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold each against its plain version).  Inputs are made with numpy from a
seed and handed to both packages; the reference's Pallas kernels run in
interpret mode, as ``tests/test_kernels.py`` runs them.  Tolerances are
``tests/test_kernels.py``'s: B4 2e-6 (f32) and 2e-2 (bf16), B5 1e-5 (f32)
and 5e-2 (bf16), the chunked scan 1e-4.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ssd_chunk import ssd_chunk_dual as jax_ssd_chunk
from repro.models.layers import blocked_attention
from repro.models.mamba import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_chunk as tsc
from repro_torch.models.mamba import ssd_chunked
from repro_torch.models.params import to_tensor

ATTN_SHAPES = [
    # B, Hq, Hkv, Sq, Sk, hd (tests/test_kernels.py:199)
    (1, 1, 1, 128, 128, 64),
    (2, 4, 2, 256, 256, 64),
    (1, 8, 2, 128, 512, 128),   # GQA 4:1, long K
    (2, 6, 3, 384, 384, 32),
]
DTYPES = {"float32": (jnp.float32, 2e-6), "bfloat16": (jnp.bfloat16, 2e-2)}


def _rng(*key):
    return np.random.default_rng(zlib.crc32("-".join(map(str, key)).encode()))


def _both(a, jdtype):
    """One numpy array as a JAX array of ``jdtype`` and the same values as
    a torch tensor (bf16 carried bit for bit)."""
    j = jnp.asarray(a, jdtype)
    return j, to_tensor(np.asarray(j))


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_reference(shape, dtype, causal):
    B, Hq, Hkv, Sq, Sk, hd = shape
    jdt, tol = DTYPES[dtype]
    rng = _rng("attn", shape, dtype, causal)
    (jq, q), (jk, k), (jv, v) = (_both(rng.standard_normal(s), jdt) for s in
                                 [(B, Hq, Sq, hd), (B, Hkv, Sk, hd),
                                  (B, Hkv, Sk, hd)])
    got = tfa.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jax_flash(jq, jk, jv, causal=causal, interpret=True), tol)
    _close(got, jax_ref.attention_ref(jq, jk, jv, causal=causal), tol)
    _close(tops.attention(q, k, v, causal=causal),
           jax_ref.attention_ref(jq, jk, jv, causal=causal), tol)
    _close(tref.attention_ref(q, k, v, causal=causal),
           jax_ref.attention_ref(jq, jk, jv, causal=causal), tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_ragged_matches_blocked_attention(causal):
    """Sq = Sk = 200 (no block multiple): the port needs no padding."""
    rng = _rng("ragged", causal)
    (jq, q), (jk, k), (jv, v) = (_both(rng.standard_normal(s), jnp.float32)
                                 for s in [(1, 4, 200, 64), (1, 2, 200, 64),
                                           (1, 2, 200, 64)])
    got = tops.attention(q, k, v, causal=causal)
    _close(got, blocked_attention(jq, jk, jv, causal=causal, block_q=64,
                                  block_k=64), 1e-5)
    _close(got, jax_ref.attention_ref(jq, jk, jv, causal=causal), 1e-5)


def test_flash_attention_scale_rounds_in_the_dtype():
    """q·hd^-0.5 is taken in q's dtype, with the scale rounded to it first,
    as JAX does with a Python float."""
    assert tfa.scale_for(128, torch.float32) == np.float32(128 ** -0.5)
    assert tfa.scale_for(128, torch.bfloat16) == 0.08837890625
    assert tfa.scale_for(64, torch.bfloat16) == 0.125


def test_flash_attention_rejects_bad_shapes():
    q = torch.zeros(1, 3, 8, 32)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, torch.zeros(1, 2, 8, 32), torch.zeros(
            1, 2, 8, 32))
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, torch.zeros(1, 3, 9, 32))
    with pytest.raises(ValueError):
        tfa.flash_attention(q[0], q[0], q[0])


SSD_CASES = [(1, 32, 1, 16, 8), (3, 64, 4, 32, 16), (2, 128, 2, 64, 128)]


def _ssd_inputs(rng, bn, c, h, p, n, jdt):
    xb = _both(rng.standard_normal((bn, c, h, p)) * 0.1, jdt)
    la = -np.abs(rng.standard_normal((bn, c, h))) * 0.05
    cum = _both(np.cumsum(la.astype(np.float32), axis=1), jnp.float32)
    Bm = _both(rng.standard_normal((bn, c, n)) * 0.3, jdt)
    Cm = _both(rng.standard_normal((bn, c, n)) * 0.3, jdt)
    return xb, cum, Bm, Cm


@pytest.mark.parametrize("case", SSD_CASES + [(2, 200, 3, 64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_plain_matches_reference(case, dtype):
    jdt = DTYPES[dtype][0]
    tol = 1e-5 if dtype == "float32" else 5e-2
    (jx, x), (jc, c), (jb, b), (jC, C) = _ssd_inputs(
        _rng("ssd", case, dtype), *case, jdt)
    y, st = tsc.ssd_chunk_dual(x, c, b, C)
    assert y.dtype == st.dtype == torch.float32
    bn, cl, h, p, n = case
    assert y.shape == (bn, cl, h, p) and st.shape == (bn, h, n, p)
    for want in (jax_ssd_chunk(jx, jc, jb, jC, interpret=True),
                 jax_ref.ssd_chunk_ref(jx, jc, jb, jC)):
        _close(y, want[0], tol)
        _close(st, want[1], tol)
    y2, st2 = tops.ssd_chunk(x, c, b, C)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    y3, st3 = tref.ssd_chunk_ref(x, c, b, C)
    assert torch.equal(y, y3) and torch.equal(st, st3)


@pytest.mark.parametrize("S,chunk", [(80, 32), (64, 64), (20, 32)])
def test_ssd_chunked_matches_reference(S, chunk):
    """Several chunks with a ragged tail (80 = 2·32 + 16), one exact
    chunk, and a prompt shorter than a chunk (c = S)."""
    rng = _rng("chunked", S, chunk)
    B, H, P, N = 2, 3, 16, 8
    xb = _both(rng.standard_normal((B, S, H, P)) * 0.1, jnp.float32)
    la = _both(-np.abs(rng.standard_normal((B, S, H))) * 0.05, jnp.float32)
    Bm = _both(rng.standard_normal((B, S, N)) * 0.3, jnp.float32)
    Cm = _both(rng.standard_normal((B, S, N)) * 0.3, jnp.float32)
    init = _both(rng.standard_normal((B, H, N, P)) * 0.1, jnp.float32)
    for start in (None, init):
        y_j, s_j = jax_ssd_chunked(xb[0], la[0], Bm[0], Cm[0], chunk,
                                   initial_state=None if start is None
                                   else start[0])
        y_t, s_t = ssd_chunked(xb[1], la[1], Bm[1], Cm[1], chunk,
                               initial_state=None if start is None
                               else start[1])
        _close(y_t, y_j, 1e-4)
        _close(s_t, s_j, 1e-4)


def test_check_aligned_rejects_views_off_a_16_byte_boundary():
    """The bf16 kernels copy rows in 16-byte pieces; their wrappers hold
    a tensor to a 16-byte start before they launch."""
    from repro_torch.kernels._build import check_aligned
    base = torch.zeros(64, dtype=torch.bfloat16)
    check_aligned(a=base, b=base[8:])
    with pytest.raises(ValueError, match="b must start on a 16-byte"):
        check_aligned(a=base, b=base[1:])
