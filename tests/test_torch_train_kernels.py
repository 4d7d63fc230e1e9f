"""The backward passes of B4 and B5 against the reference, on the CPU.

The reference trains through ``jax.grad`` of its XLA oracles, not of its
Pallas kernels: ``blocked_attention`` (``repro/models/layers.py``) for B4
and the SSD einsums (``repro/kernels/ref.py`` ``ssd_chunk_ref``, the same
formula as ``ssd_chunked``'s intra-chunk block) for B5.  The port's plain
backward versions (``flash_attention_bwd_plain``,
``ssd_chunk_dual_bwd_plain``), which its autograd Functions run for CPU
tensors, must match ``jax.vjp`` of those on the same numpy inputs and
cotangents: every gradient within 1e-5 of its largest magnitude in
float32 (the same sums in another order), 2e-2 in bfloat16 (the
reference rounds q·scale, P and its cotangents to bf16 at other points).

Under strong decay (a chunk's cumulative log-decay spans more than 88)
the reference's SSD gradient is NaN: ``where(mask, exp(seg), 0)`` forms
``exp(cum_i - cum_j) = inf`` above the diagonal, and its vjp multiplies
that inf by a zero cotangent.  The port masks before the exponential: its
gradient must be finite and match a float64 evaluation, and the test
asserts the reference's NaN, so the fault stays documented (ROADMAP C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_chunk_ref
from repro.models.layers import blocked_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_chunk as sc

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _scaled_close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err} vs {tol} * {scale}"


def _to_jax(a: np.ndarray, dtype: str):
    return jnp.asarray(a, jnp.float32).astype(dtype)


def _to_torch(a: np.ndarray, dtype: str):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


#: (hd, hd_v), G, Sq, Sk: every pair of HEAD_DIMS, G in {1, 2, 3}, Sq != Sk
#: both ways, lengths that cut the reference's 32-row blocks
ATTN_CASES = [((32, 32), 2, 40, 40), ((64, 64), 3, 37, 50),
              ((128, 128), 1, 50, 37), ((48, 32), 2, 33, 21),
              ((192, 128), 1, 24, 40)]
#: each pair once in float32 and once in bfloat16, one of them causal
CASES = [(case, dtype, (i + j) % 2 == 0) for i, case in enumerate(ATTN_CASES)
         for j, dtype in enumerate(("float32", "bfloat16"))]


@pytest.mark.parametrize(
    "case,dtype,causal", CASES,
    ids=[f"hd{c[0][0]}-{c[0][1]}-G{c[1]}-{d}-{'causal' if k else 'full'}"
         for c, d, k in CASES])
def test_flash_attention_bwd_plain_matches_blocked_attention_vjp(
        case, dtype, causal):
    (hd, hd_v), G, Sq, Sk = case
    B, Hkv = 2, 2
    rng = np.random.default_rng(hd + G + Sq + Sk)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   [(B, Hkv * G, Sq, hd), (B, Hkv, Sk, hd),
                    (B, Hkv, Sk, hd_v), (B, Hkv * G, Sq, hd_v)])

    @jax.jit
    def ref(q, k, v, do):
        out, vjp = jax.vjp(lambda a, b, c: blocked_attention(
            a, b, c, causal=causal, block_q=32, block_k=32, unroll=True),
            q, k, v)
        return out, vjp(do)
    out, want = ref(*(_to_jax(a, dtype) for a in (q, k, v, do)))
    tq, tk, tv, tdo = (_to_torch(a, dtype) for a in (q, k, v, do))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      return_lse=True)
    _scaled_close(_f32(o), _f32(out), TOL[dtype], "out")
    got = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                       causal=causal)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == tq.dtype
        _scaled_close(_f32(a), _f32(b), TOL[dtype], f"d{name}")


def _ssd_inputs(rng, BN, c, H, P, N, decay):
    xb = rng.standard_normal((BN, c, H, P)).astype(np.float32)
    cum = np.cumsum(-np.abs(rng.standard_normal((BN, c, H))) * decay,
                    axis=1).astype(np.float32)
    Bm, Cm = (rng.standard_normal((BN, c, N)).astype(np.float32) * 0.5
              for _ in range(2))
    dy = rng.standard_normal((BN, c, H, P)).astype(np.float32)
    ds = rng.standard_normal((BN, H, N, P)).astype(np.float32)
    return xb, cum, Bm, Cm, dy, ds


@jax.jit
def _ref_vjp_jit(xb, cum, Bm, Cm, dy, ds):
    _, vjp = jax.vjp(ssd_chunk_ref, xb, cum, Bm, Cm)
    return vjp((dy, ds))


def _ref_vjp(*arrays):
    return [np.asarray(g) for g in _ref_vjp_jit(*map(jnp.asarray, arrays))]


@pytest.mark.parametrize("shape", [(3, 32, 4, 16, 16), (2, 45, 3, 8, 6)])
def test_ssd_bwd_plain_matches_ssd_chunk_ref_vjp(shape):
    """Weak decay (a chunk's span < 88), where the reference's gradient
    is finite: every gradient within 1e-5 of its largest magnitude."""
    rng = np.random.default_rng(sum(shape))
    xb, cum, Bm, Cm, dy, ds = _ssd_inputs(rng, *shape, decay=0.05)
    want = _ref_vjp(xb, cum, Bm, Cm, dy, ds)
    got = sc.ssd_chunk_dual_bwd_plain(*(torch.from_numpy(a) for a in
                                        (xb, cum, Bm, Cm, dy, ds)))
    for name, a, b in zip(("dxbar", "dcum", "dB", "dC"), got, want):
        _scaled_close(a.numpy(), b, 1e-5, name)


def test_ssd_bwd_is_finite_under_strong_decay_where_the_reference_is_nan():
    """A chunk of 32 at decay ~4 a step spans ~128 > 88: the reference's
    vjp holds NaN; the port's plain backward is finite and within 1e-4 of
    its float64 evaluation (float32 cum near 128 carries ~1e-5 into every
    exp(cum_i - cum_j))."""
    rng = np.random.default_rng(7)
    xb, cum, Bm, Cm, dy, ds = _ssd_inputs(rng, 2, 32, 3, 8, 6, decay=4.0)
    assert float(-cum[:, -1].min()) > 88
    ref = _ref_vjp(xb, cum, Bm, Cm, dy, ds)
    assert np.isnan(ref[1]).any()                   # the reference's fault
    args = [torch.from_numpy(a) for a in (xb, cum, Bm, Cm, dy, ds)]
    got = sc.ssd_chunk_dual_bwd_plain(*args)
    want = sc.ssd_chunk_dual_bwd_plain(*(a.double() for a in args))
    for name, a, b in zip(("dxbar", "dcum", "dB", "dC"), got, want):
        assert bool(torch.isfinite(a).all()), name
        _scaled_close(a.numpy(), b.numpy(), 1e-4, name)
    # and through autograd of the Function
    leaves = [a.clone().requires_grad_() for a in args[:4]]
    y, st = sc.ssd_chunk_dual(*leaves)
    grads = torch.autograd.grad((y, st), leaves, (args[4], args[5]))
    for a, b in zip(grads, got):
        assert torch.equal(a, b)


def test_flash_attention_function_passes_gradcheck():
    g = torch.Generator().manual_seed(0)
    for causal, (hq, hkv, sq, sk) in ((True, (2, 1, 5, 5)),
                                      (False, (3, 3, 4, 6))):
        q = torch.randn(1, hq, sq, 8, generator=g, dtype=torch.float64)
        k = torch.randn(1, hkv, sk, 8, generator=g, dtype=torch.float64)
        v = torch.randn(1, hkv, sk, 4, generator=g, dtype=torch.float64)
        args = [t.requires_grad_() for t in (q, k, v)]
        assert torch.autograd.gradcheck(
            lambda a, b, c, causal=causal: fa.FlashAttention.apply(
                a, b, c, causal, None), args)


def test_ssd_chunk_dual_function_passes_gradcheck():
    g = torch.Generator().manual_seed(1)
    BN, c, H, P, N = 2, 9, 2, 3, 4
    xb = torch.randn(BN, c, H, P, generator=g, dtype=torch.float64)
    cum = torch.cumsum(-torch.rand(BN, c, H, generator=g,
                                   dtype=torch.float64), 1)
    Bm = torch.randn(BN, c, N, generator=g, dtype=torch.float64)
    Cm = torch.randn(BN, c, N, generator=g, dtype=torch.float64)
    args = [t.requires_grad_() for t in (xb, cum, Bm, Cm)]
    assert torch.autograd.gradcheck(sc.SSDChunkDual.apply, args)
