"""B4: GQA flash attention forward.

``q [B,Hq,Sq,hd]``, ``k [B,Hkv,Sk,hd]``, ``v [B,Hkv,Sk,hd_v]`` with
``Hq = G·Hkv`` -> ``[B,Hq,Sq,hd_v]`` in q's dtype: softmax attention with
logits in float32, causal (top-left: query ``i`` sees keys ``j <= i``) or
not.  V may be narrower than Q and K: MLA's prefill attends with q/k
head dim ``nope + rope = 192`` and v head dim 128 (the reference's
``blocked_attention`` takes ``hdv != hd``).

:func:`flash_attention` launches the CUDA kernel ``repro_flash_attention``
(``csrc/flash_attention.cu``) for CUDA tensors and runs
:func:`flash_attention_plain` for CPU tensors.  The kernel is chosen by
dtype: bfloat16 runs on the tensor cores (bf16 products, f32 sums),
float32 on the CUDA cores in f32.  Both keep the rounding
points of the reference kernel (``repro/kernels/flash_attention.py``):
``q * scale`` in q's dtype (``scale = hd^-0.5`` unless given, rounded to
q's dtype first), logits accumulated in float32, masked logits
at ``-1e30``, P rounded to V's dtype before the PV product, and
``acc / max(l, 1e-30)`` rounded to q's dtype.  Unlike the reference's
``ops.attention`` no padding is needed: ragged ``Sq``/``Sk`` are masked in
the kernel.

Training differentiates through :class:`FlashAttention`, which
:func:`flash_attention` takes when an input requires a gradient.  Its
forward launches the same kernel with the optional ``lse [B,Hq,Sq]``
output (``m + log l`` of every row, float32; serving passes none and the
kernel skips the store), and its backward is FlashAttention-2's:
``D = rowsum(dO ∘ O)``, P recomputed as ``exp(s - lse)`` under the same
mask, ``dS = P ∘ (dP - D)``, ``dV = Pᵀ dO`` (P rounded to V's dtype, as
the forward's PV product takes it), ``dK = dSᵀ (q·scale)`` and ``dQ =
scale · dS K``.  :func:`flash_attention_bwd` launches
``repro_flash_attention_bwd`` for CUDA tensors (a D kernel, a dK/dV kernel
with one block per (batch, KV head, key tile) that walks its G query heads
and their query tiles, so no float atomics, and a dQ kernel; chosen by
dtype as the forward is: bfloat16 on the tensor cores, with P and dS
rounded to bf16 where they enter their products and the dQ block over
the forward's 64 packed rows of a KV head, float32 in f32 on the CUDA
cores with a dQ block per (batch, query head, query tile)) and
:func:`flash_attention_bwd_plain`, the same formulas on whole tensors,
for CPU tensors.  The reference has no backward kernel: it
trains through ``jax.grad`` of ``blocked_attention``, the XLA oracle of
its forward.

Meta tensors (the dry run's abstract step) take neither: the forward
and the backward return empty outputs of the kernel's shapes and dtypes
and add the call's closed-form bytes and FLOPs
(:func:`repro_torch.kernels.cost.attention_call_cost`, which skips the
causal half the kernel skips) to the active
:func:`~repro_torch.kernels.cost.count_kernels` counter.  They add
nothing to ``LAUNCHES``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import (DTYPE_CODES, LAUNCHES, check_aligned,
                                        check_dense)
from repro_torch.kernels.cost import attention_call_cost, record_meta_call

NEG_INF = -1e30
#: the kernel's (q/k head dim, v head dim) pairs: GQA's, MLA's prefill
#: (192, 128) and MLA at the configs' smoke width (48, 32)
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (48, 32), (192, 128))


def _shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, hd = q.shape
    Hkv, Sk, hd_v = k.shape[1], k.shape[2], v.shape[3]
    if (tuple(k.shape) != (B, Hkv, Sk, hd)
            or tuple(v.shape) != (B, Hkv, Sk, hd_v)
            or Hkv < 1 or Hq % Hkv or Sq < 1 or Sk < 1):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not [B,Hq,Sq,hd], "
                         f"[B,Hkv,Sk,hd] and [B,Hkv,Sk,hd_v] with Hq a "
                         f"multiple of Hkv")
    return B, Hq, Hkv, Sq, Sk, hd, hd_v


def scale_for(hd: int, dtype: torch.dtype, scale=None) -> float:
    """``scale`` (default ``hd^-0.5``) as q's dtype holds it: the
    reference multiplies q by a Python float, which JAX first converts to
    q's dtype."""
    return float(torch.tensor(hd ** -0.5 if scale is None else scale,
                              dtype=dtype))


def _keep(Sq: int, Sk: int, device) -> torch.Tensor:
    """The causal mask, top-left: query ``i`` sees keys ``j <= i``."""
    return (torch.arange(Sq, device=device)[:, None]
            >= torch.arange(Sk, device=device)[None, :])


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions' sums: float32, or float64 for float64 inputs
    (gradient checks)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _scaled_logits(q, k, causal: bool, scale):
    """``(q·scale rounded to q's dtype, as float32 [B,Hkv,G,Sq,hd], the
    masked float32 logits [B,Hkv,G,Sq,Sk])``."""
    acc = _acc_dtype(q)
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    qs = (q.to(acc) * scale_for(hd, q.dtype, scale)).to(q.dtype)
    qg = qs.reshape(B, Hkv, Hq // Hkv, Sq, hd).to(acc)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(acc))
    if causal:
        s = s.masked_fill(~_keep(Sq, Sk, q.device), NEG_INF)
    return qg, s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, scale=None,
                          return_lse: bool = False):
    """The plain version: the whole ``[Sq, Sk]`` softmax at once, with the
    reference kernel's rounding points.  With ``return_lse`` it returns
    ``(out, lse [B,Hq,Sq] float32)`` as the kernel's training launch
    does."""
    B, Hq, Hkv, Sq, Sk, hd, hd_v = _shapes(q, k, v)
    _, s = _scaled_logits(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).to(s.dtype),
                      v.to(s.dtype))
    l = p.sum(-1)
    out = (pv / l.clamp_min(1e-30)[..., None]).reshape(
        B, Hq, Sq, hd_v).to(q.dtype)
    if not return_lse:
        return out
    return out, (m[..., 0] + torch.log(l)).reshape(B, Hq, Sq)


def flash_attention_bwd_plain(q, k, v, o, lse, dout, *, causal: bool = True,
                              scale=None):
    """The backward pass as explicit formulas on whole tensors: P from the
    forward's ``lse``, ``D = rowsum(dO ∘ O)``, ``dS = P ∘ (dP - D)``;
    ``dV = Pᵀ dO`` with P rounded to V's dtype, ``dK = dSᵀ (q·scale)``,
    ``dQ = scale · dS K``.  Returns ``(dq, dk, dv)`` in the inputs'
    dtypes; sums in float32."""
    acc = _acc_dtype(q)
    B, Hq, Hkv, Sq, Sk, hd, hd_v = _shapes(q, k, v)
    G = Hq // Hkv
    qg, s = _scaled_logits(q, k, causal, scale)
    p = torch.exp(s - lse.reshape(B, Hkv, G, Sq, 1).to(acc))
    if causal:
        p = p.masked_fill(~_keep(Sq, Sk, q.device), 0.0)
    do = dout.reshape(B, Hkv, G, Sq, hd_v).to(acc)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p.to(v.dtype).to(acc), do)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", do, v.to(acc))
    D = (do * o.reshape(B, Hkv, G, Sq, hd_v).to(acc)).sum(-1,
                                                          keepdim=True)
    ds = p * (dp - D)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.to(acc)) \
        * scale_for(hd, q.dtype, scale)
    return (dq.reshape(B, Hq, Sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check_kernel_args(q, k, v, name: str):
    B, Hq, Hkv, Sq, Sk, hd, hd_v = _shapes(q, k, v)
    dev, dtype = q.device, q.dtype
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {dtype}")
    if (hd, hd_v) not in HEAD_DIMS:
        raise ValueError(f"{name}'s kernel takes (head_dim, v head_dim) in "
                         f"{HEAD_DIMS}, got {(hd, hd_v)}")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"batch {B} or heads {Hq} exceed the grid")
    check_dense("q", q, dev, dtype, (B, Hq, Sq, hd))
    check_dense("k", k, dev, dtype, (B, Hkv, Sk, hd))
    check_dense("v", v, dev, dtype, (B, Hkv, Sk, hd_v))
    return B, Hq, Hkv, Sq, Sk, hd, hd_v


def _flash_attention_cuda(q, k, v, causal: bool, scale,
                          with_lse: bool = False):
    B, Hq, Hkv, Sq, Sk, hd, hd_v = _check_kernel_args(q, k, v,
                                                      "flash_attention")
    dev, dtype = q.device, q.dtype
    if dtype == torch.bfloat16:
        check_aligned(q=q, k=k, v=v)
    out = q.new_empty(B, Hq, Sq, hd_v)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    with torch.cuda.device(dev):
        _build.check("flash_attention", _build.lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Hq, Hkv, Sq, Sk, hd,
            hd_v, int(causal), DTYPE_CODES[dtype],
            scale_for(hd, dtype, scale), _build.stream_of(dev)))
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if with_lse else out


def _flash_attention_meta(q, k, v, causal: bool, with_lse: bool = False):
    """The meta branch of the forward: the kernel's outputs, empty, and
    its closed-form cost recorded."""
    B, Hq, Hkv, Sq, Sk, hd, hd_v = _shapes(q, k, v)
    record_meta_call("flash_attention", *attention_call_cost(
        B, Hq, Hkv, Sq, Sk, hd, hd_v, causal, q.dtype))
    out = torch.empty((B, Hq, Sq, hd_v), dtype=q.dtype, device=q.device)
    if not with_lse:
        return out
    return out, torch.empty((B, Hq, Sq), dtype=torch.float32,
                            device=q.device)


def _flash_attention_bwd_meta(q, k, v, causal: bool):
    """The meta branch of the backward: empty ``(dq, dk, dv)`` and the
    closed-form cost recorded."""
    B, Hq, Hkv, Sq, Sk, hd, hd_v = _shapes(q, k, v)
    record_meta_call("flash_attention_bwd", *attention_call_cost(
        B, Hq, Hkv, Sq, Sk, hd, hd_v, causal, q.dtype, backward=True))
    return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in (q, k, v))


def _flash_attention_bwd_cuda(q, k, v, o, lse, dout, causal: bool, scale):
    B, Hq, Hkv, Sq, Sk, hd, hd_v = _check_kernel_args(
        q, k, v, "flash_attention_bwd")
    dev, dtype = q.device, q.dtype
    check_dense("o", o, dev, dtype, (B, Hq, Sq, hd_v))
    check_dense("dout", dout, dev, dtype, (B, Hq, Sq, hd_v))
    check_dense("lse", lse, dev, torch.float32, (B, Hq, Sq))
    if dtype == torch.bfloat16:
        check_aligned(q=q, k=k, v=v, dout=dout)
        # the tensor-core kernels' grids take the 64-row tiles as their z
        if max(-(-Sk // 64), -(-(Hq // Hkv) * Sq // 64)) > 65535:
            raise ValueError(f"the bf16 backward takes at most 65535 tiles "
                             f"of 64 keys and of 64 packed query rows "
                             f"(G·Sq), got Sk {Sk} and G·Sq "
                             f"{(Hq // Hkv) * Sq}")
    D = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.cuda.device(dev):
        _build.check("flash_attention_bwd",
                     _build.lib().repro_flash_attention_bwd(
                         q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                         D.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                         dv.data_ptr(), B, Hq, Hkv, Sq, Sk, hd, hd_v,
                         int(causal), DTYPE_CODES[dtype],
                         scale_for(hd, dtype, scale),
                         _build.stream_of(dev)))
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, dout, *, causal: bool = True,
                        scale=None):
    """``(dq, dk, dv)`` of :func:`flash_attention` at cotangent ``dout``,
    from the forward's output ``o`` and ``lse``, on the tensors' device:
    the CUDA kernels for CUDA tensors (the forward kernel's head-dim pairs
    and dtypes; anything else raises), the plain version for CPU
    tensors."""
    if q.device.type == "cuda":
        return _flash_attention_bwd_cuda(q, k, v, o, lse, dout, causal,
                                         scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, dout,
                                         causal=causal, scale=scale)
    if q.device.type == "meta":
        return _flash_attention_bwd_meta(q, k, v, causal)
    raise ValueError(f"no flash_attention_bwd for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with a gradient: the forward keeps its
    ``lse``, the backward is :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale):
        if q.device.type == "cuda":
            out, lse = _flash_attention_cuda(q, k, v, causal, scale,
                                             with_lse=True)
        elif q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, causal=causal,
                                             scale=scale, return_lse=True)
        elif q.device.type == "meta":
            out, lse = _flash_attention_meta(q, k, v, causal, with_lse=True)
        else:
            raise ValueError(f"no flash_attention for device {q.device}")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(),
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale=None) -> torch.Tensor:
    """GQA attention, on the tensors' device: the CUDA kernel for CUDA
    tensors (``(hd, hd_v)`` in :data:`HEAD_DIMS`, float32 or bfloat16,
    contiguous; anything else raises), the plain version for CPU tensors.
    ``scale`` multiplies q (default ``hd^-0.5``), rounded to q's dtype.
    Where gradients are on and an input requires one, it runs as
    :class:`FlashAttention`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale)
    if q.device.type == "cuda":
        return _flash_attention_cuda(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type == "meta":
        return _flash_attention_meta(q, k, v, causal)
    raise ValueError(f"no flash_attention for device {q.device}")
