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
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import (DTYPE_CODES, LAUNCHES, check_aligned,
                                        check_dense)

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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale=None) -> torch.Tensor:
    """The plain version: the whole ``[Sq, Sk]`` softmax at once, with the
    reference kernel's rounding points."""
    B, Hq, Hkv, Sq, Sk, hd, hd_v = _shapes(q, k, v)
    G = Hq // Hkv
    qs = (q.float() * scale_for(hd, q.dtype, scale)).to(q.dtype)
    qg = qs.reshape(B, Hkv, G, Sq, hd).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    if causal:
        keep = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    out = acc / p.sum(-1).clamp_min(1e-30)[..., None]
    return out.reshape(B, Hq, Sq, hd_v).to(q.dtype)


def _flash_attention_cuda(q, k, v, causal: bool, scale) -> torch.Tensor:
    B, Hq, Hkv, Sq, Sk, hd, hd_v = _shapes(q, k, v)
    dev, dtype = q.device, q.dtype
    if dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{dtype}")
    if (hd, hd_v) not in HEAD_DIMS:
        raise ValueError(f"flash_attention's kernel takes (head_dim, "
                         f"v head_dim) in {HEAD_DIMS}, got {(hd, hd_v)}")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"batch {B} or heads {Hq} exceed the grid")
    check_dense("q", q, dev, dtype, (B, Hq, Sq, hd))
    check_dense("k", k, dev, dtype, (B, Hkv, Sk, hd))
    check_dense("v", v, dev, dtype, (B, Hkv, Sk, hd_v))
    if dtype == torch.bfloat16:
        check_aligned(q=q, k=k, v=v)
    out = q.new_empty(B, Hq, Sq, hd_v)
    with torch.cuda.device(dev):
        _build.check("flash_attention", _build.lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, Sq, Sk, hd, hd_v, int(causal), DTYPE_CODES[dtype],
            scale_for(hd, dtype, scale), _build.stream_of(dev)))
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale=None) -> torch.Tensor:
    """GQA attention, on the tensors' device: the CUDA kernel for CUDA
    tensors (``(hd, hd_v)`` in :data:`HEAD_DIMS`, float32 or bfloat16,
    contiguous; anything else raises), the plain version for CPU tensors.
    ``scale`` multiplies q (default ``hd^-0.5``), rounded to q's dtype."""
    if q.device.type == "cuda":
        return _flash_attention_cuda(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"no flash_attention for device {q.device}")
