"""Shared layer primitives (the counterpart of :mod:`repro.models.layers`):
RMSNorm, RoPE, whole-prompt attention through the B4 kernel (causal or
not, with its own scale and a V narrower than Q and K), single-position
decode attention, and the FFN.

Layers are plain functions over tensors and parameter dicts; the matching
spec trees live next to each ``*_specs`` function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.params import ParamSpec, shard_if

NEG_INF = -1e30


def rmsnorm_specs(dim: int) -> dict:
    return {"scale": ParamSpec((dim,), "float32", "ones")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In float32, cast back to x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * params["scale"]).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., S, hd]; positions [..., S] (broadcastable).  In float32,
    split halves, cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale=None) -> torch.Tensor:
    """GQA attention of a whole prompt: q [B,Hq,Sq,hd], k [B,Hkv,Sk,hd],
    v [B,Hkv,Sk,hdv] -> [B,Hq,Sq,hdv]; causal (top-left) or not; q times
    ``scale`` (default ``hd^-0.5``) in q's dtype.  Stands where the
    reference calls ``blocked_attention`` (its XLA oracle of the Pallas
    kernel) and computes the same function through B4: the CUDA kernel on
    the card, its plain version on the CPU."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, scale=scale)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """:func:`attention` of a prompt over itself, causal, default scale."""
    return attention(q, k, v, causal=True)


def decode_attention(q, k_cache, v_cache, length, *,
                     scale=None) -> torch.Tensor:
    """Single-position attention against a KV cache, as plain tensor code
    (the reference has no kernel for it).

    q [B,Hq,1,hd]; caches [B,Hkv,S,hd] and [B,Hkv,S,hdv]; length = #valid
    cache slots, an int or a per-sequence [B] tensor (continuous batching
    serves ragged slots); ``scale`` default ``hd^-0.5``."""
    B, Hq, _, hd = q.shape
    _, Hkv, S, hdv = v_cache.shape
    G = Hq // Hkv
    scale = torch.tensor(hd ** -0.5 if scale is None else scale,
                         dtype=q.dtype)                # the reference's
    qg = q.reshape(B, Hkv, G, hd) * scale              # rounding of q·scale
    s = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k_cache.float())
    length_b = torch.as_tensor(length, device=q.device).expand(B)
    mask = (torch.arange(S, device=q.device)[None, None, None, :]
            < length_b[:, None, None, None])
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgk,bhkd->bhgd", p.float(), v_cache.float())
    return out.reshape(B, Hq, 1, hdv).to(q.dtype)


def ffn_specs(d_model: int, d_ff: int, *, activation: str, fsdp=None,
              dtype: str = "bfloat16") -> dict:
    tp16 = shard_if(d_ff, "model", 16)
    specs = {
        "w_up": ParamSpec((d_model, d_ff), dtype, "scaled",
                          pspec=(fsdp, tp16)),
        "w_down": ParamSpec((d_ff, d_model), dtype, "scaled",
                            pspec=(tp16, fsdp)),
    }
    if activation == "swiglu":
        specs["w_gate"] = ParamSpec((d_model, d_ff), dtype, "scaled",
                                    pspec=(fsdp, tp16))
    return specs


def ffn(params, x: torch.Tensor, *, activation: str = "swiglu"):
    """SwiGLU, or GELU in its tanh form (``jax.nn.gelu``'s default, not
    torch's).  A zero-width FFN (d_ff = 0) gives exact zeros."""
    up = x @ params["w_up"]
    if activation == "swiglu":
        up = F.silu(x @ params["w_gate"]) * up
    else:
        up = F.gelu(up, approximate="tanh")
    return up @ params["w_down"]
