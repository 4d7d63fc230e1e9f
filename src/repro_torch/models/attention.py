"""GQA attention (+RoPE), the counterpart of the GQA part of
:mod:`repro.models.attention`: optional QKV bias (qwen1.5) and per-head qk
RMSNorm (qwen3).

``gqa_forward`` runs a whole prompt (prefill) and writes the KV cache when
given one; ``gqa_decode`` runs one position per sequence against it.  The
cache is updated in place (the reference returns new arrays), and it holds
only ``k`` and ``v``: the reference's ``length`` leaf is read by nothing,
since decoding masks by each sequence's position.  MLA,
cross-attention and the padded head layout (``pad_heads``) are not ported
yet (ROADMAP A15): ``models.model.check_supported`` refuses them.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_rope, causal_attention, decode_attention, rmsnorm, rmsnorm_specs)
from repro_torch.models.params import ParamSpec


def gqa_specs(cfg: ModelConfig) -> dict:
    d, hq, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    dt = cfg.dtype
    specs = {
        "wq": ParamSpec((d, hq, hd), dt, "scaled"),
        "wk": ParamSpec((d, hkv, hd), dt, "scaled"),
        "wv": ParamSpec((d, hkv, hd), dt, "scaled"),
        "wo": ParamSpec((hq, hd, d), dt, "scaled"),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((hq, hd), dt, "zeros")
        specs["bk"] = ParamSpec((hkv, hd), dt, "zeros")
        specs["bv"] = ParamSpec((hkv, hd), dt, "zeros")
    if cfg.qk_norm:
        specs["q_norm"] = rmsnorm_specs(hd)
        specs["k_norm"] = rmsnorm_specs(hd)
    return specs


def _project_qkv(params, cfg: ModelConfig, x, positions):
    q = torch.einsum("bsd,dhk->bhsk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bhsk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bhsk", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"][None, :, None, :]
        k = k + params["bk"][None, :, None, :]
        v = v + params["bv"][None, :, None, :]
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
    k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def gqa_forward(params, cfg: ModelConfig, x, positions, cache=None):
    """x [B,S,D], positions [B,S].  Returns (out [B,S,D], cache).

    With a ``cache`` ({k, v: [B,Hkv,max_len,hd]}) this is the prefill: K/V
    are written at offset 0."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    if cache is not None:
        S = x.shape[1]
        cache["k"][:, :, :S] = k
        cache["v"][:, :, :S] = v
    out = causal_attention(q, k, v)
    out = torch.einsum("bhsk,hkd->bsd", out, params["wo"])
    return out, cache


def gqa_decode(params, cfg: ModelConfig, x, position, cache):
    """x [B,1,D]; ``position`` an int (lockstep batch) or a [B] tensor
    (continuous batching with ragged slots).  Appends this position's K/V
    to the cache in place."""
    B = x.shape[0]
    pos_b = torch.as_tensor(position, dtype=torch.int64,
                            device=x.device).expand(B)
    q, k, v = _project_qkv(params, cfg, x, pos_b[:, None])
    bi = torch.arange(B, device=x.device)
    cache["k"][bi, :, pos_b] = k[:, :, 0]
    cache["v"][bi, :, pos_b] = v[:, :, 0]
    out = decode_attention(q, cache["k"], cache["v"], pos_b + 1)
    out = torch.einsum("bhsk,hkd->bsd", out, params["wo"])
    return out, cache


def gqa_cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    kv = ParamSpec((batch, hkv, max_len, hd), cfg.dtype, "zeros")
    return {"k": kv, "v": kv}

