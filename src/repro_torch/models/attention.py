"""Attention variants, the counterpart of :mod:`repro.models.attention`:

* GQA (+RoPE), with optional QKV bias (qwen1.5), per-head qk RMSNorm
  (qwen3) and the padded head layout ``pad_heads`` (KV heads repeated,
  query heads regrouped and padded to 16-way shardable counts);
* MLA, deepseek-v3's multi-head latent attention: low-rank Q and KV with
  a decoupled RoPE part.  The prefill expands the latent to per-head K/V
  and runs B4 at q/k head dim ``nope + rope`` and v head dim ``v``; the
  decode absorbs ``wk_b``/``wv_b`` into q and the output, so the cache
  stays compressed (``c_kv`` and ``k_rope``, head-shared);
* cross-attention, llama-3.2-vision's gated image layers: non-causal B4
  over the vision embeddings at prefill, which fills the cache with their
  K/V; decode attends to that cache.

Each variant has ``*_specs`` (the parameter specs), ``*_forward`` (a whole
prompt; with a cache, the prefill that writes it) and ``*_decode`` (one
position per sequence against the cache).  Caches are updated in place
(the reference returns new arrays), and they hold no ``length`` leaf: the
reference's is read by nothing, since decoding masks by each sequence's
position.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_rope, attention, decode_attention, rmsnorm, rmsnorm_specs)
from repro_torch.models.params import ParamSpec, shard_if


# ===========================================================================
# GQA
# ===========================================================================

def head_layout(cfg: ModelConfig):
    """The padded head layout of ``cfg.pad_heads``: ``(hq_p, hkv_p, r,
    G_p)``, or None where it does not apply or is not needed.

    KV heads are repeated ``r = 16 / hkv`` times (tied: one set of
    weights); query heads are regrouped so that each replica serves a
    contiguous sub-group of ``G_p = ceil(G / r)`` (the last one padded).
    granite (24/8 heads): 32 query slots over 16 KV heads."""
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    if not cfg.pad_heads or hkv == 0:
        return None
    if hq % 16 == 0 and hkv % 16 == 0:
        return None                      # already shardable
    if hkv >= 16 or 16 % hkv != 0:
        return None                      # e.g. qwen1.5's 20 KV heads
    r = 16 // hkv
    G = hq // hkv
    G_p = -(-G // r)
    return (16 * G_p, 16, r, G_p)


def q_head_map(cfg: ModelConfig) -> list:
    """For each padded query slot, the real query head or -1 (a pad).
    Slot ``(kv', s)``, ``kv' = j·r + t`` (replica ``t`` of KV head ``j``),
    ``s < G_p``, is query head ``j·G + t·G_p + s`` when that is below
    ``(j + 1)·G``."""
    lay = head_layout(cfg)
    if lay is None:
        raise ValueError(f"{cfg.name}: no padded head layout")
    _, hkv_p, r, G_p = lay
    G = cfg.num_heads // cfg.num_kv_heads
    out = []
    for kvp in range(hkv_p):
        j, t = kvp // r, kvp % r
        for s in range(G_p):
            g = t * G_p + s
            out.append(j * G + g if g < G else -1)
    return out


def _q_mask(cfg: ModelConfig, dtype, device):
    """[1,hq_p,1,1] ones and zeros that zero the padded query slots, or
    None without a padded layout."""
    if head_layout(cfg) is None:
        return None
    m = torch.tensor([1.0 if h >= 0 else 0.0 for h in q_head_map(cfg)],
                     device=device)
    return m.to(dtype)[None, :, None, None]


def gqa_specs(cfg: ModelConfig, fsdp=None) -> dict:
    """The projections; ``fsdp`` (``"data"`` or None) shards d_model.  The
    partition specs are the reference's: query heads over ``model`` where
    16 divide them (always, padded), KV heads likewise (never, padded:
    their 8 tied heads are repeated at run time)."""
    d, hq, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    lay = head_layout(cfg)
    if lay is not None:
        hq = lay[0]                      # query slots; KV heads stay tied
        tp_q, tp_kv = "model", None
    else:
        tp_q = shard_if(hq, "model", 16)
        tp_kv = shard_if(hkv, "model", 16)
    dt = cfg.dtype
    specs = {
        "wq": ParamSpec((d, hq, hd), dt, "scaled", pspec=(fsdp, tp_q, None)),
        "wk": ParamSpec((d, hkv, hd), dt, "scaled",
                        pspec=(fsdp, tp_kv, None)),
        "wv": ParamSpec((d, hkv, hd), dt, "scaled",
                        pspec=(fsdp, tp_kv, None)),
        "wo": ParamSpec((hq, hd, d), dt, "scaled", pspec=(tp_q, None, fsdp)),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((hq, hd), dt, "zeros", pspec=(tp_q, None))
        specs["bk"] = ParamSpec((hkv, hd), dt, "zeros",
                                pspec=(tp_kv, None) if lay is None else ())
        specs["bv"] = ParamSpec((hkv, hd), dt, "zeros",
                                pspec=(tp_kv, None) if lay is None else ())
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
    lay = head_layout(cfg)
    if lay is not None:                  # the tied KV heads, repeated
        k = k.repeat_interleave(lay[2], dim=1)
        v = v.repeat_interleave(lay[2], dim=1)
    q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
    k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def _out_proj(params, cfg: ModelConfig, out):
    qm = _q_mask(cfg, out.dtype, out.device)
    if qm is not None:
        out = out * qm
    return torch.einsum("bhsk,hkd->bsd", out, params["wo"])


def gqa_forward(params, cfg: ModelConfig, x, positions, cache=None):
    """x [B,S,D], positions [B,S].  Returns (out [B,S,D], cache).

    With a ``cache`` ({k, v: [B,Hkv,max_len,hd]}) this is the prefill: K/V
    are written at offset 0."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    if cache is not None:
        S = x.shape[1]
        cache["k"][:, :, :S] = k
        cache["v"][:, :, :S] = v
    return _out_proj(params, cfg, attention(q, k, v, causal=True)), cache


def _positions_b(position, B: int, device) -> torch.Tensor:
    """An int (lockstep batch) or a [B] tensor (ragged slots) as [B]."""
    return torch.as_tensor(position, dtype=torch.int64,
                           device=device).expand(B)


def gqa_decode(params, cfg: ModelConfig, x, position, cache):
    """x [B,1,D]; ``position`` an int (lockstep batch) or a [B] tensor
    (continuous batching with ragged slots).  Appends this position's K/V
    to the cache in place."""
    B = x.shape[0]
    pos_b = _positions_b(position, B, x.device)
    q, k, v = _project_qkv(params, cfg, x, pos_b[:, None])
    bi = torch.arange(B, device=x.device)
    cache["k"][bi, :, pos_b] = k[:, :, 0]
    cache["v"][bi, :, pos_b] = v[:, :, 0]
    out = decode_attention(q, cache["k"], cache["v"], pos_b + 1)
    return _out_proj(params, cfg, out), cache


def gqa_cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                    seq_axis=None) -> dict:
    """K/V [batch,Hkv,max_len,hd]: the batch over ``data`` where 16
    divide it, else (one long sequence) the sequence over ``seq_axis``."""
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    lay = head_layout(cfg)
    if lay is not None:
        hkv = lay[1]
    kv = ParamSpec((batch, hkv, max_len, hd), cfg.dtype, "zeros",
                   pspec=("data" if batch % 16 == 0 else None,
                          shard_if(hkv, "model", 16), seq_axis, None))
    return {"k": kv, "v": kv}


# ===========================================================================
# MLA (deepseek-v3)
# ===========================================================================

def mla_specs(cfg: ModelConfig, fsdp=None) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    tp_h = shard_if(h, "model", 16)
    dt = cfg.dtype
    return {
        "wq_a": ParamSpec((d, qr), dt, "scaled",
                          pspec=(fsdp, shard_if(qr, "model", 16))),
        "q_norm": rmsnorm_specs(qr),
        "wq_b": ParamSpec((qr, h, dn + dr), dt, "scaled",
                          pspec=(fsdp, tp_h, None)),
        "wkv_a": ParamSpec((d, kvr + dr), dt, "scaled", pspec=(fsdp, None)),
        "kv_norm": rmsnorm_specs(kvr),
        "wk_b": ParamSpec((kvr, h, dn), dt, "scaled",
                          pspec=(fsdp, tp_h, None)),
        "wv_b": ParamSpec((kvr, h, dv), dt, "scaled",
                          pspec=(fsdp, tp_h, None)),
        "wo": ParamSpec((h, dv, d), dt, "scaled", pspec=(tp_h, None, fsdp)),
    }


def _mla_scale(cfg: ModelConfig) -> float:
    """``(nope + rope)^-0.5``, what the reference passes: B4's default at
    q/k head dim ``nope + rope``."""
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5


def _mla_latents(params, cfg: ModelConfig, x, positions):
    """The shared low-rank path: q's nope and rope parts [B,h,S,·], the
    normed KV latent ``c_kv`` [B,S,kvr] and the head-shared ``k_rope``
    [B,1,S,dr]."""
    dn, kvr = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q_lat = rmsnorm(params["q_norm"], x @ params["wq_a"])
    q = torch.einsum("bsr,rhk->bhsk", q_lat, params["wq_b"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions[:, None, :], cfg.rope_theta)
    kv = x @ params["wkv_a"]                               # [B,S,kvr+dr]
    c_kv = rmsnorm(params["kv_norm"], kv[..., :kvr])
    k_rope = apply_rope(kv[..., None, :, kvr:], positions[:, None, :],
                        cfg.rope_theta)                    # [B,1,S,dr]
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(params, cfg: ModelConfig, x, positions, cache=None):
    """x [B,S,D] -> (out [B,S,D], cache).  The latent is expanded to
    per-head K (``[k_nope; k_rope]``, the rope part broadcast over the
    heads and made dense for B4) and V, and B4 runs causal at head dims
    ``(nope + rope, v)``.  With a cache ({c_kv [B,max_len,kvr], k_rope
    [B,max_len,dr]}) the latents are written at offset 0."""
    q_nope, q_rope, c_kv, k_rope = _mla_latents(params, cfg, x, positions)
    k_nope = torch.einsum("bsr,rhk->bhsk", c_kv, params["wk_b"])
    v = torch.einsum("bsr,rhk->bhsk", c_kv, params["wv_b"])
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3], -1)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = attention(q, k, v, causal=True, scale=_mla_scale(cfg))
    out = torch.einsum("bhsk,hkd->bsd", out, params["wo"])
    if cache is not None:
        S = x.shape[1]
        cache["c_kv"][:, :S] = c_kv
        cache["k_rope"][:, :S] = k_rope[:, 0]
    return out, cache


def mla_decode(params, cfg: ModelConfig, x, position, cache):
    """One position per sequence, weight-absorbed, over the compressed
    cache (plain tensor code: the reference has no kernel for it)::

        score = q_nope·(c_kv W_kb) + q_rope·k_rope
              = (q_nope W_kb^T)·c_kv + q_rope·k_rope
        out   = (p·c_kv) W_vb

    keys at ``t <= position`` of each sequence.  The two score products
    and their sum round to x's dtype, then the softmax runs in float32,
    as the reference's."""
    B = x.shape[0]
    pos_b = _positions_b(position, B, x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_latents(params, cfg, x,
                                                pos_b[:, None])
    bi = torch.arange(B, device=x.device)
    cache["c_kv"][bi, pos_b] = c_kv[:, 0]
    cache["k_rope"][bi, pos_b] = k_rope[:, 0, 0]
    ckv_c, krope_c = cache["c_kv"], cache["k_rope"]
    q_abs = torch.einsum("bhsk,rhk->bhsr", q_nope, params["wk_b"])
    scale = torch.tensor(_mla_scale(cfg), dtype=x.dtype)
    s = (torch.einsum("bhsr,btr->bhst", q_abs, ckv_c)
         + torch.einsum("bhsk,btk->bhst", q_rope, krope_c)) * scale
    T = ckv_c.shape[1]
    keep = (torch.arange(T, device=x.device)[None, None, None, :]
            <= pos_b[:, None, None, None])
    s = torch.where(keep, s.float(), -1e30)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    o_c = torch.einsum("bhst,btr->bhsr", p, ckv_c)         # [B,h,1,kvr]
    out = torch.einsum("bhsr,rhk->bhsk", o_c, params["wv_b"])
    out = torch.einsum("bhsk,hkd->bsd", out, params["wo"])
    return out, cache


def mla_cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                    seq_axis=None) -> dict:
    b_ax = "data" if batch % 16 == 0 else None
    return {
        "c_kv": ParamSpec((batch, max_len, cfg.kv_lora_rank), cfg.dtype,
                          "zeros", pspec=(b_ax, seq_axis, None)),
        "k_rope": ParamSpec((batch, max_len, cfg.qk_rope_head_dim),
                            cfg.dtype, "zeros", pspec=(b_ax, seq_axis, None)),
    }


# ===========================================================================
# Cross-attention (llama-3.2-vision image layers)
# ===========================================================================

def cross_attn_specs(cfg: ModelConfig, fsdp=None) -> dict:
    d, hq, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    tp_q, tp_kv = shard_if(hq, "model", 16), shard_if(hkv, "model", 16)
    dt = cfg.dtype
    return {
        "wq": ParamSpec((d, hq, hd), dt, "scaled", pspec=(fsdp, tp_q, None)),
        "wk": ParamSpec((d, hkv, hd), dt, "scaled",
                        pspec=(fsdp, tp_kv, None)),
        "wv": ParamSpec((d, hkv, hd), dt, "scaled",
                        pspec=(fsdp, tp_kv, None)),
        "wo": ParamSpec((hq, hd, d), dt, "scaled", pspec=(tp_q, None, fsdp)),
        "q_norm": rmsnorm_specs(hd),
        "k_norm": rmsnorm_specs(hd),
        "gate": ParamSpec((), "float32", "zeros"),
    }


def _gated(params, out):
    """``tanh(gate)`` in float32, rounded to the output's dtype, times
    the output: a zero gate (its init) closes the layer."""
    return torch.tanh(params["gate"]).to(out.dtype) * out


def cross_attn_forward(params, cfg: ModelConfig, x, vision_embeds,
                       cache=None):
    """x [B,S,D] text; vision_embeds [B,T,D] (the stub frontend's output).
    Non-causal B4 over the T image tokens.  With a cache ({k, v:
    [B,Hkv,T,hd]}) the image K/V are written into it."""
    q = torch.einsum("bsd,dhk->bhsk", x, params["wq"])
    k = torch.einsum("btd,dhk->bhtk", vision_embeds, params["wk"])
    v = torch.einsum("btd,dhk->bhtk", vision_embeds, params["wv"])
    q = rmsnorm(params["q_norm"], q)
    k = rmsnorm(params["k_norm"], k)
    out = attention(q, k, v, causal=False)
    out = _gated(params, torch.einsum("bhsk,hkd->bsd", out, params["wo"]))
    if cache is not None:
        cache["k"].copy_(k)
        cache["v"].copy_(v)
    return out, cache


def cross_attn_decode(params, cfg: ModelConfig, x, cache):
    """x [B,1,D] against the image K/V the prefill cached."""
    q = rmsnorm(params["q_norm"],
                torch.einsum("bsd,dhk->bhsk", x, params["wq"]))
    out = decode_attention(q, cache["k"], cache["v"], cache["k"].shape[2])
    out = torch.einsum("bhsk,hkd->bsd", out, params["wo"])
    return _gated(params, out), cache


def cross_cache_specs(cfg: ModelConfig, batch: int) -> dict:
    hkv = cfg.num_kv_heads
    kv = ParamSpec((batch, hkv, cfg.num_image_tokens,
                    cfg.resolved_head_dim), cfg.dtype, "zeros",
                   pspec=("data" if batch % 16 == 0 else None,
                          shard_if(hkv, "model", 16), None, None))
    return {"k": kv, "v": kv}
