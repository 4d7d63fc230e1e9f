"""Mamba-2 (SSD, arXiv:2405.21060) sequence mixer, the counterpart of
:mod:`repro.models.mamba`: per-component input projections (z/x/B/C/dt),
a depthwise causal conv, the chunked SSD scan, and the gated RMSNorm.

In :func:`ssd_chunked` the intra-chunk block (``y_intra`` and the chunk
states) goes through B5 (``kernels/ssd_chunk.py``): the CUDA kernel on the
card, its plain version on the CPU.  The inter-chunk recurrence and the
inter-chunk output stay plain PyTorch, as they stay XLA in the reference.

Shapes: d_inner = heads·head_dim, state N, conv width K.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk import ssd_chunk_dual
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec, shard_if


def _dims(cfg: ModelConfig):
    return cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv


def mamba_specs(cfg: ModelConfig, fsdp=None) -> dict:
    d = cfg.d_model
    h, p, n, k = _dims(cfg)
    tp_h = shard_if(h, "model", 16)
    dt = cfg.dtype
    return {
        "wz": ParamSpec((d, h, p), dt, "scaled", pspec=(fsdp, tp_h, None)),
        "wx": ParamSpec((d, h, p), dt, "scaled", pspec=(fsdp, tp_h, None)),
        "wB": ParamSpec((d, n), dt, "scaled", pspec=(fsdp, None)),
        "wC": ParamSpec((d, n), dt, "scaled", pspec=(fsdp, None)),
        "wdt": ParamSpec((d, h), dt, "scaled", pspec=(fsdp, tp_h)),
        "conv_x": ParamSpec((k, h, p), dt, "scaled", pspec=(None, tp_h, None)),
        "conv_B": ParamSpec((k, n), dt, "scaled"),
        "conv_C": ParamSpec((k, n), dt, "scaled"),
        "A_log": ParamSpec((h,), "float32", "zeros", pspec=(tp_h,)),
        "D": ParamSpec((h,), "float32", "ones", pspec=(tp_h,)),
        "dt_bias": ParamSpec((h,), "float32", "zeros", pspec=(tp_h,)),
        "norm": ParamSpec((h, p), "float32", "ones", pspec=(tp_h, None)),
        "wo": ParamSpec((h, p, d), dt, "scaled", pspec=(tp_h, None, fsdp)),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # torch's softplus is the identity above 20 where jax.nn.softplus is
    # log1p(exp(x)); the two differ there by log1p(exp(-20)) < 3e-9
    return F.softplus(x)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S.  x [B,S,...C], w [K, ...C]; a sum of
    K shifted products in x's dtype, in the reference's order."""
    k, S = w.shape[0], x.shape[1]
    pads = F.pad(x, [0, 0] * (x.dim() - 2) + [k - 1, 0])
    out = 0
    for i in range(k):
        out = out + pads[:, i:i + S] * w[i]
    return out


def _gated_norm(scale, y, z, eps: float = 1e-6):
    """Per-head gated RMSNorm: norm(y * silu(z)) within each head."""
    y = (y * F.silu(z.float())).float()
    var = (y * y).mean(-1, keepdim=True)
    return (y * torch.rsqrt(var + eps) * scale).to(z.dtype)


def ssd_chunked(xbar, log_a, Bm, Cm, chunk: int, initial_state=None):
    """Chunked SSD scan.

    xbar [B,S,H,P] (dt-discretised inputs), log_a [B,S,H] (<= 0 decay
    logs), Bm/Cm [B,S,N].  Returns (y [B,S,H,P] f32, final_state
    [B,H,N,P] f32)."""
    Bsz, S, H, Pd = xbar.shape
    N = Bm.shape[-1]
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        xbar = F.pad(xbar, (0, 0, 0, 0, 0, pad))
        log_a = F.pad(log_a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = xbar.shape[1] // c
    la = log_a.reshape(Bsz, nc, c, H).float()
    # float32 cum, accumulated in float64 on every device: PyTorch's CPU
    # cumsum already accumulates float32 in float64, its CUDA scan in
    # float32, and at |cum| ~ 250 (a chunk of strong decay) the scan's
    # rounding puts ~1e-5 into every exp(cum_i - cum_j)
    cum = torch.cumsum(la.double(), dim=2).float()         # [B,nc,c,H]
    total = cum[:, :, -1, :]                               # [B,nc,H]

    # intra-chunk block and chunk states: B5 on [B·nc, c, ...]
    y_intra, cstate = ssd_chunk_dual(
        xbar.reshape(Bsz * nc, c, H, Pd).contiguous(),
        cum.reshape(Bsz * nc, c, H).contiguous(),
        Bm.reshape(Bsz * nc, c, N).contiguous(),
        Cm.reshape(Bsz * nc, c, N).contiguous())
    y_intra = y_intra.reshape(Bsz, nc, c, H, Pd)
    cstate = cstate.reshape(Bsz, nc, H, N, Pd)

    # inter-chunk recurrence over the nc chunk states
    if initial_state is None:
        state = torch.zeros((Bsz, H, N, Pd), dtype=torch.float32,
                            device=xbar.device)
    else:
        state = initial_state.float()
    s_ins = []
    for i in range(nc):
        s_ins.append(state)
        state = state * torch.exp(total[:, i])[:, :, None, None] \
            + cstate[:, i]
    s_ins = torch.stack(s_ins, dim=1)                      # [B,nc,H,N,P]

    # inter-chunk contribution: y[i] += C_i · exp(cum_i) S_in
    Cc = Cm.reshape(Bsz, nc, c, N).float()
    y_inter = torch.einsum("bnis,bnhsp->bnihp", Cc, s_ins) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, nc * c, H, Pd)[:, :S]
    return y, state


def mamba_forward(params, cfg: ModelConfig, x, cache=None):
    """x [B,S,D] -> [B,S,D].  With a ``cache`` dict, fills it with the
    final SSM state and the last K-1 pre-conv inputs (the conv windows)
    for decoding."""
    h, p, n, k = _dims(cfg)
    z = torch.einsum("bsd,dhp->bshp", x, params["wz"])
    xi = torch.einsum("bsd,dhp->bshp", x, params["wx"])
    Bm = x @ params["wB"]
    Cm = x @ params["wC"]
    dt = _softplus((x @ params["wdt"]).float() + params["dt_bias"])
    xi_raw, Bm_raw, Cm_raw = xi, Bm, Cm        # pre-conv (cache windows)
    xi = F.silu(_causal_conv(xi, params["conv_x"]))
    Bm = F.silu(_causal_conv(Bm, params["conv_B"]))
    Cm = F.silu(_causal_conv(Cm, params["conv_C"]))
    A = -torch.exp(params["A_log"])
    log_a = dt * A                                         # [B,S,H] <= 0
    xbar = xi * dt[..., None].to(xi.dtype)
    y, final_state = ssd_chunked(xbar, log_a, Bm, Cm, cfg.ssm_chunk)
    y = y + params["D"][None, None, :, None] * xi.float()
    y = _gated_norm(params["norm"], y, z)
    out = torch.einsum("bshp,hpd->bsd", y, params["wo"])
    if cache is not None:
        cache["ssm"].copy_(final_state)
        cache["conv_x"].copy_(_last_window(xi_raw, k - 1))
        cache["conv_B"].copy_(_last_window(Bm_raw, k - 1))
        cache["conv_C"].copy_(_last_window(Cm_raw, k - 1))
    return out, cache


def _last_window(x, w: int):
    """Last ``w`` positions along S (zeros in front if shorter)."""
    S = x.shape[1]
    if S >= w:
        return x[:, S - w:]
    return F.pad(x, [0, 0] * (x.dim() - 2) + [w - S, 0])


def mamba_decode(params, cfg: ModelConfig, x, cache):
    """Single-token recurrent update of every sequence, x [B,1,D]; the
    cache is updated in place."""
    z = torch.einsum("bsd,dhp->bshp", x, params["wz"])[:, 0]
    xi = torch.einsum("bsd,dhp->bshp", x, params["wx"])[:, 0]   # [B,H,P]
    Bm = (x @ params["wB"])[:, 0]                                # [B,N]
    Cm = (x @ params["wC"])[:, 0]
    dt = _softplus((x @ params["wdt"])[:, 0].float() + params["dt_bias"])

    def conv_step(name, new, w):
        # window [B, K-1, ...C], new [B, ...C]
        full = torch.cat([cache[name], new[:, None]], dim=1)    # [B,K,...]
        cache[name] = full[:, 1:]
        return torch.einsum("bk...,k...->b...", full, w)

    xi_c = F.silu(conv_step("conv_x", xi, params["conv_x"]))
    Bm_c = F.silu(conv_step("conv_B", Bm, params["conv_B"]))
    Cm_c = F.silu(conv_step("conv_C", Cm, params["conv_C"]))
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt * A)                                        # [B,H]
    xbar = xi_c.float() * dt[..., None]
    state = (cache["ssm"] * a[:, :, None, None]
             + torch.einsum("bs,bhp->bhsp", Bm_c.float(), xbar))
    cache["ssm"] = state
    y = torch.einsum("bs,bhsp->bhp", Cm_c.float(), state)
    y = y + params["D"][None, :, None] * xi_c.float()
    y = _gated_norm(params["norm"], y[:, None], z[:, None])[:, 0]
    out = torch.einsum("bhp,hpd->bd", y, params["wo"])[:, None]
    return out, cache


def mamba_cache_specs(cfg: ModelConfig, batch: int) -> dict:
    h, p, n, k = _dims(cfg)
    tp_h = shard_if(h, "model", 16)
    b_ax = "data" if batch % 16 == 0 else None
    dt = cfg.dtype
    return {
        "ssm": ParamSpec((batch, h, n, p), "float32", "zeros",
                         pspec=(b_ax, tp_h, None, None)),
        "conv_x": ParamSpec((batch, k - 1, h, p), dt, "zeros",
                            pspec=(b_ax, None, tp_h, None)),
        "conv_B": ParamSpec((batch, k - 1, n), dt, "zeros",
                            pspec=(b_ax, None, None)),
        "conv_C": ParamSpec((batch, k - 1, n), dt, "zeros",
                            pspec=(b_ax, None, None)),
    }
