"""MoE FFN layer: router + shared experts + paper-policy dispatch (the
port of :mod:`repro.models.moe`).

The reference's mesh branches (``serve_ep``'s expert-parallel global
dispatch and ``moe_impl="shard_map"``) run only under a device mesh; with
none active they fall to :func:`repro.moe.balancing.moe_dispatch`, which
is what the port runs on one device.  The sharded dispatch is
``moe/sharded.py``'s, not ported yet (ROADMAP A15).
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ffn, ffn_specs
from repro_torch.models.params import ParamSpec
from repro_torch.moe.balancing import moe_dispatch, topk_route


def moe_specs(cfg: ModelConfig) -> dict:
    """The router (float32 ``[D, E]``), the experts (``w_up``/``w_gate``
    ``[E, D, F]``, ``w_down`` ``[E, F, D]``; no ``w_gate`` unless SwiGLU)
    and the shared experts' FFN, when the config has any."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    specs = {
        "router": ParamSpec((d, e), "float32", "scaled"),
        "experts": {
            "w_up": ParamSpec((e, d, f), cfg.dtype, "scaled"),
            "w_gate": ParamSpec((e, d, f), cfg.dtype, "scaled"),
            "w_down": ParamSpec((e, f, d), cfg.dtype, "scaled"),
        },
    }
    if cfg.ffn_activation != "swiglu":
        del specs["experts"]["w_gate"]
    if cfg.num_shared_experts:
        specs["shared"] = ffn_specs(
            d, cfg.moe_d_ff * cfg.num_shared_experts,
            activation=cfg.ffn_activation, dtype=cfg.dtype)
    return specs


def moe_capacity(cfg: ModelConfig, seq_len: int) -> int:
    """Static per-row capacity = cf × mean assignments per expert."""
    mean = seq_len * cfg.experts_per_token / cfg.num_experts
    return max(int(mean * cfg.moe_capacity_factor) + 1, 4)


def moe_ffn(params, cfg: ModelConfig, x: torch.Tensor):
    """x [B,S,D] -> (y [B,S,D], aux): the router's product in float32,
    top-k routing, the dispatch policy ``cfg.moe_balance`` at
    :func:`moe_capacity` of the sequence, plus
    the shared experts.  ``aux`` holds the routing losses, the
    dispatch's drop statistics, and the routing itself: the router's
    float32 logits [B,S,E] and the chosen ids [B,S,K]."""
    logits = x.float() @ params["router"]
    weights, ids, aux = topk_route(logits, cfg.experts_per_token)
    y, stats = moe_dispatch(
        x, ids, weights, params["experts"],
        num_experts=cfg.num_experts,
        capacity=moe_capacity(cfg, x.shape[1]),
        activation=cfg.ffn_activation,
        method=cfg.moe_balance)
    if cfg.num_shared_experts:
        y = y + ffn(params["shared"], x, activation=cfg.ffn_activation)
    aux.update(stats, router_logits=logits, ids=ids)
    return y, aux
