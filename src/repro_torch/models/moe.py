"""MoE FFN layer: router + shared experts + paper-policy dispatch (the
port of :mod:`repro.models.moe`).

With no active shard group (:func:`repro_torch.moe.sharded.use_group`)
the layer dispatches on one device with :func:`moe_dispatch` and the
config's policy.  Under a group it takes the reference's mesh branches:
``serve_ep``'s global dispatch (the shards over the whole grid, its own
capacity) or, with ``moe_impl="shard_map"``, the expert-parallel dispatch
(experts padded by ``pad_experts`` when the shards do not divide them);
both report zero drop statistics, as the reference's do.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ffn, ffn_specs
from repro_torch.models.params import ParamSpec, shard_if
from repro_torch.moe import sharded
from repro_torch.moe.balancing import moe_dispatch, topk_route


def moe_specs(cfg: ModelConfig, fsdp=None) -> dict:
    """The router (float32 ``[D, E]``), the experts (``w_up``/``w_gate``
    ``[E, D, F]``, ``w_down`` ``[E, F, D]``; no ``w_gate`` unless SwiGLU)
    and the shared experts' FFN, when the config has any.  The experts
    lie over ``model`` where 16 divide them, else their inner dim does
    (granite: 40 experts); ``serve_ep`` puts one expert group a device on
    the ``data`` x ``model`` grid (the reference's specs)."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    if cfg.serve_ep:
        tp_e, tp_f = ("data", "model"), None
        fsdp = None              # the expert dim takes both axes
    else:
        tp_e = shard_if(e, "model", 16)
        tp_f = None if tp_e else shard_if(f, "model", 16)
    specs = {
        "router": ParamSpec((d, e), "float32", "scaled", pspec=(fsdp, None)),
        "experts": {
            "w_up": ParamSpec((e, d, f), cfg.dtype, "scaled",
                              pspec=(tp_e, fsdp, tp_f)),
            "w_gate": ParamSpec((e, d, f), cfg.dtype, "scaled",
                                pspec=(tp_e, fsdp, tp_f)),
            "w_down": ParamSpec((e, f, d), cfg.dtype, "scaled",
                                pspec=(tp_e, tp_f, fsdp)),
        },
    }
    if cfg.ffn_activation != "swiglu":
        del specs["experts"]["w_gate"]
    if cfg.num_shared_experts:
        specs["shared"] = ffn_specs(
            d, cfg.moe_d_ff * cfg.num_shared_experts,
            activation=cfg.ffn_activation, fsdp=fsdp, dtype=cfg.dtype)
    return specs


def moe_capacity(cfg: ModelConfig, seq_len: int) -> int:
    """Static per-row capacity = cf × mean assignments per expert."""
    mean = seq_len * cfg.experts_per_token / cfg.num_experts
    return max(int(mean * cfg.moe_capacity_factor) + 1, 4)


def moe_ffn(params, cfg: ModelConfig, x: torch.Tensor):
    """x [B,S,D] -> (y [B,S,D], aux): the router's product in float32,
    top-k routing, the dispatch (above) at :func:`moe_capacity` of the
    sequence, plus the shared experts.  ``aux`` holds the routing losses,
    the dispatch's drop statistics, and the routing itself: the router's
    float32 logits [B,S,E] (padded where the experts are) and the chosen
    ids [B,S,K]."""
    group = sharded.ACTIVE_GROUP
    logits = x.float() @ params["router"]
    experts, num_experts = params["experts"], cfg.num_experts
    if (group is not None and cfg.moe_impl == "shard_map"
            and num_experts % group.num_shards):
        experts, logits, num_experts = sharded.pad_experts(
            experts, logits, num_experts, group.num_shards)
    weights, ids, aux = topk_route(logits, cfg.experts_per_token)
    if group is not None and (cfg.serve_ep or cfg.moe_impl == "shard_map"):
        if cfg.serve_ep:
            # the global batch's assignments share each expert's slots
            B, S, _ = x.shape
            ranks = 1 if group.process_group is None else group.num_shards
            cap = max(int(B * ranks * S * cfg.experts_per_token / num_experts
                          * cfg.moe_capacity_factor) + 1, 8)
            y = sharded.ep_global_dispatch(
                x, ids, weights, experts, group=group,
                num_experts=num_experts, capacity=cap,
                activation=cfg.ffn_activation)
        else:
            y = sharded.sharded_moe_dispatch(
                x, ids, weights, experts, group=group,
                num_experts=num_experts,
                capacity=moe_capacity(cfg, x.shape[1]),
                activation=cfg.ffn_activation)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        stats = {"dropped_frac": zero, "padding_waste": zero}
    else:
        y, stats = moe_dispatch(
            x, ids, weights, experts, num_experts=num_experts,
            capacity=moe_capacity(cfg, x.shape[1]),
            activation=cfg.ffn_activation, method=cfg.moe_balance)
    if cfg.num_shared_experts:
        y = y + ffn(params["shared"], x, activation=cfg.ffn_activation)
    aux.update(stats, router_logits=logits, ids=ids)
    return y, aux
