"""MoE dispatch policies and the expert-parallel dispatch over a shard
group (the port of :mod:`repro.moe`)."""

from repro_torch.moe.balancing import (  # noqa: F401
    topk_route, moe_dispatch, calibrate_capacity, DISPATCH_METHODS)
