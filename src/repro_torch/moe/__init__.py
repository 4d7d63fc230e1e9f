"""MoE dispatch policies (the port of :mod:`repro.moe`); the sharded
dispatch (``moe/sharded.py``) is not ported yet (ROADMAP A15)."""

from repro_torch.moe.balancing import (  # noqa: F401
    topk_route, moe_dispatch, calibrate_capacity, DISPATCH_METHODS)
