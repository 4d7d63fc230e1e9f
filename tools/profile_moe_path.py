#!/usr/bin/env python3
"""Where granite_moe_3b_a800m's serving time goes on the card.

    python3 tools/profile_moe_path.py [--tokens 2048] [--reps 10]

Run from the root of a checkout on a machine with a CUDA card (it builds
the kernels at first use).  Prints, one JSON line each:

- ``positions_scan``: the prefix sum behind ``moe.balancing._positions``
  over a ``[1, tokens·8, 40]`` one-hot, along its middle axis (token-major,
  as the reference lays it out) and along the last axis of the
  expert-major ``[1, 40, tokens·8]`` copy the port scans: device ms of
  each (``chip_smoke.time_ms``) and whether the positions are equal;
- ``moe_layer``: one full-width MoE layer (bf16, seeded weights, the
  ``padded`` policy at the serving capacity) under ``torch.profiler``:
  device ms, device activities, and the top operators by device time;
- ``decode_step``: one decode step of the whole model (bf16, seed-0
  weights, 4 slots at ragged positions): median wall ms of ``--reps``
  steps, then one traced step's device ms, device activities and top
  operators by device time and by host time.

It imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def top_ops(prof, key: str, n: int = 8) -> list:
    rows = sorted(prof.key_averages(), key=lambda e: -getattr(e, key))
    return [dict(name=e.key[:60], calls=e.count,
                 device_ms=e.self_device_time_total / 1e3,
                 host_ms=e.self_cpu_time_total / 1e3) for e in rows[:n]]


def traced(fn):
    """(device ms, device activities, profiler) of one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    acts = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.device_time for e in acts) / 1e3, len(acts), prof


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tokens", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("profile_moe_path.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models.model import LanguageModel
    from repro_torch.models.moe import moe_capacity, moe_specs
    from repro_torch.models.params import init_params
    from repro_torch.moe import balancing as mb

    dev = torch.device("cuda")
    print(cs.nvidia_smi(), flush=True)
    cfg = get_config("granite_moe_3b_a800m")
    E, K = cfg.num_experts, cfg.experts_per_token

    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, E, (1, args.tokens * K), generator=g).to(dev)
    onehot = F.one_hot(ids, E).to(torch.int32)               # [1, A, E]
    expert_major = onehot.transpose(1, 2).contiguous()      # [1, E, A]
    middle = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    last = torch.cumsum(expert_major, dim=2, dtype=torch.int32)
    cs.emit("positions_scan", assignments=ids.shape[1], experts=E,
            middle_axis_ms=cs.time_ms(lambda: torch.cumsum(
                onehot, dim=1, dtype=torch.int32), reps=args.reps),
            last_axis_ms=cs.time_ms(lambda: torch.cumsum(
                expert_major, dim=2, dtype=torch.int32), reps=args.reps),
            equal=bool(torch.equal(middle, last.transpose(1, 2))))

    params = init_params(moe_specs(cfg), torch.Generator().manual_seed(0),
                         device=dev)
    x = torch.randn(1, args.tokens, cfg.d_model, generator=g).to(
        dev, torch.bfloat16)
    weights, ids3, _ = mb.topk_route(x.float() @ params["router"], K)
    capacity = moe_capacity(cfg, args.tokens)

    def layer():
        return mb.moe_dispatch(x, ids3, weights, params["experts"],
                               num_experts=E, capacity=capacity,
                               method="padded")
    layer()
    torch.cuda.synchronize()
    device_ms, activities, prof = traced(layer)
    cs.emit("moe_layer", tokens=args.tokens, capacity=capacity,
            device_ms=device_ms, device_activities=activities,
            top_by_device=top_ops(prof, "self_device_time_total"))
    del params, x

    model = LanguageModel(cfg, seed=0, device=dev)
    cache = model.new_cache(4, 2112)
    tokens = torch.randint(2, cfg.vocab_size, (4, 1), generator=g).to(dev)
    positions = torch.tensor([300, 700, 1200, 1800], device=dev)

    def step():
        model.decode_step(cache, tokens, positions)
    step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    device_ms, activities, prof = traced(step)
    cs.emit("decode_step", slots=4, wall_ms_median=statistics.median(walls),
            wall_ms=walls, device_ms=device_ms,
            device_activities=activities,
            top_by_device=top_ops(prof, "self_device_time_total"),
            top_by_host=top_ops(prof, "self_cpu_time_total"))
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
