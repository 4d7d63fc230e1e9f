"""Serving launcher: a continuous-batching decode loop over a seeded model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_0_6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_780m \\
        --smoke --device cpu --requests 6 --slots 2

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek_v3_671b --smoke --device cpu --shards 4 \\
        --override '{"serve_ep": true}'

The weights are random, made from ``--seed``.  ``--override`` is JSON of
config fields (``dataclasses.replace``), as the JAX launcher takes it;
``--shards S`` runs the MoE layers over a group of ``S`` shards held in
this process (``moe.sharded.use_group``), where the config's
``moe_impl="shard_map"`` or ``serve_ep`` picks the sharded dispatch.  The
JAX launcher's ``--dry-run``, ``--production``, ``--multi-pod`` and
``--shape`` need its device mesh and are not offered.  Vision and audio
configs are refused by ``ServeLoop``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import time

import numpy as np

from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.core.shard import shard_group
from repro_torch.models.model import LanguageModel
from repro_torch.moe.sharded import use_group
from repro_torch.runtime.serve import Request, ServeLoop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=ARCHITECTURES)
    ap.add_argument("--smoke", action="store_true",
                    help="the config's reduced CPU-scale variant")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--override", default=None,
                    help="JSON of config fields to replace")
    ap.add_argument("--shards", type=int, default=0,
                    help="run the MoE layers over this many held shards")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.override:
        cfg = dataclasses.replace(cfg, **json.loads(args.override))
    model = LanguageModel(cfg, seed=args.seed, device=args.device)
    loop = ServeLoop(model, num_slots=args.slots, max_len=args.max_len,
                     eos_id=0, device=args.device)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=i, prompt=rng.integers(
        2, cfg.vocab_size, 8 + i % 4).astype(np.int32),
        max_new_tokens=args.max_new) for i in range(args.requests)]
    group = (use_group(shard_group(args.shards, model.device))
             if args.shards else contextlib.nullcontext())
    t0 = time.perf_counter()
    with group:
        done = loop.run(reqs)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.generated) for r in done)
    print(f"{cfg.name} on {loop.device}: {len(done)} requests, {tokens} "
          f"tokens, {dt:.2f}s ({tokens / dt:.1f} tok/s); prefill "
          f"{statistics.median(loop.prefill_seconds) * 1e3:.2f} ms/request,"
          f" decode {statistics.median(loop.decode_seconds) * 1e3:.2f} "
          f"ms/step (medians)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
