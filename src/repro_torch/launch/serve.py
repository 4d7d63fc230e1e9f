"""Serving launcher: a continuous-batching decode loop over a seeded model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_0_6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_780m \\
        --smoke --device cpu --requests 6 --slots 2

The weights are random, made from ``--seed``.  The JAX launcher's
``--dry-run``, ``--production``, ``--multi-pod`` and ``--shape`` need its
device mesh and are not offered.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np

from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.models.model import LanguageModel
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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = LanguageModel(cfg, seed=args.seed, device=args.device)
    loop = ServeLoop(model, num_slots=args.slots, max_len=args.max_len,
                     eos_id=0, device=args.device)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=i, prompt=rng.integers(
        2, cfg.vocab_size, 8 + i % 4).astype(np.int32),
        max_new_tokens=args.max_new) for i in range(args.requests)]
    t0 = time.perf_counter()
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
