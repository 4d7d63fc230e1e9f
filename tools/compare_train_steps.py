#!/usr/bin/env python3
"""A training run of this checkout against another tree's, in turns.

    python3 tools/compare_train_steps.py --baseline DIR [--arch qwen3_0_6b] [--rounds 1]

``DIR`` is the root of another tree of this repository, for example an
earlier commit unpacked by ``git archive <commit> | tar -x -C DIR``.  Both
trees' kernels are built first (one subprocess per tree, both at once).
Then each run is one subprocess in a tree's root that imports that tree's
``chip_smoke`` and calls its ``train_phase`` on the card (``--arch`` at
full width in bf16 through the ``Trainer``: for qwen3_0_6b 8 steps of 4 x
2048 tokens, a checkpoint and the replay of steps 5-8), in the order
baseline, this, this, baseline, ``--rounds`` times, so that both trees
meet the same card and host.  Prints each run's ``train`` line (step ms,
steady step ms, tokens/s, peak memory, launches), one line per tree with
the median over its runs, and the card's ``nvidia-smi`` name and power
limit.  Needs a CUDA card and ``nvcc``; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ("import sys; sys.path.insert(0, 'src'); "
         "from repro_torch.kernels import _build; _build.build()")
RUN = ("import sys, torch; sys.path.insert(0, 'src'); sys.path.insert(0, "
       "'.'); import chip_smoke; "
       "chip_smoke.train_phase(torch.device('cuda'), sys.argv[1])")
FIELDS = ("arch", "step_ms", "steady_step_ms", "tokens_per_s",
          "peak_memory_gb", "launches", "ok")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", required=True, type=Path,
                        help="root of the other tree")
    parser.add_argument("--arch", default="qwen3_0_6b",
                        help="a config of chip_smoke.TRAIN_RUNS")
    parser.add_argument("--rounds", type=int, default=1,
                        help="rounds of baseline, this, this, baseline")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_train_steps.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    trees = {"baseline": args.baseline.resolve(), "this": ROOT}
    builds = {name: subprocess.Popen([sys.executable, "-c", BUILD],
                                     cwd=tree, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
              for name, tree in trees.items()}
    for name, proc in builds.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build of {name} failed:\n{out}\n{err}")
    runs = {name: [] for name in trees}
    for _ in range(args.rounds):
        for name in ("baseline", "this", "this", "baseline"):
            proc = subprocess.run([sys.executable, "-c", RUN, args.arch],
                                  cwd=trees[name], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"training run of {name} failed:\n"
                                   f"{proc.stdout[-4000:]}\n"
                                   f"{proc.stderr[-4000:]}")
            line = [text for text in proc.stdout.splitlines()
                    if text.startswith('{"phase": "train"')][-1]
            rec = json.loads(line)
            runs[name].append(rec)
            print(json.dumps({"tree": name, **{k: rec.get(k)
                                               for k in FIELDS}}),
                  flush=True)
    for name, recs in runs.items():
        print(json.dumps({
            "tree": name, "arch": args.arch, "runs": len(recs),
            "steady_step_ms_median": statistics.median(
                r["steady_step_ms"] for r in recs),
            "tokens_per_s_median": statistics.median(
                r["tokens_per_s"] for r in recs)}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
