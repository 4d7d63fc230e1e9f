#!/usr/bin/env python3
"""The stepped batches of this checkout against those of another tree, in
one call on one card.

    python3 tools/compare_batch_runs.py --baseline DIR [--rounds 2] [--reps 3]

``DIR`` is the root of another tree of this repository, for example an
earlier commit unpacked by ``git archive <commit> | tar -x -C DIR``.  Each
measurement is a subprocess that imports one tree's ``repro_torch`` (and
builds its kernels there at first use), builds rmat20
(``rmat_graph(scale=20, edge_factor=8, weighted=True, seed=1)``) and runs
the stepped sssp batches of ``chip_smoke.py``'s batch phase through
``engine.run_batch``: K = 8 and K = 32 sources by fig12's rule
(``BATCH_RUNS``).  For each: a warm-up; ``--reps`` calls timed by the host
clock around the whole call (ending in a sync); one call with CUDA events
around each launch of B1's batch contract (the tree's batch wrapper,
``relax.wd_apply_relax_union`` or ``relax.wd_apply_relax_batch``, each
after a ~1 ms spin, so the time is the card's); and one call traced by
``torch.profiler`` (device time by kernel name, the device's busy time
an iteration, the idle share of the traced call).  Then B3
(``find_offsets``) on rmat20's whole degree prefix (F = 2^20, 2^23
items), L2-cold, by CUDA events after a spin.  The trees take turns,
baseline, this, this, baseline, ``--rounds`` times; both trees'
``(dist, iterations, edges_relaxed)`` must agree (the script raises
otherwise).  It prints one JSON line per batch with each tree's medians
and their ratio, one per tree and batch with its last trace, then the
card's ``nvidia-smi`` name and power limit.  Needs a CUDA card and
``nvcc``; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TREES = ("baseline", "this")
#: the stepped batches: (K, sources skipped) of fig12's highest-degree rule
BATCH_RUNS = ((8, 0), (32, 8))

#: run in a subprocess with one tree's ``src`` and ``reps`` as arguments
MEASURE = r"""
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.core import engine
from repro_torch.data import rmat_graph
from repro_torch.kernels import relax
reps = int(sys.argv[2])
runs = json.loads(sys.argv[3])
dev = torch.device("cuda")
g = rmat_graph(scale=20, edge_factor=8, weighted=True, seed=1, device=dev)
order = g.degrees.cpu().numpy().argsort()[::-1]
wrapper = ("wd_apply_relax_union" if hasattr(relax, "wd_apply_relax_union")
           else "wd_apply_relax_batch")
real = getattr(relax, wrapper)
out = {}
for k, skip in runs:
    sources = order[skip:skip + k].astype("int32")
    call = lambda: engine.run_batch(g, sources, mode="stepped", device=dev)
    call()
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = call()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    events = []
    def timed(*args, **kw):
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = real(*args, **kw)
        end.record()
        events.append((start, end))
        return res
    setattr(relax, wrapper, timed)
    try:
        call()
    finally:
        setattr(relax, wrapper, real)
    torch.cuda.synchronize()
    launch_ms = [s.elapsed_time(e) for s, e in events]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    acts = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in acts:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0) + e.device_time
    busy = sum(e.device_time for e in acts) / 1e3
    out[f"stepped-{k}"] = dict(
        host_ms=host, launch_ms=launch_ms,
        batch_device_ms=[sum(launch_ms)], widest_launch_ms=[max(launch_ms)],
        iterations=r.iterations, edges_relaxed=r.edges_relaxed,
        dist_sha1=hashlib.sha1(r.dist.tobytes()).hexdigest(),
        trace=dict(activities=len(acts), device_ms=busy,
                   device_ms_an_iteration=busy / r.iterations,
                   traced_wall_ms=wall * 1e3,
                   idle_share=1.0 - busy / (wall * 1e3),
                   device_ms_by_name=dict(sorted(
                       ((name, t / 1e3) for name, t in by_name.items()),
                       key=lambda kv: -kv[1])[:12])))
# B3 on rmat20's whole degree prefix (F = 2^20, 2^23 items), L2-cold
from repro_torch.kernels import find_offsets as fo
prefix = torch.cumsum(g.degrees, 0, dtype=torch.int32)
flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
fo.find_offsets(prefix, 1 << 23)
events = []
for _ in range(10):
    flush.zero_()
    torch.cuda._sleep(2_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fo.find_offsets(prefix, 1 << 23)
    end.record()
    events.append((start, end))
torch.cuda.synchronize()
out["find_offsets"] = dict(device_ms=[s.elapsed_time(e) for s, e in events])
print(json.dumps(out))
"""


def measure(tree: Path, reps: int) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", MEASURE, str(tree / "src"), str(reps),
         json.dumps(BATCH_RUNS)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"measuring {tree} failed:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", required=True, type=Path,
                        help="root of the other tree")
    parser.add_argument("--rounds", type=int, default=2,
                        help="rounds of baseline, this, this, baseline")
    parser.add_argument("--reps", type=int, default=3,
                        help="host-timed batches a run in each turn")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_batch_runs.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    trees = {"baseline": args.baseline.resolve(), "this": ROOT}
    rec = {name: [] for name in TREES}
    for _ in range(args.rounds):
        for name in ("baseline", "this", "this", "baseline"):
            rec[name].append(measure(trees[name], args.reps))
    timers = ("host_ms", "batch_device_ms", "widest_launch_ms")
    for k, _ in BATCH_RUNS:
        key = f"stepped-{k}"
        facts = {(m[key]["iterations"], m[key]["edges_relaxed"],
                  m[key]["dist_sha1"]) for ms in rec.values() for m in ms}
        if len(facts) != 1:
            raise AssertionError(f"{key}: the trees disagree: {facts}")
        med = {name: {t: statistics.median(x for m in ms
                                           for x in m[key][t])
                      for t in timers}
               for name, ms in rec.items()}
        spread = {name: {t: (max(x for m in ms for x in m[key][t])
                             - min(x for m in ms for x in m[key][t]))
                         / med[name][t] for t in timers}
                  for name, ms in rec.items()}
        print(json.dumps({
            "run": key, "iterations": facts.pop()[0],
            "turns": len(rec["this"]), "reps": args.reps, "median": med,
            "spread": spread, "baseline_over_this": {
                t: med["baseline"][t] / med["this"][t] for t in timers}}),
            flush=True)
        for name, ms in rec.items():
            print(json.dumps({"run": key, "tree": name,
                              "launch_ms": ms[-1][key]["launch_ms"],
                              "trace": ms[-1][key]["trace"]}), flush=True)
    b3 = {name: statistics.median(x for m in ms
                                  for x in m["find_offsets"]["device_ms"])
          for name, ms in rec.items()}
    print(json.dumps({"run": "find_offsets", "f": 1 << 20,
                      "cap_work": 1 << 23, "median_device_ms": b3,
                      "baseline_over_this": b3["baseline"] / b3["this"]}),
          flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
