#!/usr/bin/env python3
"""The fused traversals of this checkout against those of another tree, in
one call on one card.

    python3 tools/compare_fused_runs.py --baseline DIR [--rounds 2] [--reps 5]
                                        [--schedule bsp|delta|batch]

``DIR`` is the root of another tree of this repository, for example an
earlier commit unpacked by ``git archive <commit> | tar -x -C DIR``.  Each
measurement is a subprocess that imports one tree's ``repro_torch`` (and
builds its kernels there at first use), builds rmat20
(``rmat_graph(scale=20, edge_factor=8, weighted=True, seed=1)``), and
from its highest-degree source runs each of ``chip_smoke.PATH_RUNS`` with
``mode="fused"`` through ``engine.run``: a warm-up, then ``--reps`` timed
runs, each timed by the host clock (``traversal_seconds``, ending in a
sync) and by CUDA events around the fused kernel's wrapper alone (device
time after a ~1 ms spin, as ``chip_smoke.time_ms``).  The trees take
turns, baseline, this, this, baseline, ``--rounds`` times; both trees'
``(dist, iterations, edges_relaxed)`` must agree (the script raises
otherwise).  It prints one JSON line per run with each tree's medians and
their ratio, then one with each tree's timed kernel as built (registers,
local bytes a thread, blocks a SM: ``costmodel.block_feasibility``), then
the card's ``nvidia-smi`` name and power limit.  With
``--schedule delta`` the runs are delta-stepping traversals of
``road_grid_graph(side=1024, weighted=True, seed=4)`` (``DELTA_RUNS``:
``(algo, strategy, delta)``, ``None`` the auto width), each timed around
the wrapper of the fused kernel's delta mode; the baseline tree must have
that mode, and the line also gives each tree's last launch's grid
barriers where its wrapper returns them (``Rounds``).  With
``--schedule batch`` the runs are fused sssp batches on rmat20 through
``engine.run_batch`` (``BATCH_RUNS``: K = 8 and K = 32 sources by
fig12's rule, as ``chip_smoke.py``'s batch phase takes them), the host
clock around the whole call and CUDA events around the fused kernel's
batch wrapper (``batch_fixed_point``, however many launches it makes).  Needs a CUDA
card and ``nvcc``; exits non-zero without a card.
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
#: the delta-stepping runs on road1024: auto Δ (every edge light) and
#: Δ = 25 (three quarters of the edges heavy)
DELTA_RUNS = (("sssp", "WD", None), ("sssp", "WD", 25), ("sssp", "NS", 25),
              ("bfs", "WD", None))
#: the batches: (K, sources skipped) of fig12's highest-degree rule
BATCH_RUNS = (("batch", 8, 0), ("batch", 32, 8))

#: run in a subprocess with one tree's ``src`` and ``reps`` as arguments
MEASURE = r"""
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.core import costmodel, engine
from repro_torch.core.strategies import make_strategy
from repro_torch.data import rmat_graph, road_grid_graph
from repro_torch.kernels import fused as fused_kernel
reps = int(sys.argv[2])
runs = json.loads(sys.argv[3])
delta_mode = sys.argv[4] == "delta"
batch_mode = sys.argv[4] == "batch"
dev = torch.device("cuda")
if delta_mode:
    g = road_grid_graph(side=1024, weighted=True, seed=4, device=dev)
    wrapper = "delta_fixed_point"
else:
    g = rmat_graph(scale=20, edge_factor=8, weighted=True, seed=1,
                   device=dev)
    wrapper = "batch_fixed_point" if batch_mode else "fixed_point"
source = int(g.degrees.argmax())
order = g.degrees.cpu().numpy().argsort()[::-1]
out = {}
real = getattr(fused_kernel, wrapper)
for algo, strategy, *rest in runs:
    kw = dict(schedule="delta", delta=rest[0]) if delta_mode else {}
    graph = g if algo in ("sssp", "batch") else g.unweighted()
    if batch_mode:
        sources = order[rest[0]:rest[0] + strategy].astype("int32")
        call = lambda: engine.run_batch(graph, sources, mode="fused",
                                        device=dev)
    else:
        call = lambda: engine.run(graph, source, make_strategy(strategy),
                                  mode="fused", device=dev, **kw)
    events, barriers = [], None
    def timed(*args, **kw):
        global barriers
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = real(*args, **kw)
        end.record()
        events.append((start, end))
        if delta_mode and len(res) > 7:     # a wrapper that returns Rounds
            barriers = res[7].barriers
        return res
    setattr(fused_kernel, wrapper, timed)
    try:
        call()
        events.clear()
        host = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = call()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3 if batch_mode
                        else r.traversal_seconds * 1e3)
    finally:
        setattr(fused_kernel, wrapper, real)
    torch.cuda.synchronize()
    out["-".join(str(x) for x in (algo, strategy, *rest))] = dict(
        host_ms=host, device_ms=[s.elapsed_time(e) for s, e in events],
        iterations=r.iterations, edges_relaxed=r.edges_relaxed,
        barriers=barriers,
        dist_sha1=hashlib.sha1(r.dist.tobytes()).hexdigest())
# the timed kernel's registers, local bytes and blocks a SM as built
out["kernel"] = costmodel.block_feasibility(dev)[
    "fused_delta" if delta_mode else "fused_fixed_point"]
print(json.dumps(out))
"""


def measure(tree: Path, reps: int, runs, schedule: str) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", MEASURE, str(tree / "src"), str(reps),
         json.dumps(runs), schedule], capture_output=True, text=True)
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
    parser.add_argument("--reps", type=int, default=5,
                        help="timed traversals a run in each turn")
    parser.add_argument("--schedule", choices=("bsp", "delta", "batch"),
                        default="bsp")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_fused_runs.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    trees = {"baseline": args.baseline.resolve(), "this": ROOT}
    runs = [list(run) for run in {"delta": DELTA_RUNS, "batch": BATCH_RUNS,
                                  "bsp": cs.PATH_RUNS}[args.schedule]]
    rec = {name: [] for name in TREES}
    for _ in range(args.rounds):
        for name in ("baseline", "this", "this", "baseline"):
            rec[name].append(measure(trees[name], args.reps, runs,
                                     args.schedule))
    for run in runs:
        key = "-".join(str(x) for x in run)
        facts = {(m[key]["iterations"], m[key]["edges_relaxed"],
                  m[key]["dist_sha1"]) for ms in rec.values() for m in ms}
        if len(facts) != 1:
            raise AssertionError(f"{key}: the trees disagree: {facts}")
        med = {name: {t: statistics.median(x for m in ms
                                           for x in m[key][t])
                      for t in ("host_ms", "device_ms")}
               for name, ms in rec.items()}
        spread = {name: {t: (max(x for m in ms for x in m[key][t])
                             - min(x for m in ms for x in m[key][t]))
                         / med[name][t] for t in ("host_ms", "device_ms")}
                  for name, ms in rec.items()}
        print(json.dumps({
            "run": key, "iterations": facts.pop()[0],
            "barriers": {name: ms[-1][key]["barriers"]
                         for name, ms in rec.items()},
            "turns": len(rec["this"]), "reps": args.reps, "median": med,
            "spread": spread, "baseline_over_this": {
                t: med["baseline"][t] / med["this"][t]
                for t in ("host_ms", "device_ms")}}), flush=True)
    print(json.dumps({"kernel": {name: ms[-1]["kernel"]
                                 for name, ms in rec.items()}}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
