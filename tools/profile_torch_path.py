#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one CUDA card.

    python3 tools/profile_torch_path.py [--mode stepped|fused]
                                        [--schedule bsp|delta]

``--schedule bsp`` (the default) runs ``sssp`` (WD, BS, HP, AD, EP, NS)
and ``bfs`` (WD) of ``repro_torch`` on ``rmat_graph(scale=20,
edge_factor=8, weighted=True, seed=1)``; ``--schedule delta`` runs
delta-stepping on the road network ``road_grid_graph(side=1024,
weighted=True, seed=4)``: ``sssp`` WD at the auto Δ (every edge light) and
WD, HP and AD at Δ = 25, and ``bfs`` WD (stepped: one launch of the fused
kernel's delta mode and one sync an epoch; fused: one launch a
traversal).  Each from the graph's highest-degree source, in the given
engine mode (``fused``: one launch of the fused fixed point a traversal),
each once untraced (wall time, MTEPS) and once under ``torch.profiler``.
For each run it prints one JSON line: traversal
seconds, the device time of all CUDA kernels in the trace, the device's
idle share of the traced traversal (1 - kernel time / wall time), the
launch count, and the kernels that took the most device time.  Needs a
CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
#: rmat20, the main path's graph
SCALE = 20
#: road1024 and the bucket width that makes three quarters of its edges
#: heavy (``--schedule delta``)
ROAD_SIDE = 1024
ROAD_DELTA = 25


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--mode", choices=("stepped", "fused"),
                        default="stepped")
    parser.add_argument("--schedule", choices=("bsp", "delta"),
                        default="bsp")
    args = parser.parse_args()
    mode, schedule = args.mode, args.schedule
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_path.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.algos import bfs, sssp
    from repro_torch.data import rmat_graph, road_grid_graph

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    if schedule == "bsp":
        g = rmat_graph(scale=SCALE, edge_factor=8, weighted=True, seed=1)
        graph = f"rmat{SCALE}"
        runs = [(algo, strategy, {}) for algo, strategy in (
            ("sssp", "WD"), ("sssp", "BS"), ("sssp", "HP"), ("sssp", "AD"),
            ("bfs", "WD"), ("sssp", "EP"), ("sssp", "NS"))]
    else:
        g = road_grid_graph(side=ROAD_SIDE, weighted=True, seed=4)
        graph = f"road{ROAD_SIDE}"
        runs = [("sssp", "WD", dict(schedule="delta"))] + [
            ("sssp", s, dict(schedule="delta", delta=ROAD_DELTA))
            for s in ("WD", "HP", "AD")] + [
            ("bfs", "WD", dict(schedule="delta"))]
    source = int(g.degrees.argmax())
    sssp(g, source, strategy="WD", mode=mode, **runs[0][2])     # warm-up
    for algo, strategy, kw in runs:
        fn = sssp if algo == "sssp" else bfs
        r = fn(g, source, strategy=strategy, mode=mode, **kw)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(g, source, strategy=strategy, mode=mode, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.device_time for e in kernels)
        by_name: dict = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(json.dumps({
            "graph": graph, "algo": algo, "strategy": strategy,
            "mode": mode, "schedule": schedule, "delta": r.delta,
            "iterations": r.iterations, "relax_rounds": r.relax_rounds,
            "edges_relaxed": r.edges_relaxed,
            "traversal_seconds": r.traversal_seconds, "mteps": r.mteps,
            "traced_wall_seconds": wall,
            "device_kernel_seconds": busy_us / 1e6,
            "device_idle_share": (1.0 - busy_us / 1e6 / wall) if wall else None,
            "cuda_kernel_launches": len(kernels),
            "top_kernels_ms": [[name[:60], t / 1e3] for name, t in top],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
