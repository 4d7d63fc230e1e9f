#!/usr/bin/env python3
"""B1 and B2 of this checkout against those of another tree, in one process.

    python3 tools/compare_relax_kernels.py --baseline DIR [--rounds 2]

``DIR`` is the root of another tree of this repository, for example an
earlier commit unpacked by ``git archive <commit> | tar -x -C DIR``.  Both
trees' kernels are built (``compare_lm_kernels.build_libraries``: one
subprocess per tree, both at once) and loaded with ``ctypes`` into this
process.  The inputs are the main path's own: on rmat20
(``rmat_graph(scale=20, edge_factor=8, weighted=True, seed=1)``,
highest-degree source) this checkout runs each ``sssp`` run of
``chip_smoke.PATH_LANES`` once to count its launches, then keeps one B1
(WD) or B2 (BS, HP, AD, EP, NS) launch of each stratum of a run's
launches, with dist as it stood, as
``chip_smoke.py``'s path_lanes phase keeps them
(``chip_smoke.path_calls``: strata by the power of 2 of the lanes and of
the valid lanes, each kept launch weighted by its stratum's size).  On
each kept launch, each tree runs its whole sequence of device operations
through its own C entry point:

- B2 ``relax_lanes`` (the proposal; the same sequence in both trees: fill
  the proposal, zero the mask, launch);
- B2 ``apply_relax``, what a BS column or HP tile runs: the baseline
  fills the proposal, zeroes a mask, launches, folds the proposal into
  dist (``torch.minimum``) and ORs the masks; this tree copies dist and
  launches into the copy and the running mask;
- B1 ``wd_relax_lanes`` (the proposal) and ``wd_relax``, what a WD
  iteration runs (baseline: fill, zero, launch, ``torch.minimum``; this
  tree: zero the new mask, copy dist, launch).

Every output of both trees must equal this checkout's plain PyTorch
version exactly (the script raises otherwise).  Each sequence is timed by
``chip_smoke.time_ms`` (device time: a spin kernel queued before each
start event) L2-cold (flushed before each call, as ``chip_smoke.py``'s
kernel table is) and warm (no flush: consecutive BS columns find dist in
L2), in the order baseline, this, this, baseline, ``--rounds`` times.
For each run and contract it prints one JSON line: per tree and timer,
the weighted mean over the kept launches of each launch's median (an
estimate of the mean over all of the run's launches), and their ratio.
Then the kernels alone on the path: each run is made again under
``torch.profiler`` with this checkout's strategies but every launch sent
to one tree's kernels (the same launches for both), in the same order of
trees, and one JSON line per run gives each tree's median B1 and B2
device microseconds a launch.  Last, the card's ``nvidia-smi`` name and power
limit.  The C entry points of both trees must have the signatures of
``_build._SIGNATURES``.  Needs a CUDA card and ``nvcc``; exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TREES = ("baseline", "this")
TIMERS = ("ms_cold", "ms_warm")


def path_launches(g, dev, strategies) -> dict:
    """strategy -> launches of B1/B2 in this checkout's ``sssp`` run on
    ``g``, and its MDT."""
    from repro_torch.algos import sssp
    from repro_torch.kernels.relax import LANES, LAUNCHES
    source = int(g.degrees.argmax())
    out = {}
    for strategy in strategies:
        for counts in (LAUNCHES, LANES):
            for key in counts:
                counts[key] = 0
        r = sssp(g, source, strategy=strategy, device=dev)
        out[strategy] = dict(
            launches={k: LAUNCHES[k] for k in LANES},
            mean_lanes={k: LANES[k] / LAUNCHES[k] for k in LANES
                        if LAUNCHES[k]},
            mdt=r.work_schedule.mdt)
    return out


def path_kernel_ms(g, dev, strategy: str, lib) -> dict:
    """B1's and B2's device milliseconds and launches in this checkout's
    ``sssp`` run on ``g``, by ``torch.profiler``, with every launch going
    to ``lib``'s kernels: the kernels alone, on the path's own launches."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.algos import sssp
    from repro_torch.kernels import _build
    source = int(g.degrees.argmax())
    own = _build.lib
    _build.lib = lambda: lib
    try:
        sssp(g, source, strategy=strategy, device=dev)      # warm-up
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sssp(g, source, strategy=strategy, device=dev)
            torch.cuda.synchronize()
    finally:
        _build.lib = own
    out = {}
    for kernel in ("wd_relax_lanes", "relax_lanes"):
        times = [e.device_time for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and re.search(rf"(^|[^a-z_]){kernel}_kernel", e.name)]
        out[f"{kernel}_ms"] = sum(times) / 1e3
        out[f"{kernel}_launches"] = len(times)
    return out


def per_launch(runs: list) -> dict:
    """Median over ``path_kernel_ms`` results of each kernel's device
    microseconds a launch and of its launches.  The profiler can drop
    events of a long run, so the time a launch is the statistic, and the
    launches show how many it saw."""
    out = {}
    for kernel in ("wd_relax_lanes", "relax_lanes"):
        seen = [r for r in runs if r[f"{kernel}_launches"]]
        if seen:
            out[f"{kernel}_us_per_launch"] = statistics.median(
                1e3 * r[f"{kernel}_ms"] / r[f"{kernel}_launches"]
                for r in seen)
            out[f"{kernel}_launches"] = statistics.median(
                r[f"{kernel}_launches"] for r in seen)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", required=True, type=Path,
                        help="root of the other tree")
    parser.add_argument("--rounds", type=int, default=2,
                        help="rounds of baseline, this, this, baseline")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_relax_kernels.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tools"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from compare_lm_kernels import build_libraries
    from repro_torch.core import operators
    from repro_torch.data import rmat_graph
    from repro_torch.kernels import relax

    libs = build_libraries({"baseline": args.baseline, "this": ROOT})
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > L2
    g = rmat_graph(scale=20, edge_factor=8, weighted=True, seed=1,
                   device=dev)
    strategies = [run[1] for _, run in cs.PATH_LANES]
    shapes = path_launches(g, dev, strategies)
    print(json.dumps({"path_shapes": shapes}), flush=True)
    op = operators.shortest_path
    msg, comb, _ = op.kernel_codes()

    def check(status: int) -> None:
        if status != 0:
            raise RuntimeError(f"CUDA launch failed ({status})")

    def new_mask(dist):
        return torch.zeros(dist.numel(), dtype=torch.bool, device=dev)

    def b2_launch(lib, dist, b, target, upd):
        imp = torch.empty(b["src"].numel(), dtype=torch.bool, device=dev)
        check(lib.repro_relax_lanes(
            dist.data_ptr(), dist.numel(), b["src"].data_ptr(),
            b["dst"].data_ptr(), b["w"].data_ptr(), b["valid"].data_ptr(),
            b["src"].numel(), msg,
            comb, target.data_ptr(), upd.data_ptr(), imp.data_ptr(), stream))
        return imp

    def b1_launch(lib, dist, a, target, upd):
        imp = torch.empty(a["cap_work"], dtype=torch.bool, device=dev)
        check(lib.repro_wd_relax_lanes(
            dist.data_ptr(), dist.numel(), a["prefix"].data_ptr(),
            a["exclusive"].data_ptr(), a["start"].data_ptr(),
            a["src_ids"].data_ptr(), a["prefix"].numel(), g.col.data_ptr(),
            g.wt.data_ptr(), g.num_edges, a["cap_work"], msg, comb,
            target.data_ptr(), upd.data_ptr(), imp.data_ptr(), stream))
        return imp

    def b2_cases(dist, b):
        """(contract, sequence, plain outputs) of one kept B2 call."""
        lane_args = (b["src"], b["dst"], b["w"], b["valid"])
        mask = new_mask(dist)                   # the running mask of BS and HP

        def proposal(name, lib):
            prop, upd = torch.full_like(dist, op.identity), new_mask(dist)
            return prop, upd, b2_launch(lib, dist, b, prop, upd)

        def apply(name, lib):
            if name == "baseline":
                prop, upd = torch.full_like(dist, op.identity), new_mask(dist)
                imp = b2_launch(lib, dist, b, prop, upd)
                return torch.minimum(dist, prop), mask | upd, imp
            target = dist.clone()
            return target, mask, b2_launch(lib, dist, b, target, mask)
        return [("relax_lanes", proposal,
                 relax.relax_lanes_plain(dist, *lane_args, op=op)),
                ("apply_relax", apply,
                 relax.apply_relax_plain(dist, new_mask(dist), *lane_args,
                                         op=op))]

    def b1_cases(dist, a):
        """(contract, sequence, plain outputs) of one kept B1 call."""
        wd_args = (a["prefix"], a["exclusive"], a["start"], a["src_ids"],
                   g.col, g.wt)
        cap = a["cap_work"]

        def proposal(name, lib):
            prop, upd = torch.full_like(dist, op.identity), new_mask(dist)
            return prop, upd, b1_launch(lib, dist, a, prop, upd)

        def wd_relax(name, lib):
            if name == "baseline":
                prop, upd = torch.full_like(dist, op.identity), new_mask(dist)
                imp = b1_launch(lib, dist, a, prop, upd)
                return torch.minimum(dist, prop), upd, imp
            upd, target = new_mask(dist), dist.clone()
            return target, upd, b1_launch(lib, dist, a, target, upd)
        return [("wd_relax_lanes", proposal,
                 relax.wd_relax_lanes_plain(dist, *wd_args, cap_work=cap,
                                            op=op)),
                ("wd_relax", wd_relax,
                 relax.wd_apply_relax_plain(dist, new_mask(dist), *wd_args,
                                            cap_work=cap, op=op))]

    def time_case(fn, want, info):
        """Each tree's medians of ``fn`` after checking its outputs."""
        for name, lib in libs.items():
            got = [t.clone() for t in fn(name, lib)]
            torch.cuda.synchronize()
            bad = [i for i, (x, y) in enumerate(zip(got, want))
                   if not torch.equal(x, y)]
            if bad:
                raise AssertionError(f"{name} != plain version in outputs "
                                     f"{bad}: {info}")
        rec = {name: {t: [] for t in TIMERS} for name in TREES}
        for _ in range(args.rounds):
            for name in ("baseline", "this", "this", "baseline"):
                lib = libs[name]
                for timer, fl in zip(TIMERS, (flush, None)):
                    rec[name][timer].append(cs.time_ms(
                        lambda: fn(name, lib), flush=fl))
        return {name: {t: statistics.median(v) for t, v in r.items()}
                for name, r in rec.items()}

    for kernel, run in cs.PATH_LANES:
        strategy = run[1]
        launched = shapes[strategy]["launches"][kernel]
        kept, valid = cs.path_calls(g, dev, run, kernel, launched)
        weights = [c["weight"] for c in kept]
        lanes = [c["src"].numel() if kernel == "relax_lanes"
                 else c["cap_work"] for c in kept]
        valid_kept = [int(c["valid"].sum()) if kernel == "relax_lanes"
                      else c["total"] for c in kept]

        def weighted(values, weights=weights):
            return sum(w * v for w, v in zip(weights, values)) / sum(weights)
        medians = {}
        for i, c in enumerate(kept):
            dist = c.pop("dist")
            cases = (b2_cases(dist, c) if kernel == "relax_lanes"
                     else b1_cases(dist, c))
            for contract, fn, want in cases:
                medians.setdefault(contract, []).append(time_case(
                    fn, want, dict(run="-".join(run), call=i,
                                   contract=contract)))
        del kept
        for contract, per_call in medians.items():
            mean = {name: {t: weighted([m[name][t] for m in per_call])
                           for t in TIMERS} for name in TREES}
            print(json.dumps({
                "kernel": kernel, "contract": contract,
                "run": "-".join(run), "launches_in_run": launched,
                "launches_timed": len(per_call),
                "mean_lanes": weighted(lanes),
                "mean_valid_lanes": weighted(valid_kept),
                "valid_lanes_per_launch": valid / launched,
                "equal_to_plain": True, "mean_of_medians": mean,
                "baseline_over_this": {
                    t: mean["baseline"][t] / mean["this"][t]
                    for t in TIMERS}}), flush=True)
    for strategy in strategies:
        device = {name: [] for name in TREES}
        for _ in range(args.rounds):
            for name in ("baseline", "this", "this", "baseline"):
                device[name].append(path_kernel_ms(g, dev, strategy,
                                                   libs[name]))
        print(json.dumps({
            "run": f"sssp-{strategy}", "kernels_alone_on_the_path": {
                name: per_launch(ds) for name, ds in device.items()},
            "runs": device}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
