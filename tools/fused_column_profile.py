#!/usr/bin/env python3
"""Where the fused kernel's BS-like chunks go, on one card.

    python3 tools/fused_column_profile.py [--out FILE] [--widths 0,256,512,1024]

Four measurements on rmat20 (``rmat_graph(scale=20, edge_factor=8,
weighted=True, seed=1)``) from its highest-degree source:

1. the grid barrier alone: ``chip_smoke.barrier_us`` (µs a barrier of
   the fused kernel's grid, ``barrier_probe`` line);
2. each of ``chip_smoke.PATH_RUNS`` as one fused launch against its
   stepped run: ``chip_smoke.fused_run_chunks`` (``fused_chunks`` lines:
   grid-wide and one-block chunks, grid barriers, device ms, bytes
   bound);
3. the plain loop (``core.fused._fixed_point_plain``, on the card's
   tensors) of the runs that take BS columns (BS, NS, AD), recording each
   BS step's frontier: the live count of column d is the number of slots
   of degree > d.  For each width C of ``WIDTHS``: the columns with at
   most C live slots, and those ``core.fused.bs_split`` puts inside one
   block;
4. with ``--widths``, the BS, NS and AD fused runs again at each tail
   width (``kernels.fused.TAIL_WIDTH``; 0: no column in one block), the
   widths in turns for ``--rounds`` rounds: chunks and the median device
   ms of each.

Prints one JSON line per measurement and the card's ``nvidia-smi`` name
and power limit; with ``--out``, writes every column's live count there
as JSON.  Needs a CUDA card and ``nvcc``; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the one-block widths weighed: 1 to 8 slots a thread of a 256-thread
#: block (the kernel takes at most 1,024)
WIDTHS = (256, 512, 1024, 2048)


def column_counts(g, algo: str, strategy: str, source: int, dev) -> list:
    """Every BS step of one plain-loop traversal: its columns' live counts
    (``[#(deg > d) for d < max degree]``) and, for each C of ``WIDTHS``,
    its one-block columns (``core.fused.bs_split``)."""
    import torch
    from repro_torch.core import fused, operators
    import chip_smoke as cs
    graph = g if algo == "sssp" else g.unweighted()
    args, kw = cs.fused_args(graph, strategy, source,
                             operators.shortest_path, dev)
    steps = []
    real = fused._bs_step

    def recording(gg, dist, mask, **kwargs):
        deg = fused._masked_degrees(gg, mask)
        hist = torch.bincount(deg[mask].long()).cpu()
        live = int(mask.sum()) - torch.cumsum(hist, 0)   # #(deg > d)
        steps.append((live[:int(deg.max())].tolist(),
                      {c: fused.bs_split(deg, c)[1] for c in WIDTHS}))
        return real(gg, dist, mask, **kwargs)

    fused._bs_step = recording
    try:
        fused._fixed_point_plain(*args, **kw)
    finally:
        fused._bs_step = real
    return steps


def summarize(steps: list) -> dict:
    """Columns by width: at most C live slots, and inside one block by the
    kernel's rule."""
    out = {"bs_steps": len(steps),
           "columns": sum(len(live) for live, _ in steps),
           "lanes": sum(sum(live) for live, _ in steps)}
    for c in WIDTHS:
        out[f"narrow_at_{c}"] = sum(sum(1 for x in live if x <= c)
                                    for live, _ in steps)
        out[f"block_at_{c}"] = sum(block[c] for _, block in steps)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--widths", default="",
                        help="comma-separated tail widths to time BS, NS "
                             "and AD at")
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fused_column_profile.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import operators
    from repro_torch.data import rmat_graph
    from repro_torch.kernels import fused as fused_kernel

    dev = torch.device("cuda")
    cs.emit("barrier_probe", us_a_barrier=cs.barrier_us(dev),
            barriers=cs.BARRIER_PROBE_K)
    g = rmat_graph(scale=20, edge_factor=8, weighted=True, seed=1,
                   device=dev)
    source = int(g.degrees.argmax())
    stepped = {key: cs.engine_run(g, *key, source, dev, "stepped")[0]
               for key in cs.PATH_RUNS}
    cs.fused_run_chunks(g, dev, stepped, source, reps=args.reps)

    columns = {}
    for algo, strategy in (("sssp", "BS"), ("sssp", "NS"), ("sssp", "AD")):
        steps = column_counts(g, algo, strategy, source, dev)
        columns[f"{algo}-{strategy}"] = [live for live, _ in steps]
        print(json.dumps({"plain_columns": f"{algo}-{strategy}",
                          **summarize(steps)}), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(columns))

    widths = [int(w) for w in args.widths.split(",") if w]
    default = fused_kernel.TAIL_WIDTH
    for strategy in ("BS", "NS", "AD") if widths else ():
        fargs, kw = cs.fused_args(g, strategy, source,
                                  operators.shortest_path, dev)
        ms = {w: [] for w in widths}
        chunks = {}
        try:
            for i in range(args.rounds):
                for w in widths if i % 2 == 0 else widths[::-1]:
                    fused_kernel.TAIL_WIDTH = w
                    chunks[w] = fused_kernel.fixed_point(*fargs, **kw)[4]
                    ms[w].append(cs.time_ms(
                        lambda: fused_kernel.fixed_point(*fargs, **kw),
                        reps=1))
        finally:
            fused_kernel.TAIL_WIDTH = default
        for w in widths:
            print(json.dumps({"tail_width": w, "run": f"sssp-{strategy}",
                              "device_ms": ms[w],
                              "median_ms": sorted(ms[w])[len(ms[w]) // 2],
                              "grid_chunks": chunks[w].grid,
                              "block_chunks": chunks[w].block,
                              "barriers": chunks[w].barriers}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
