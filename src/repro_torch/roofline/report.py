"""Render the dry-run and roofline tables from the dry-run JSON records
(the counterpart of :mod:`repro.roofline.report`).

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir experiments/dryrun_torch]

On the reference's records (``compile_s``, HLO counts) every table is the
reference's, string for string; on the port's (``trace_s``, counted over
meta tensors) the columns that name the count's source say so.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load_records(d: str) -> list[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def fmt_s(x) -> str:
    if x is None:
        return "—"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}µs"


def fmt_b(x) -> str:
    if x is None:
        return "—"
    for unit, div in (("TiB", 2**40), ("GiB", 2**30), ("MiB", 2**20)):
        if x >= div:
            return f"{x/div:.2f}{unit}"
    return f"{x:.0f}B"


def _traced(recs: list[dict]) -> bool:
    """Whether the records are the port's (a trace over meta tensors, not
    an XLA compile)."""
    return any("trace_s" in r for r in recs)


def dryrun_table(recs: list[dict]) -> str:
    traced = _traced(recs)
    key, src = ("trace_s", "") if traced else ("compile_s", "HLO ")
    rows = [f"| arch | shape | mesh | status | "
            f"{'trace' if traced else 'compile'} | {src}FLOPs/dev | "
            f"{src}bytes/dev | coll bytes/dev | mem/dev |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("status") == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"skip | — | — | — | — | — |")
            continue
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{r[key]}s | {r['per_device_flops']:.3e} | "
            f"{r['per_device_bytes']:.3e} | "
            f"{r['collective_bytes_per_device']:.3e} | "
            f"{fmt_b(r.get('bytes_per_device'))} |")
    return "\n".join(rows)


def roofline_table(recs: list[dict], mesh: str = "16x16") -> str:
    count = "FLOPs" if _traced(recs) else "HLO"
    rows = ["| arch | shape | compute | memory | collective | dominant | "
            f"useful (6N·D/{count}) | note |",
            "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if r.get("status") == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — "
                        f"| skipped: sub-quadratic-only shape |")
            continue
        rf = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rf['compute_s'])} | "
            f"{fmt_s(rf['memory_s'])} | {fmt_s(rf['collective_s'])} | "
            f"**{rf['dominant']}** | {rf['useful_ratio']:.2f} | |")
    return "\n".join(rows)


def summarize(recs):
    ok = [r for r in recs if r.get("status") == "ok"]
    skip = [r for r in recs if r.get("status") == "skipped"]
    doms = {}
    for r in ok:
        doms[r["roofline"]["dominant"]] = doms.get(
            r["roofline"]["dominant"], 0) + 1
    return {"ok": len(ok), "skipped": len(skip), "dominants": doms}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args()
    recs = load_records(args.dir)
    recs = [r for r in recs if "_opt" not in json.dumps(r.get("arch", ""))]
    print("## Dry-run records\n")
    print(dryrun_table(recs))
    print(f"\n## Roofline ({args.mesh})\n")
    print(roofline_table(recs, args.mesh))
    print("\n", summarize(recs))


if __name__ == "__main__":
    main()
