"""CLI: ``python -m repro_torch.analysis [paths...] [options]``.

Runs the analysis passes over the given paths (default: the
``src/repro_torch`` tree this file lives in), applies
``# repro: disable=`` suppressions, prints a pretty or JSON report, and
exits non-zero when any unsuppressed *error*-severity finding remains.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import (PASSES, apply_suppressions,
                                  render_json, render_pretty, run_all)


def default_root() -> Path:
    """The installed ``repro_torch`` package tree (…/src/repro_torch)."""
    return Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="contract checker + recompile-hazard linter of the "
                    "PyTorch/CUDA port")
    parser.add_argument(
        "paths", nargs="*", type=Path,
        help="files or directories to analyse (default: src/repro_torch)")
    parser.add_argument(
        "--passes", default=",".join(PASSES),
        help=f"comma-separated subset of {','.join(PASSES)}")
    parser.add_argument(
        "--format", choices=("pretty", "json"), default="pretty")
    parser.add_argument(
        "--output", type=Path, default=None,
        help="also write the JSON report to this file")
    parser.add_argument(
        "--no-suppress", action="store_true",
        help="ignore '# repro: disable=' comments (audit mode)")
    args = parser.parse_args(argv)

    paths = args.paths or [default_root()]
    for p in paths:
        if not p.exists():
            parser.error(f"no such path: {p}")
    passes = [p.strip() for p in args.passes.split(",") if p.strip()]
    for p in passes:
        if p not in PASSES:
            parser.error(f"unknown pass {p!r}; available: {list(PASSES)}")

    findings = run_all(paths, passes)
    if args.no_suppress:
        kept, suppressed = findings, 0
    else:
        kept, suppressed = apply_suppressions(findings)

    render = render_json if args.format == "json" else render_pretty
    report = render(kept, suppressed=suppressed, passes=passes)
    print(report)
    if args.output is not None:
        # the file is always JSON, whatever --format prints
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(
            render_json(kept, suppressed=suppressed, passes=passes) + "\n",
            encoding="utf-8")

    return 1 if any(f.severity == "error" for f in kept) else 0


if __name__ == "__main__":
    sys.exit(main())
