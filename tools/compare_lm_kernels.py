#!/usr/bin/env python3
"""B4 and B5 of this checkout against those of another tree, in one process.

    python3 tools/compare_lm_kernels.py --baseline DIR [--rounds 2]

``DIR`` is the root of another tree of this repository, for example an
earlier commit unpacked by ``git archive <commit> | tar -x -C DIR``.  Each
tree's kernels are built by its own ``repro_torch.kernels._build`` (one
subprocess per tree, both at once), and both libraries are loaded with
``ctypes`` into this process.  Every case of ``chip_smoke.py``'s lm_kernels
phase (B4 ``repro_flash_attention``, B5 ``repro_ssd_chunk_dual``, bf16 and
f32, on the same seeded inputs) then runs through both C entry points:

- each output's max abs difference from this checkout's plain PyTorch
  version is printed beside ``chip_smoke.py``'s tolerance (reported, not
  enforced: a baseline may be a deliberately changed kernel);
- each kernel is timed by ``chip_smoke.time_ms`` with both of its timers,
  ``spin`` (a ~1 ms spin kernel queued before the start event: device
  time) and ``events`` (CUDA events around the call alone), in the order
  baseline, this, this, baseline, ``--rounds`` times.

Prints one JSON line per case, then the card's ``nvidia-smi`` name and
power limit.  Both trees' C entry points must have the signatures of
``_build._SIGNATURES``.  Needs a CUDA card and ``nvcc``; exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _build; print(_build.build())")


def build_libraries(trees: dict) -> dict:
    """name -> loaded library of each tree's kernels, built in parallel."""
    from repro_torch.kernels._build import _SIGNATURES
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", BUILD, str(Path(tree) / "src")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, tree in trees.items()}
    libs = {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build of {name} failed:\n{out}\n{err}")
        handle = ctypes.CDLL(out.strip().splitlines()[-1])
        for fn, argtypes in _SIGNATURES.items():
            if not hasattr(handle, fn):    # an older tree's entry points
                continue                   # lack the later kernels'
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
        libs[name] = handle
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", required=True, type=Path,
                        help="root of the other tree")
    parser.add_argument("--rounds", type=int, default=2,
                        help="rounds of baseline, this, this, baseline")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_lm_kernels.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels._build import DTYPE_CODES

    libs = build_libraries({"baseline": args.baseline, "this": ROOT})
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > L2
    g = torch.Generator().manual_seed(0)

    def check(status: int) -> None:
        if status != 0:
            raise RuntimeError(f"CUDA launch failed ({status})")

    cases = []
    for S, dtype_name, causal in cs.ATTN_TIMED:
        dtype = getattr(torch, dtype_name)
        q, k, v = cs.attention_inputs(S, dtype, g, dev)
        B, Hq, _, hd = q.shape
        Hkv = k.shape[1]
        out = torch.empty_like(q)

        def b4(lib, q=q, k=k, v=v, out=out, causal=causal, dtype=dtype):
            check(lib.repro_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None, B, Hq, Hkv, q.shape[2], k.shape[2], hd, v.shape[3],
                int(causal),
                DTYPE_CODES[dtype], fa.scale_for(hd, dtype), stream))
            return (out,)
        want = (fa.flash_attention_plain(q, k, v, causal=causal),)
        cases.append((dict(kernel="flash_attention", S=S, dtype=dtype_name,
                           causal=causal,
                           tolerance=cs.ATTN_TOL[dtype_name]), b4, want))
    BN, _, H, P, N = cs.SSD_SHAPE
    for c, dtype_name in cs.SSD_TIMED:
        dtype = getattr(torch, dtype_name)
        xb, cum, Bm, Cm = cs.ssd_inputs(c, dtype, g, dev)
        y = torch.empty(BN, c, H, P, device=dev)
        st = torch.empty(BN, H, N, P, device=dev)

        def b5(lib, xb=xb, cum=cum, Bm=Bm, Cm=Cm, y=y, st=st, c=c,
               dtype=dtype):
            check(lib.repro_ssd_chunk_dual(
                xb.data_ptr(), cum.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                y.data_ptr(), st.data_ptr(), BN, c, H, P, N,
                DTYPE_CODES[dtype], stream))
            return y, st
        want = sc.ssd_chunk_dual_plain(xb, cum, Bm, Cm)
        cases.append((dict(kernel="ssd_chunk_dual", BN=BN, c=c, H=H, P=P,
                           N=N, dtype=dtype_name,
                           tolerance=cs.SSD_TOL[dtype_name]), b5, want))

    for info, fn, want in cases:
        rec = {name: {"max_abs_err": 0.0, "spin_ms": [], "events_ms": []}
               for name in libs}
        for name, lib in libs.items():
            got = fn(lib)
            torch.cuda.synchronize()
            rec[name]["max_abs_err"] = max(
                float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want))
        for _ in range(args.rounds):
            for name in ("baseline", "this", "this", "baseline"):
                lib = libs[name]
                for timer, spin in (("spin_ms", True), ("events_ms", False)):
                    rec[name][timer].append(cs.time_ms(
                        lambda: fn(lib), flush=flush, spin=spin))
        for r in rec.values():
            r["spin_ms_median"] = statistics.median(r["spin_ms"])
            r["events_ms_median"] = statistics.median(r["events_ms"])
        print(json.dumps({**info, **rec, "baseline_over_this": {
            t: rec["baseline"][f"{t}_median"] / rec["this"][f"{t}_median"]
            for t in ("spin_ms", "events_ms")}}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
