#!/usr/bin/env python3
"""B4, B4's backward and B5 of this checkout against another tree's, in one process.

    python3 tools/compare_lm_kernels.py --baseline DIR [--rounds 2]

``DIR`` is the root of another tree of this repository, for example an
earlier commit unpacked by ``git archive <commit> | tar -x -C DIR``.  Each
tree's kernels are built by its own ``repro_torch.kernels._build`` (one
subprocess per tree, both at once), and both libraries are loaded with
``ctypes`` into this process.  Every case of ``chip_smoke.py``'s lm_kernels
phase (B4 ``repro_flash_attention``, B5 ``repro_ssd_chunk_dual``, bf16 and
f32) and every shape of its ``BWD_ATTN_CASES`` in both dtypes (B4's
backward ``repro_flash_attention_bwd``, at the forward's ``o`` and ``lse``
from this checkout) then runs, on the same seeded inputs, through both C
entry points:

- each output's max abs difference from this checkout's plain PyTorch
  version, and that over the output's largest magnitude, is printed
  beside ``chip_smoke.py``'s tolerance (reported, not enforced: a
  baseline may be a deliberately changed kernel); for the float32
  backward also whether both trees' gradients are bit-equal
  (``bits_equal_baseline``);
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

        def b4(lib, q=q, k=k, v=v, out=out, causal=causal, dtype=dtype,
               B=B, Hq=Hq, Hkv=Hkv, hd=hd):
            check(lib.repro_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None, B, Hq, Hkv, q.shape[2], k.shape[2], hd, v.shape[3],
                int(causal),
                DTYPE_CODES[dtype], fa.scale_for(hd, dtype), stream))
            return (out,)
        want = (lambda q=q, k=k, v=v, causal=causal:
                (fa.flash_attention_plain(q, k, v, causal=causal),))
        cases.append((dict(kernel="flash_attention", S=S, dtype=dtype_name,
                           causal=causal,
                           tolerance=cs.ATTN_TOL[dtype_name]), b4, want))
    for config, heads, B, S, Sk, causal, _ in cs.BWD_ATTN_CASES:
        Hq, Hkv, hd, hd_v = heads
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            q, k, v, do = (torch.randn(B, h, n, d, generator=g).to(dev, dtype)
                           for h, n, d in ((Hq, S, hd), (Hkv, Sk, hd),
                                           (Hkv, Sk, hd_v), (Hq, S, hd_v)))
            o, lse = fa._flash_attention_cuda(q, k, v, causal, None,
                                              with_lse=True)
            D = torch.empty(B, Hq, S, device=dev)
            grads = tuple(torch.empty_like(t) for t in (q, k, v))

            def b4_bwd(lib, q=q, k=k, v=v, o=o, lse=lse, do=do, D=D,
                       grads=grads, causal=causal, dtype=dtype, S=S, Sk=Sk,
                       B=B, Hq=Hq, Hkv=Hkv, hd=hd, hd_v=hd_v):
                check(lib.repro_flash_attention_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), D.data_ptr(),
                    *(t.data_ptr() for t in grads), B, Hq, Hkv, S, Sk, hd,
                    hd_v, int(causal), DTYPE_CODES[dtype],
                    fa.scale_for(hd, dtype), stream))
                return grads
            want = (lambda q=q, k=k, v=v, o=o, lse=lse, do=do, causal=causal:
                    fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                 causal=causal))
            cases.append((dict(kernel="flash_attention_bwd", config=config,
                               B=B, Hq=Hq, Hkv=Hkv, hd=hd, hd_v=hd_v, S=S,
                               Sk=Sk, causal=causal, dtype=dtype_name,
                               tolerance=cs.BWD_TOL[dtype_name]), b4_bwd,
                          want))
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
        want = (lambda xb=xb, cum=cum, Bm=Bm, Cm=Cm:
                sc.ssd_chunk_dual_plain(xb, cum, Bm, Cm))
        cases.append((dict(kernel="ssd_chunk_dual", BN=BN, c=c, H=H, P=P,
                           N=N, dtype=dtype_name,
                           tolerance=cs.SSD_TOL[dtype_name]), b5, want))

    for info, fn, want_fn in cases:
        rec = {name: {"max_abs_err": 0.0, "spin_ms": [], "events_ms": []}
               for name in libs}
        want, outs = want_fn(), {}
        for name, lib in libs.items():
            got = fn(lib)
            torch.cuda.synchronize()
            outs[name] = [a.clone() for a in got]
            errs = [(float((a.float() - b.float()).abs().max()),
                     float(b.float().abs().max())) for a, b in zip(got, want)]
            rec[name]["max_abs_err"] = max(err for err, _ in errs)
            rec[name]["rel_err"] = max(err / max(top, 1e-30)
                                       for err, top in errs)
        if info["kernel"] == "flash_attention_bwd" and \
                info["dtype"] == "float32":
            info["bits_equal_baseline"] = all(
                torch.equal(a, b)
                for a, b in zip(outs["baseline"], outs["this"]))
        del want, outs
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
