"""The lowering of user-defined operators to CUDA C++
(:mod:`repro_torch.kernels.opgen`) against torch, on the CPU.

Each supported operator's generated header is compiled by the host's
``g++`` into a small harness, with ``__host__``/``__device__`` defined
away and ``__forceinline__`` as ``inline`` (the same source nvcc takes on
the card), and under ``-fsanitize=undefined`` with no recovery, so that a
signed overflow in the generated code aborts the harness.  It evaluates
``message`` and the activation test on 4,096 random int32 pairs, 1,024
small ones and every pair of {INT_MIN, INT_MIN + 1, -1, 0, 1, INF,
INT_MAX}, and each result must equal the callable evaluated by torch on
the CPU bit for bit.  Every unsupported form raises
``NotImplementedError`` naming its fx node, and the digest follows the
body, not the callable."""

import itertools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import operators as tops
from repro_torch.core.graph import INF
from repro_torch.kernels import opgen

INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1
EXTREMES = (INT_MIN, INT_MIN + 1, -1, 0, 1, INF, INT_MAX)

HARNESS = r"""
#include "op.h"
#include <stdio.h>
#include <stdlib.h>

int main(int argc, char** argv) {
  FILE* in = fopen(argv[1], "rb");
  FILE* out = fopen(argv[2], "wb");
  int32_t n = 0;
  if (!in || !out || fread(&n, 4, 1, in) != 1) return 2;
  int32_t* a = (int32_t*)malloc(8 * (size_t)n);
  if (fread(a, 4, 2 * (size_t)n, in) != 2 * (size_t)n) return 2;
  for (int32_t i = 0; i < n; ++i) {
    const int32_t m = repro_op_message(a[i], a[n + i]);
    const uint8_t ok = repro_op_improves(a[i], a[n + i]) ? 1 : 0;
    fwrite(&m, 4, 1, out);
    fwrite(&ok, 1, 1, out);
  }
  fclose(out);
  return 0;
}
"""


def _op(name, combine, message, update=None, identity=None):
    ident = {"min": INF, "max": 0, "add": 0}[combine]
    return tops.EdgeOp(name=name, combine=combine,
                       identity=ident if identity is None else identity,
                       source_value=0, message=message, update=update)


def _penalty(T):
    return _op("penalty", "min",
               lambda v, w: torch.where(w > T, v + 2 * w, v + w))


#: the lowered operators: the built-in messages (a test operator's copy,
#: so that they are lowered and not mapped to their codes), the smoke's
#: three, the reference's longest-path DAG operator, and one operator per
#: op family
SUPPORTED = {
    "sum_copy": _op("sum_copy", "min", lambda v, w: v + w),
    "copy_copy": _op("copy_copy", "min", lambda v, w: v),
    "bottleneck_copy": _op("bottleneck_copy", "max",
                           lambda v, w: torch.minimum(v, w)),
    "reach_copy": _op("reach_copy", "add", lambda v, w: v),
    "slack": _op("slack", "min", lambda v, w: v + w,
                 update=lambda cand, cur: cand + 2 < cur),
    "penalty": _penalty(20),
    "budget": _op("budget", "max", lambda v, w: (v - w).clamp(min=0)),
    "longest_dag": _op("longest_dag", "max", tops._sum_message,
                       identity=-1),
    "floor_div_mod": _op(
        "floor_div_mod", "min",
        lambda v, w: (v // -3 + w % -7 + torch.div(v, 5, rounding_mode="floor")
                      + torch.remainder(w, -4) + torch.fmod(v, -6)
                      + v // -1 + w % 1 + torch.fmod(w, -1) + v // 1)),
    "shifts": _op("shifts", "max",
                  lambda v, w: (v << 3) ^ (w >> 5) + (v >> 31) - (w << 31)),
    "bitwise": _op("bitwise", "min",
                   lambda v, w: (v & w) | (~v ^ 0x5A5A) | torch.bitwise_and(
                       w, 1 << 20),
                   update=lambda cand, cur: ((cand < cur) & ~(cand == cur))
                   | ((cand ^ cur) < 0) ^ (cur == 0)),
    "abs_neg": _op("abs_neg", "max",
                   lambda v, w: abs(v) - (-w) + torch.abs(w).neg()
                   + (-v).abs()),
    "where_clamp": _op(
        "where_clamp", "min",
        lambda v, w: torch.where(v > w, v.clamp(-100, 100),
                                 torch.clamp_max(w, 7))
        + torch.clamp_min(v, -5) + torch.where(w < 0, 3, v)
        + torch.clamp(w, min=50, max=-50)),
    "logical_update": _op(
        "logical_update", "max", lambda v, w: v - w,
        update=lambda cand, cur: torch.logical_or(
            torch.logical_and(cand < cur, cand != 0),
            torch.logical_not(cur > -5)) ^ torch.logical_xor(cand > 0,
                                                             cur > 0)),
    "conversions": _op(
        "conversions", "min",
        lambda v, w: ((v > w).to(torch.int32) * 7 + v.bool().int()
                      + torch.where(w.to(torch.bool), v, w) + (v + (w < 0)))),
    "min_max_mul": _op(
        "min_max_mul", "max",
        lambda v, w: (torch.max(v, w) * 3 - torch.min(v, w) * w
                      + torch.maximum(v * w, -v))),
    "methods": _op("methods", "min",
                   lambda v, w: v.add(w).mul(2).sub(v.remainder(9))
                   .floor_divide(-2).maximum(w.minimum(v))),
}


def _pairs():
    rng = np.random.default_rng(2024)
    big = rng.integers(INT_MIN, INT_MAX + 1, (2, 4096), dtype=np.int64)
    small = rng.integers(-40, 41, (2, 1024), dtype=np.int64)
    ext = np.array(list(itertools.product(EXTREMES, EXTREMES))).T
    return np.concatenate([big, small, ext], axis=1).astype(np.int32)


def _run_harness(header: str, pairs: np.ndarray, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the generated header")
    (tmp_path / "op.h").write_text(header)
    (tmp_path / "harness.cc").write_text(HARNESS)
    exe = tmp_path / "harness"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-fsanitize=undefined",
         "-fno-sanitize-recover=all", "-D__host__=", "-D__device__=",
         "-D__forceinline__=inline", f"-I{tmp_path}", "-o", str(exe),
         str(tmp_path / "harness.cc")],
        check=True, capture_output=True, text=True, timeout=120)
    n = pairs.shape[1]
    (tmp_path / "in.bin").write_bytes(
        np.int32(n).tobytes() + np.ascontiguousarray(pairs).tobytes())
    run = subprocess.run([str(exe), str(tmp_path / "in.bin"),
                          str(tmp_path / "out.bin")],
                         capture_output=True, text=True, timeout=60)
    assert run.returncode == 0, run.stderr
    rec = np.frombuffer((tmp_path / "out.bin").read_bytes(),
                        dtype=[("m", "<i4"), ("ok", "u1")])
    return rec["m"], rec["ok"].astype(bool)


@pytest.mark.parametrize("name", list(SUPPORTED))
def test_lowered_operator_matches_torch(name, tmp_path):
    op = SUPPORTED[name]
    pairs = _pairs()
    msg, ok = _run_harness(opgen.lower(op).header, pairs, tmp_path)
    a, b = (torch.from_numpy(pairs[0].copy()), torch.from_numpy(
        pairs[1].copy()))
    want_msg = op.message(a, b)
    want_ok = op.improves(a, b)
    assert want_msg.dtype == torch.int32 and want_ok.dtype == torch.bool
    np.testing.assert_array_equal(msg, want_msg.numpy())
    np.testing.assert_array_equal(ok, want_ok.numpy())


def _closure_tensor(v, w):
    return v + torch.tensor(3, dtype=torch.int32)


def _control_flow(v, w):
    return v if (v > 0).any() else w


#: (message, update, what the error must name)
UNSUPPORTED = {
    "true_division": (lambda v, w: v / 2, None, "'truediv'"),
    "torch_div": (lambda v, w: torch.div(v, 2), None, "'div'"),
    "float_constant": (lambda v, w: v * 1.5, None, "'mul'.*float32"),
    "float_dtype": (lambda v, w: v.float().int() + w, None, "'float_1'"),
    "reduction": (lambda v, w: v.sum() + w, None, "'sum_1'"),
    "indexing": (lambda v, w: v[0] + w, None, "'getitem'"),
    "item": (lambda v, w: v + v.item(), None, "'item'"),
    "control_flow": (_control_flow, None, "TraceError"),
    "tensor_divisor": (lambda v, w: v // w, None, "'floordiv'.*tensor"),
    "tensor_modulus": (lambda v, w: v % w, None, "'mod'.*tensor"),
    "division_by_zero": (lambda v, w: v // 0, None, "'floordiv'.*zero"),
    "constant_range": (lambda v, w: v + 2 ** 31, None, "'add'.*outside"),
    "shift_range": (lambda v, w: v << 32, None, "'lshift'.*outside"),
    "tensor_shift": (lambda v, w: v >> w, None, "'rshift'.*tensor"),
    "int64_where": (lambda v, w: torch.where(v > w, 1, 2), None,
                    "'where'.*int64"),
    "tensor_closure": (_closure_tensor, None, "'_tensor_constant0'"),
    "bool_message": (lambda v, w: v > w, None, "'output'.*int32"),
    "int_update": (lambda v, w: v + w,
                   lambda cand, cur: (cand < cur).int(), "'output'.*bool"),
}


@pytest.mark.parametrize("name", list(UNSUPPORTED))
def test_unsupported_form_raises_naming_its_node(name):
    message, update, what = UNSUPPORTED[name]
    op = _op(f"bad_{name}", "min", message, update=update)
    with pytest.raises(NotImplementedError,
                       match=f"bad_{name}.*{what}.*device='cpu'"):
        opgen.lower(op)


def test_digest_follows_the_body():
    """Two lambdas of the same body lower to one header (one library);
    a changed closure constant changes the digest."""
    a, b = _penalty(20), _penalty(20)
    assert a.message is not b.message
    assert opgen.lower(a) == opgen.lower(b)
    assert opgen.lower(_penalty(21)).digest != opgen.lower(a).digest
    c = _op("other_name", "min", lambda v, w: v + w)
    assert opgen.lower(c).digest == opgen.lower(SUPPORTED["sum_copy"]).digest


def test_non_int32_and_nonzero_add_identity_still_raise():
    """What no kernel takes raises before any lowering, naming ROADMAP
    queue C."""
    f32 = tops.EdgeOp(name="f32", combine="min", identity=INF,
                      source_value=0, message=lambda v, w: v + w,
                      dtype=torch.float32)
    add1 = _op("add1", "add", lambda v, w: v, identity=1)
    for op in (f32, add1):
        with pytest.raises(NotImplementedError, match="queue C"):
            opgen.lower(op)
