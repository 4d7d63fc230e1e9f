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
body, not the callable.

A float32 operator's header is compiled the same way with
``-ffp-contract=off`` (the host's stand-in for the card's ``__f*_rn``
intrinsics) and ``-fsanitize=float-cast-overflow`` besides, and held to
torch on random float32 values, the specials (±0, 2^30, NaN, ±inf,
subnormals), values whose ``v + w * c`` rounds differently from its FMA,
and random and extreme int32 weights: bit for bit, NaN for NaN (a NaN's
payload is the hardware's: x86 keeps an operand's, the card writes its
own), and, for the operators that take ``minimum``/``maximum`` of two
zeros (``ZERO_TIE``), a zero for a zero of either sign: torch's own
kernels return either zero of such a tie by the loop (scalar or vector)
that evaluates the element, and the lowered form returns IEEE 754-2019's
(−0.0 below +0.0)."""

import dataclasses
import itertools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import operators as tops
from repro_torch.core.graph import INF
from repro_torch.kernels import opgen
from repro_torch.kernels._build import CSRC

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


_F32 = tops.EdgeOp(name="f32", combine="min", identity=INF, source_value=0,
                   message=tops._sum_message, dtype=torch.float32)

#: what lowers and what still raises: float32 (a float header, MSG_CUSTOM
#: even for the built-in sum), the sub-word dtypes (a header of their own
#: value type, MSG_CUSTOM even for the built-in sum), float64 and int64
#: (lowered as float32 and int32, as the reference runs them: an int64 sum
#: keeps the built-in MSG_SUM, an int64 lambda takes MSG_CUSTOM); add with
#: a nonzero identity, int32 or float32, raises before any lowering, naming
#: the reference's fault
_CUSTOM_MIN = (tops.MSG_CUSTOM, tops.KERNEL_COMBINES["min"])
KERNEL_DTYPE_CASES = {
    "float32": (_F32, "#define REPRO_OP_FLOAT", (*_CUSTOM_MIN, torch.float32)),
    "float16": (dataclasses.replace(_F32, name="f16", dtype=torch.float16),
                "typedef repro_op_f16 repro_op_val;",
                (*_CUSTOM_MIN, torch.float16)),
    "bfloat16": (dataclasses.replace(_F32, name="bf16",
                                     dtype=torch.bfloat16),
                 "typedef repro_op_bf16 repro_op_val;",
                 (*_CUSTOM_MIN, torch.bfloat16)),
    "int16": (dataclasses.replace(_F32, name="i16", dtype=torch.int16,
                                  identity=32767),
              "typedef int16_t repro_op_val;", (*_CUSTOM_MIN, torch.int16)),
    "int8": (dataclasses.replace(_F32, name="i8", dtype=torch.int8,
                                 identity=127),
             "typedef int8_t repro_op_val;", (*_CUSTOM_MIN, torch.int8)),
    "uint8": (dataclasses.replace(_F32, name="u8", dtype=torch.uint8,
                                  identity=255),
              "typedef uint8_t repro_op_val;", (*_CUSTOM_MIN, torch.uint8)),
    "float64": (dataclasses.replace(_F32, name="f64", dtype=torch.float64),
                "#define REPRO_OP_FLOAT", (*_CUSTOM_MIN, torch.float32)),
    "int64_sum": (dataclasses.replace(_F32, name="i64s", dtype=torch.int64),
                  "int32_t repro_op_message(int32_t v, int32_t w)",
                  (tops.KERNEL_MESSAGES[tops._sum_message],
                   tops.KERNEL_COMBINES["min"], torch.int32)),
    "int64": (dataclasses.replace(_F32, name="i64", dtype=torch.int64,
                                  message=lambda v, w: v + w),
              "int32_t repro_op_message(int32_t v, int32_t w)",
              (*_CUSTOM_MIN, torch.int32)),
    "add1_int32": (_op("add1", "add", lambda v, w: v, identity=1), None,
                   None),
    "add1_float32": (dataclasses.replace(_F32, name="fadd1", combine="add",
                                         identity=1.0), None, None),
}


@pytest.mark.parametrize("case", list(KERNEL_DTYPE_CASES))
def test_non_int32_and_nonzero_add_identity_still_raise(case):
    """Every kernel value type lowers, to a header of its own value type,
    with the full ``(message, combine, value type)`` codes; only add with a
    nonzero identity still raises, naming the reference's fault (ROADMAP
    queue C, "The reference's faults")."""
    op, marker, codes = KERNEL_DTYPE_CASES[case]
    if marker is None:
        with pytest.raises(NotImplementedError,
                           match="nonzero identity.*reference's faults"):
            op.kernel_codes()
        with pytest.raises(NotImplementedError,
                           match="nonzero identity.*reference's faults"):
            opgen.lower(op)
        return
    assert op.kernel_codes() == codes
    assert marker in opgen.lower(op).header


# ---------------------------------------------------------------------------
# float32 operators
# ---------------------------------------------------------------------------

FLOAT_HARNESS = r"""
#include "op.h"
#include <stdio.h>
#include <stdlib.h>

int main(int argc, char** argv) {
  FILE* in = fopen(argv[1], "rb");
  FILE* out = fopen(argv[2], "wb");
  int32_t n = 0;
  if (!in || !out || fread(&n, 4, 1, in) != 1) return 2;
  float* v = (float*)malloc(4 * (size_t)n);
  int32_t* w = (int32_t*)malloc(4 * (size_t)n);
  float* u = (float*)malloc(4 * (size_t)n);
  if (fread(v, 4, n, in) != (size_t)n || fread(w, 4, n, in) != (size_t)n ||
      fread(u, 4, n, in) != (size_t)n)
    return 2;
  for (int32_t i = 0; i < n; ++i) {
    const float m = repro_op_message(v[i], w[i]);
    const uint8_t ok = repro_op_improves(v[i], u[i]) ? 1 : 0;
    fwrite(&m, 4, 1, out);
    fwrite(&ok, 1, 1, out);
  }
  fclose(out);
  return 0;
}
"""

F_SPECIALS = (0.0, -0.0, 2.0 ** 30, float("nan"), float("inf"),
              float("-inf"), 1e-45, -1e-45, 1e-40, -3e-39, 0.5, -1.0,
              0.97, 3.4e38)


def _fop(name, combine, message, update=None, identity=None):
    ident = {"min": float(INF), "max": 0.0, "add": 0.0}[combine]
    return tops.EdgeOp(name=name, combine=combine,
                       identity=ident if identity is None else identity,
                       source_value=0.0, message=message, update=update,
                       dtype=torch.float32)


#: float32 operators: the smoke's three, the built-in sum on float
#: values, and one operator per op family
FLOAT_SUPPORTED = {
    "scaled_sssp": _fop("scaled_sssp", "min", lambda v, w: v + w * 0.01),
    "sum_f": _fop("sum_f", "min", tops._sum_message),
    "max_product": _fop("max_product", "max",
                        lambda v, w: v * (w / (w + 1.0))),
    "damped": _fop("damped", "add", lambda v, w: v * 0.5),
    "arith": _fop("arith", "min",
                  lambda v, w: (v - w) * 1.5 / 3.0 + (-v) + abs(v - 2)
                  - torch.neg(v) / (w + 0.5) + torch.abs(w * 0.1)),
    "min_max_clamp": _fop(
        "min_max_clamp", "max",
        lambda v, w: torch.maximum(v, w * 0.5) - torch.minimum(v, w.float())
        + v.clamp(-10.5, 1e3) + torch.clamp_min(v, 0) + torch.clamp_max(
            v, 7) + torch.max(v, -v) + v.clamp(min=3.0, max=-3.0)),
    "floor_mod": _fop(
        "floor_mod", "min",
        lambda v, w: v // 2.5 + torch.div(v, 4, rounding_mode="floor")
        + v // -0.1 + torch.floor_divide(v, 1e-3) + w // 3.0),
    "where_compare": _fop(
        "where_compare", "min",
        lambda v, w: torch.where(v > w, v - w, v + w * 0.25),
        update=lambda cand, cur: ((cand < cur) & (cand == cand))
        | (cur > 1e30) | torch.logical_and(cand != cand, cur >= 0)),
    "conversions": _fop(
        "conversions", "min",
        lambda v, w: (v.to(torch.int32) // 3 + w).float()
        + v.bool().float() + (v > w).to(torch.float32)
        + torch.where(w.bool(), v, 2) + v.int().to(torch.float32)),
    "int_mix": _fop("int_mix", "max",
                    lambda v, w: v + (w // 3 - w % 5) * 2 + (w > 3)),
    "constants": _fop(
        "constants", "max",
        lambda v, w: v * 1e-45 + (v + 16777217) - 0.1 + (v + (-0.0))
        + torch.where(v > 0, float("inf"), -3e38)),
    "nan_update": _fop(
        "nan_update", "min", lambda v, w: v - w,
        update=lambda cand, cur: torch.logical_or(
            cand < cur, torch.logical_and(cand != cand, ~(cur != cur)))),
}

#: the operators whose results may be a tie of two zeros under
#: minimum/maximum (see the module docstring)
ZERO_TIE = {"min_max_clamp"}


def _float_inputs():
    """(v, w, u): random float32 values of every scale, the specials,
    v + w * 0.01 where it rounds apart from its FMA, and int32 weights."""
    rng = np.random.default_rng(29)
    n = 6000
    v = np.concatenate([
        rng.standard_normal(1500) * 10.0 ** rng.integers(-6, 9, 1500),
        rng.uniform(-2.0 ** 31, 2.0 ** 31, 500),
        rng.uniform(0, 200, 2000),
        rng.choice(F_SPECIALS, 2000)]).astype(np.float32)
    w = np.concatenate([
        rng.integers(INT_MIN, INT_MAX + 1, 1000, dtype=np.int64),
        rng.integers(-40, 41, 1500),
        rng.integers(1, 101, 3000),
        rng.choice(EXTREMES, 500)]).astype(np.int32)
    u = np.concatenate([v[::-1][:3000], rng.choice(F_SPECIALS, 3000)]
                       ).astype(np.float32)
    assert v.size == w.size == u.size == n
    rng.shuffle(u)
    return v, w, u


def _fma_differs(v, w, c):
    """Where v + w * c (two roundings in float32) differs from its FMA
    (one rounding of the exact value)."""
    wf = w.astype(np.float32).astype(np.float64)
    exact = v.astype(np.float64) + wf * np.float64(np.float32(c))
    two = (v + (w.astype(np.float32) * np.float32(c))).astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        one = exact.astype(np.float32)
    return np.isfinite(two) & (two != one)


def _run_float_harness(header: str, v, w, u, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the generated header")
    (tmp_path / "op.h").write_text(header)
    (tmp_path / "harness.cc").write_text(FLOAT_HARNESS)
    exe = tmp_path / "harness"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off",
         "-fsanitize=undefined,float-cast-overflow",
         "-fno-sanitize-recover=all", "-D__host__=", "-D__device__=",
         "-D__forceinline__=inline", f"-I{tmp_path}", "-o", str(exe),
         str(tmp_path / "harness.cc")],
        check=True, capture_output=True, text=True, timeout=120)
    (tmp_path / "in.bin").write_bytes(
        np.int32(v.size).tobytes() + v.tobytes() + w.tobytes()
        + u.tobytes())
    run = subprocess.run([str(exe), str(tmp_path / "in.bin"),
                          str(tmp_path / "out.bin")],
                         capture_output=True, text=True, timeout=60)
    assert run.returncode == 0, run.stderr
    rec = np.frombuffer((tmp_path / "out.bin").read_bytes(),
                        dtype=[("m", "<f4"), ("ok", "u1")])
    return rec["m"], rec["ok"].astype(bool)


def _same_floats(got, want, zero_tie: bool):
    """Bit for bit, NaN for NaN, and (``zero_tie``) a zero for a zero."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    g, t = got[~nan], want[~nan]
    same = g.view(np.int32) == t.view(np.int32)
    if zero_tie:
        same |= (g == 0) & (t == 0)
    bad = np.flatnonzero(~same)
    assert bad.size == 0, (g[bad[:5]], t[bad[:5]])


@pytest.mark.parametrize("name", list(FLOAT_SUPPORTED))
def test_lowered_float_operator_matches_torch(name, tmp_path):
    op = FLOAT_SUPPORTED[name]
    v, w, u = _float_inputs()
    header = opgen.lower(op).header
    assert "#define REPRO_OP_FLOAT" in header
    msg, ok = _run_float_harness(header, v, w, u, tmp_path)
    tv, tw, tu = (torch.from_numpy(x.copy()) for x in (v, w, u))
    want_msg = op.message(tv, tw)
    want_ok = op.improves(tv, tu)
    assert want_msg.dtype == torch.float32 and want_ok.dtype == torch.bool
    _same_floats(msg, want_msg.numpy(), name in ZERO_TIE)
    np.testing.assert_array_equal(ok, want_ok.numpy())


def test_float_inputs_separate_fma_from_two_roundings():
    """The inputs hold many pairs where ``v + w * 0.01`` and its FMA round
    apart, so the scaled SSSP's case above would see a contraction."""
    v, w, _ = _float_inputs()
    assert _fma_differs(v, w, 0.01).sum() >= 100


def test_float_header_rounds_each_operation():
    """The float header never leaves a float operator to the compiler:
    every ``+ - * /`` of a float node goes through ``repro_op_f*``, whose
    card branch is ``__f*_rn`` (never contracted into an FMA)."""
    header = opgen.lower(FLOAT_SUPPORTED["scaled_sssp"]).header
    body = header[header.index("repro_op_message("):]
    assert "repro_op_fmul(repro_op_i2f(w)" in body
    assert "repro_op_fadd(v, " in body
    for fn, intrinsic in (("fadd", "__fadd_rn"), ("fsub", "__fsub_rn"),
                          ("fmul", "__fmul_rn"), ("fdiv", "__fdiv_rn"),
                          ("i2f", "__int2float_rn")):
        at = header.index(f"float repro_op_{fn}(")
        assert intrinsic in header[at:at + 200]


#: (message, update, what the error must name) for float32 operators
FLOAT_UNSUPPORTED = {
    "float_shift": (lambda v, w: v << 2, None, "'lshift'"),
    "tensor_floordiv": (lambda v, w: v // w, None, "'floordiv'.*tensor"),
    "tensor_remainder": (lambda v, w: v % (w + 1.0), None, "'mod'.*tensor"),
    "zero_divisor": (lambda v, w: v // 0.0, None, "'floordiv'.*zero"),
    "reduction": (lambda v, w: v.sum() + w, None, "'sum_1'"),
    "indexing": (lambda v, w: v[0] + w, None, "'getitem'"),
    "float64": (lambda v, w: v.double() + w, None, "'double'"),
    "tensor_bound": (lambda v, w: v.clamp(min=w * 1.0), None,
                     "'clamp'.*Python constant"),
    "nan_bound": (lambda v, w: v.clamp(max=float("nan")), None,
                  "'clamp'.*NaN"),
    "trunc_div": (lambda v, w: torch.div(v, 2, rounding_mode="trunc"),
                  None, "'div'.*floor"),
    "exp": (lambda v, w: torch.exp(v), None, "'exp'"),
    "float_remainder": (lambda v, w: v % 3.0, None, "'mod'.*disagree"),
    "float_fmod": (lambda v, w: torch.fmod(v, 7), None, "'fmod'.*disagree"),
    "int_message": (lambda v, w: (v > 0).int() + w, None,
                    "'output'.*float32"),
    "float_update": (lambda v, w: v, lambda cand, cur: cand - cur,
                     "'output'.*bool"),
}


@pytest.mark.parametrize("name", list(FLOAT_UNSUPPORTED))
def test_unsupported_float_form_raises_naming_its_node(name):
    message, update, what = FLOAT_UNSUPPORTED[name]
    op = _fop(f"bad_{name}", "min", message, update=update)
    with pytest.raises(NotImplementedError,
                       match=f"bad_{name}.*{what}.*device='cpu'"):
        opgen.lower(op)


def test_float_and_int_headers_differ():
    """The value type is in the header, so in the digest: one body of int32
    and float32 values builds two libraries."""
    f = FLOAT_SUPPORTED["sum_f"]
    i = _op("sum_i", "min", lambda v, w: v + w)
    assert opgen.lower(f).digest != opgen.lower(i).digest
    assert "float repro_op_message(float v, int32_t w)" in \
        opgen.lower(f).header


# ---------------------------------------------------------------------------
# sub-word operators
# ---------------------------------------------------------------------------

SUBWORD_HARNESS = r"""
#include "op.h"
#include "values.cuh"
#include <stdio.h>
#include <stdlib.h>

int main(int argc, char** argv) {
  FILE* in = fopen(argv[1], "rb");
  FILE* out = fopen(argv[2], "wb");
  int32_t n = 0;
  if (!in || !out || fread(&n, 4, 1, in) != 1) return 2;
  const size_t vs = sizeof(repro_op_val);
  repro_op_val* v = (repro_op_val*)malloc(vs * (size_t)n);
  int32_t* w = (int32_t*)malloc(4 * (size_t)n);
  repro_op_val* u = (repro_op_val*)malloc(vs * (size_t)n);
  if (fread(v, vs, n, in) != (size_t)n || fread(w, 4, n, in) != (size_t)n ||
      fread(u, vs, n, in) != (size_t)n)
    return 2;
  for (int32_t i = 0; i < n; ++i) {
    const repro_op_msg m = repro_op_message(v[i], w[i]);
    const uint8_t ok = repro_op_improves(m, u[i]) ? 1 : 0;
    const repro_op_val nv = repro_op_narrow(m);
    const repro_op_val f = relax_lanes::fold_value<REPRO_OP_COMB>(u[i], nv);
    const int32_t b[2] = {
        relax_lanes::bucket_of<relax_lanes::COMB_MIN>(v[i], 4),
        relax_lanes::bucket_of<relax_lanes::COMB_MAX>(v[i], 4)};
    const uint8_t ne = relax_lanes::val_ne(v[i], u[i]) ? 1 : 0;
    fwrite(&m, sizeof m, 1, out);
    fwrite(&ok, 1, 1, out);
    fwrite(&nv, vs, 1, out);
    fwrite(&f, vs, 1, out);
    fwrite(b, 4, 2, out);
    fwrite(&ne, 1, 1, out);
  }
  fclose(out);
  return 0;
}
"""

BF16, F16 = torch.bfloat16, torch.float16


def _sop(name, combine, dtype, message, update=None):
    ident = {"min": 32767 if dtype == torch.int16 else 127
             if dtype == torch.int8 else 255 if dtype == torch.uint8
             else float("inf"), "max": 0, "add": 0}[combine]
    return tops.EdgeOp(name=name, combine=combine, identity=ident,
                       source_value=0, message=message, update=update,
                       dtype=dtype)


#: sub-word operators: the smoke's seven and one operator per op family
#: and type (promotion of a wider message, rounding, wrapping,
#: conversions, comparisons across types, an update predicate)
SUBWORD_SUPPORTED = {
    "bf16_sssp": _sop("bf16_sssp", "min", BF16, lambda v, w: v + w),
    "bf16_damped": _sop("bf16_damped", "add", BF16, lambda v, w: v * 0.5),
    "bf16_arith": _sop(
        "bf16_arith", "min", BF16,
        lambda v, w: (v - 2.5) * 0.5 + torch.abs(v) - (-v) / 4.0 + v // 2.0
        + torch.div(v, 0.75, rounding_mode="floor") + v * v),
    "bf16_conv": _sop(
        "bf16_conv", "max", BF16,
        lambda v, w: v.to(F16).to(BF16) + (v > 0).to(BF16) + w.to(BF16)
        + torch.where(v < w, v, w.to(BF16)) + v.float().to(BF16)),
    "f16_reliable": _sop("f16_reliable", "max", F16,
                         lambda v, w: v * (w / (w + 1.0))),
    "f16_minmax": _sop(
        "f16_minmax", "max", F16,
        lambda v, w: torch.maximum(v, (w * 0.5).to(F16))
        - torch.minimum(v, -v) + v.clamp(-10.5, 1000.0)
        + torch.clamp_min(v, 0.25)),
    "f16_where": _sop(
        "f16_where", "min", F16,
        lambda v, w: torch.where(v > w, v - w, v + 1.0),
        update=lambda cand, cur: (cand < cur) | (cand != cand)),
    "i16_sssp": _sop("i16_sssp", "min", torch.int16, lambda v, w: v + w),
    "i16_arith": _sop(
        "i16_arith", "min", torch.int16,
        lambda v, w: (v * 3 - v // -3 + v % 7 + ((v << 2) ^ (v >> 1))
                      + abs(v) - (-v) + torch.fmod(v, -5))),
    "i16_update": _sop("i16_update", "min", torch.int16,
                       lambda v, w: v + w,
                       update=lambda cand, cur: (cand + 2 < cur)
                       | (cur == 32767)),
    "i8_levels": _sop("i8_levels", "min", torch.int8, lambda v, w: v + 1),
    "i8_bits": _sop(
        "i8_bits", "max", torch.int8,
        lambda v, w: ((v & 0x3C) | (~v ^ 5)) + torch.where(w > 0, v, -v)
        + (v << 7) + (v >> 6)),
    "u8_widest": _sop("u8_widest", "max", torch.uint8,
                      lambda v, w: torch.minimum(
                          v, w.clamp(0, 255).to(torch.uint8))),
    "u8_count": _sop("u8_count", "add", torch.uint8, lambda v, w: v),
    "u8_mix": _sop("u8_mix", "min", torch.uint8,
                   lambda v, w: v * 2 + (w > 3) + v.to(torch.int32) // 5
                   + torch.maximum(v, v // 3)),
}

#: weights against every 8-bit value, and against every 16-bit pattern
WEIGHTS_8 = (INT_MIN, -129, -1, 0, 1, 2, 7, 100, 127, 128, 255, 256, 1000,
             32767, 32768, 65536, INF, INT_MAX)
WEIGHTS_16 = (0, 1, -5, 255, 1000, INT_MAX)


def _subword_inputs(dtype):
    """(v, w, u): every value of the type against the weights, and random
    values of the type as the current values."""
    rng = np.random.default_rng(30)
    bits = torch.iinfo(dtype).bits if not dtype.is_floating_point else 16
    every = torch.arange(1 << bits, dtype=torch.int32)
    every = (every.to(torch.uint8).view(dtype) if bits == 8 else
             every.to(torch.int16).view(dtype))
    weights = WEIGHTS_8 if bits == 8 else WEIGHTS_16
    v = every.repeat(len(weights))
    w = torch.tensor(weights, dtype=torch.int64).repeat_interleave(
        every.numel()).to(torch.int32)
    u = every[torch.from_numpy(rng.integers(0, every.numel(), v.numel()))]
    return v, w, u


def _raw(t: torch.Tensor) -> np.ndarray:
    if t.dtype in (BF16, F16):
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _run_subword_harness(header, v, w, u, want_msg, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the generated header")
    (tmp_path / "op.h").write_text(header)
    (tmp_path / "harness.cc").write_text(SUBWORD_HARNESS)
    exe = tmp_path / "harness"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off",
         "-fsanitize=undefined,float-cast-overflow",
         "-fno-sanitize-recover=all", "-D__host__=", "-D__device__=",
         "-D__forceinline__=inline", f"-I{tmp_path}", f"-I{CSRC}", "-o",
         str(exe), str(tmp_path / "harness.cc")],
        check=True, capture_output=True, text=True, timeout=120)
    (tmp_path / "in.bin").write_bytes(
        np.int32(v.numel()).tobytes() + _raw(v).tobytes()
        + w.numpy().tobytes() + _raw(u).tobytes())
    run = subprocess.run([str(exe), str(tmp_path / "in.bin"),
                          str(tmp_path / "out.bin")],
                         capture_output=True, text=True, timeout=60)
    assert run.returncode == 0, run.stderr
    vt = _raw(v).dtype
    mt = {torch.bfloat16: "<u2", torch.float16: "<u2"}.get(
        want_msg.dtype, _raw(want_msg[:1]).dtype.str)
    return np.frombuffer((tmp_path / "out.bin").read_bytes(), dtype=[
        ("m", mt), ("ok", "u1"), ("nv", vt), ("f", vt), ("b", "<i4", 2),
        ("ne", "u1")])


def _same_values(got_raw, want: torch.Tensor, zero_tie: bool = False):
    """Raw values of ``want``'s type bit for bit, NaN for NaN (a NaN's
    payload is the hardware's)."""
    if want.is_floating_point():
        got = torch.from_numpy(np.ascontiguousarray(got_raw).view(
            {torch.bfloat16: np.int16, torch.float16: np.int16,
             torch.float32: np.int32}[want.dtype])).view(want.dtype)
        nan = want.isnan()
        assert torch.equal(got.isnan(), nan)
        same = got[~nan].view(torch.int16 if want.element_size() == 2
                              else torch.int32) == want[~nan].view(
            torch.int16 if want.element_size() == 2 else torch.int32)
        if zero_tie:
            same |= (got[~nan] == 0) & (want[~nan] == 0)
        bad = (~same).nonzero().flatten()
        assert bad.numel() == 0, (got[~nan][bad[:5]], want[~nan][bad[:5]])
    else:
        np.testing.assert_array_equal(got_raw, want.numpy())


#: operators whose messages take minimum/maximum of two zeros
SUBWORD_ZERO_TIE = {"f16_minmax", "bf16_conv"}


@pytest.mark.parametrize("name", list(SUBWORD_SUPPORTED))
def test_lowered_subword_operator_matches_torch(name, tmp_path):
    """The sub-word header compiled by g++ against torch: every 8-bit
    value against a spread of int32 weights, or every 16-bit pattern
    against a few; the message (its own type, which may be wider than
    the values), the activation test against random current values, the
    narrowing to the value type, the fold of the narrowed candidate into
    the current value (``EdgeOp.scatter``), the delta-stepping bucket of
    the value at Δ = 4 both ways (``worklist.bucket_index``) and the
    value comparison."""
    from repro_torch.core import worklist
    op = SUBWORD_SUPPORTED[name]
    v, w, u = _subword_inputs(op.dtype)
    want_msg = op.message(v, w)
    rec = _run_subword_harness(opgen.lower(op).header, v, w, u, want_msg,
                               tmp_path)
    _same_values(rec["m"], want_msg, name in SUBWORD_ZERO_TIE)
    np.testing.assert_array_equal(rec["ok"].astype(bool),
                                  op.improves(want_msg, u).numpy())
    narrowed = want_msg.to(op.dtype)
    _same_values(rec["nv"], narrowed, name in SUBWORD_ZERO_TIE)
    folded = op.scatter(u.clone(), torch.arange(u.numel()), narrowed,
                        torch.ones(u.numel(), dtype=torch.bool))
    _same_values(rec["f"], folded, name in SUBWORD_ZERO_TIE)
    for k, descending in enumerate((False, True)):
        np.testing.assert_array_equal(
            rec["b"][:, k],
            worklist.bucket_index(v, 4, descending=descending).numpy())
    np.testing.assert_array_equal(rec["ne"].astype(bool), (v != u).numpy())


#: (dtype, message, what the error must name) for sub-word operators
SUBWORD_UNSUPPORTED = {
    "inexact_constant": (BF16, lambda v, w: v * 0.1,
                         "'mul'.*not a value of torch.bfloat16"),
    "narrow_constant": (torch.int8, lambda v, w: v + 300,
                        "'add'.*outside torch.int8"),
    "narrow_shift": (torch.int16, lambda v, w: v << 16,
                     "'lshift'.*outside \\[0, 15\\]"),
    "float_to_int8": (F16, lambda v, w: (v.to(torch.int8) + 1).to(F16),
                      "converts torch.float16 to torch.int8"),
    "half_fmod": (BF16, lambda v, w: torch.fmod(v, 3.0), "'fmod'.*disagree"),
    "narrower_message": (torch.int16, lambda v, w: (v + w).to(torch.int8),
                         "'output'.*torch.int16 \\(or a type"),
    "float_into_int": (torch.int16, lambda v, w: v * 0.5,
                       "narrowed to torch.int16.*converts torch.float32"),
    "float64": (BF16, lambda v, w: v.double() + w, "'double'"),
}


@pytest.mark.parametrize("name", list(SUBWORD_UNSUPPORTED))
def test_unsupported_subword_form_raises_naming_its_node(name):
    dtype, message, what = SUBWORD_UNSUPPORTED[name]
    op = _sop(f"bad_{name}", "min", dtype, message)
    with pytest.raises(NotImplementedError,
                       match=f"bad_{name}.*{what}.*device='cpu'"):
        opgen.lower(op)


def test_subword_headers_name_their_types():
    """The value type is in the header, so in the digest (one library an
    operator and value type); a wider message's type too, with the
    fold's narrowing."""
    sssp = {d: _sop("s", "min", d, lambda v, w: v + w)
            for d in (BF16, F16, torch.int16, torch.int8, torch.uint8)}
    digests = {opgen.lower(op).digest for op in sssp.values()}
    assert len(digests) == len(sssp)
    header = opgen.lower(sssp[torch.int16]).header
    assert "int32_t repro_op_message(int16_t v, int32_t w)" in header
    assert "typedef int32_t repro_op_msg;" in header
    assert "return repro_op_to_s((int32_t)m);" in header
    header = opgen.lower(SUBWORD_SUPPORTED["f16_reliable"]).header
    assert "typedef float repro_op_msg;" in header
    assert "return repro_op_f2h(m);" in header


VALUES_HARNESS = r"""
#include "op.h"
#include "values.cuh"
#include <stdio.h>
#include <stdlib.h>

int main(int argc, char** argv) {
  using namespace relax_lanes;
  FILE* in = fopen(argv[1], "rb");
  FILE* out = fopen(argv[2], "wb");
  int32_t n = 0;
  if (!in || !out || fread(&n, 4, 1, in) != 1) return 2;
  Val* v = (Val*)malloc(sizeof(Val) * (size_t)n);
  if (fread(v, sizeof(Val), n, in) != (size_t)n) return 2;
  for (int32_t i = 0; i < n; ++i) {
    const int32_t b[4] = {bucket_of<COMB_MIN>(v[i], 4),
                          bucket_of<COMB_MAX>(v[i], 4),
                          bucket_of<COMB_MIN>(v[i], 25),
                          bucket_of<COMB_MAX>(v[i], 25)};
    const uint8_t ne = val_ne(v[i], v[(i + 1) % n]) ? 1 : 0;
    fwrite(b, 4, 4, out);
    fwrite(&ne, 1, 1, out);
  }
  fclose(out);
  return 0;
}
"""


def _values_32(dtype):
    rng = np.random.default_rng(31)
    if dtype == torch.int32:
        v = np.concatenate([rng.integers(INT_MIN, INT_MAX + 1, 4096),
                            rng.integers(-60, 60, 1024), EXTREMES,
                            [INF - 1, INF - 4, INF - 25, INF + 1]])
        return torch.from_numpy(v.astype(np.int32))
    v = np.concatenate([rng.standard_normal(2048) * 1e3,
                        rng.uniform(0, 2.0 ** 31, 2048),
                        rng.uniform(-100, 100, 1024).round(), F_SPECIALS,
                        np.repeat(F_SPECIALS, 2)])
    return torch.from_numpy(v.astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32],
                         ids=["int32", "float32"])
def test_value_helpers_of_32_bit_builds_match_worklist(dtype, tmp_path):
    """``csrc/values.cuh`` with the base build's int32 values (no
    header) and a float32 operator's header, compiled by g++ against
    torch: the delta-stepping bucket at Δ = 4 and 25, both ways
    (``worklist.bucket_index``, float32 NaN to INT32_MIN), and the value
    comparison (the sub-word types are held in
    ``test_lowered_subword_operator_matches_torch``)."""
    from repro_torch.core import worklist
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/values.cuh")
    header = "" if dtype == torch.int32 else opgen.lower(_F32).header
    (tmp_path / "op.h").write_text(header)
    (tmp_path / "harness.cc").write_text(VALUES_HARNESS)
    exe = tmp_path / "harness"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off",
         "-fsanitize=undefined,float-cast-overflow",
         "-fno-sanitize-recover=all", "-D__host__=", "-D__device__=",
         "-D__forceinline__=inline", f"-I{tmp_path}", f"-I{CSRC}", "-o",
         str(exe), str(tmp_path / "harness.cc")],
        check=True, capture_output=True, text=True, timeout=120)
    v = _values_32(dtype)
    (tmp_path / "in.bin").write_bytes(np.int32(v.numel()).tobytes()
                                      + v.numpy().tobytes())
    run = subprocess.run([str(exe), str(tmp_path / "in.bin"),
                          str(tmp_path / "out.bin")],
                         capture_output=True, text=True, timeout=60)
    assert run.returncode == 0, run.stderr
    rec = np.frombuffer((tmp_path / "out.bin").read_bytes(),
                        dtype=[("b", "<i4", 4), ("ne", "u1")])
    for k, (delta, descending) in enumerate(
            ((4, False), (4, True), (25, False), (25, True))):
        np.testing.assert_array_equal(
            rec["b"][:, k],
            worklist.bucket_index(v, delta, descending=descending).numpy())
    np.testing.assert_array_equal(rec["ne"].astype(bool),
                                  (v != v.roll(-1)).numpy())
