"""Lower a user-defined :class:`~repro_torch.core.operators.EdgeOp` to CUDA
C++, so that the relax kernels (B1, B2, B1's batch contract) and the fused
fixed point evaluate it on the card.

The reference traces an operator's ``message`` and ``update`` into its
Pallas kernels and its fused ``lax.while_loop``.  A hand-written CUDA
kernel cannot call Python, so the port traces the same pure elementwise
callables with :func:`torch.fx.symbolic_trace`, gives every node its
dtype with :class:`~torch.fx.passes.shape_prop.ShapeProp` on samples of
the operator's value type (values of ``op.dtype``, int32 weights), and
emits one header of two functions, each ``__host__ __device__
__forceinline__``::

    V repro_op_message(V v, int32_t w);
    bool repro_op_improves(V cand, V cur);

with ``V`` the value type (``int32_t``; ``float`` for a float32
operator, whose header also defines ``REPRO_OP_FLOAT``), and the
combine's code (``REPRO_OP_COMB``).  A sub-word operator's header
(bfloat16, float16, int16, int8, uint8: ``REPRO_OP_SUBWORD``) names
``repro_op_val`` (a 16-bit float held as its bits) and the message's
own type ``repro_op_msg``, which may be wider (torch promotes int16 plus
an int32 weight to int32), and adds the candidate's narrowing to the
value type (``repro_op_narrow``, as ``.to(dist.dtype)``).  What depends
on the value type alone (the fold in that type, the value comparison,
the delta-stepping bucket) is ``csrc/values.cuh``'s, written once for
every value type.  ``kernels._build.custom_lib``
compiles ``csrc/relax.cu`` and ``csrc/fused.cu`` once more with it, for
that one operator (``MSG_CUSTOM`` in ``csrc/relax_lanes.cuh``).

Every supported node computes what torch computes on CPU tensors, bit for
bit on every input (docs/operators_torch.md).  On int32 and bool:
``+ - *`` and negation wrap (in ``uint32_t``), ``//`` rounds down and
``%`` takes the divisor's sign (only by a nonzero int constant;
``INT_MIN // -1`` wraps), ``fmod`` takes the dividend's, shifts take a
constant in [0, 31], ``abs(INT_MIN)`` is ``INT_MIN``, ``& | ^ ~`` work on
int32 and bool, and so do comparisons, ``minimum``/``maximum``,
``clamp``, ``where``, the logical ops and ``.to(int32 | bool)``.  A
float32 operator adds float32 nodes, promoted as torch promotes them: ``+
- * /`` each rounded once (``__fadd_rn`` and its kin on the card, so that
nvcc contracts nothing into an FMA), unary ``-``, ``abs``,
``minimum``/``maximum`` (NaN propagates; −0.0 ranks below +0.0),
``clamp`` by constants, ``where``, comparisons, ``//`` by a nonzero
constant (c10's ``div_floor_floating``; a float ``%`` or ``fmod`` raises:
torch's scalar and vector loops compute it differently),
``.float()``, ``.to(float32 | int32 | bool)`` (float to int32 truncates;
NaN and values outside int32 give ``INT_MIN``, as x86 does), and float
constants, emitted exactly as hex-float literals of their float32
value.  A sub-word operator's nodes may also be of its 16- and 8-bit
types, promoted as torch promotes them: 16-bit float operations compute
in float32 with one rounding and round to their type, to nearest even,
after every operation; integer ones compute in int32 and wrap at their
width; a constant must be a value of its node's type, a shift lie below
its width, and a float never converts to a sub-word integer.  Anything
else (another dtype, a reduction, indexing,
``.item()``, control flow on values, an integer division or a shift by a
tensor, an integer constant outside int32) raises
:class:`NotImplementedError` naming the operator and the fx node, before
anything is built: such an operator runs with ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import operator
import threading
from typing import Callable

import numpy as np
import torch
import torch.fx as fx
from torch.fx.passes.shape_prop import ShapeProp

from repro_torch.core.operators import EdgeOp

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1

#: helpers of every generated header: wrapping int32 arithmetic and the
#: rounding rules of torch's integer division, each defined for every
#: input the lowering lets reach it (the divisor is a constant other than
#: 0 and -1, the shift a constant in [0, 31])
PRELUDE = """\
#pragma once
#include <stdint.h>

#define REPRO_OP_FN __host__ __device__ __forceinline__
REPRO_OP_FN int32_t repro_op_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
REPRO_OP_FN int32_t repro_op_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
REPRO_OP_FN int32_t repro_op_mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
REPRO_OP_FN int32_t repro_op_neg(int32_t a) {
  return (int32_t)(0u - (uint32_t)a);
}
REPRO_OP_FN int32_t repro_op_abs(int32_t a) {
  return a < 0 ? repro_op_neg(a) : a;
}
REPRO_OP_FN int32_t repro_op_floordiv(int32_t a, int32_t c) {
  const int32_t q = a / c, r = a % c;
  return (r != 0 && ((r < 0) != (c < 0))) ? q - 1 : q;
}
REPRO_OP_FN int32_t repro_op_remainder(int32_t a, int32_t c) {
  const int32_t r = a % c;
  return (r != 0 && ((r < 0) != (c < 0))) ? r + c : r;
}
REPRO_OP_FN int32_t repro_op_shl(int32_t a, int32_t s) {
  return (int32_t)((uint32_t)a << s);
}
REPRO_OP_FN int32_t repro_op_min(int32_t a, int32_t b) {
  return a < b ? a : b;
}
REPRO_OP_FN int32_t repro_op_max(int32_t a, int32_t b) {
  return a > b ? a : b;
}
"""

#: helpers of a float32 operator's header: each operation rounded once
#: (the card's ``__f*_rn`` intrinsics, which nvcc never contracts into an
#: FMA; plain operators on the host, compiled with ``-ffp-contract=off``),
#: the conversions torch makes, and the rules of torch's float
#: ``minimum``, ``maximum``, ``clamp`` and ``//`` (c10's
#: ``div_floor_floating``)
FLOAT_PRELUDE = """\
#include <math.h>
#include <string.h>

REPRO_OP_FN float repro_op_fadd(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
REPRO_OP_FN float repro_op_fsub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
REPRO_OP_FN float repro_op_fmul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
REPRO_OP_FN float repro_op_fdiv(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}
REPRO_OP_FN float repro_op_i2f(int32_t a) {
#ifdef __CUDA_ARCH__
  return __int2float_rn(a);
#else
  return (float)a;
#endif
}
REPRO_OP_FN float repro_op_bits2f(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __int_as_float((int)u);
#else
  float a;
  memcpy(&a, &u, 4);
  return a;
#endif
}
REPRO_OP_FN bool repro_op_fsign(float a) {
#ifdef __CUDA_ARCH__
  return __float_as_int(a) < 0;
#else
  uint32_t u;
  memcpy(&u, &a, 4);
  return (u >> 31) != 0;
#endif
}
REPRO_OP_FN int32_t repro_op_f2i(float a) {
  return (a >= -2147483648.0f && a < 2147483648.0f) ? (int32_t)a
                                                    : (-2147483647 - 1);
}
REPRO_OP_FN float repro_op_fnan() { return repro_op_bits2f(0x7fc00000u); }
REPRO_OP_FN float repro_op_fminimum(float a, float b) {
  if (a != a || b != b) return repro_op_fnan();
  if (a == b) return repro_op_fsign(a) ? a : b;
  return a < b ? a : b;
}
REPRO_OP_FN float repro_op_fmaximum(float a, float b) {
  if (a != a || b != b) return repro_op_fnan();
  if (a == b) return repro_op_fsign(a) ? b : a;
  return a > b ? a : b;
}
REPRO_OP_FN float repro_op_fclamp_min(float a, float lo) {
  return a < lo ? lo : a;
}
REPRO_OP_FN float repro_op_fclamp_max(float a, float hi) {
  return a > hi ? hi : a;
}
REPRO_OP_FN float repro_op_ffloordiv(float a, float b) {
  const float mod = fmodf(a, b);
  float div = repro_op_fdiv(repro_op_fsub(a, mod), b);
  if (mod != 0.0f && (b < 0.0f) != (mod < 0.0f))
    div = repro_op_fsub(div, 1.0f);
  if (div == 0.0f) return copysignf(0.0f, repro_op_fdiv(a, b));
  float q = floorf(div);
  if (repro_op_fsub(div, q) > 0.5f) q = repro_op_fadd(q, 1.0f);
  return q;
}
"""


#: helpers of a sub-word operator's header: the narrowing of int32 to
#: int16, int8 and uint8 (modulo their width, as torch's ``.to`` wraps),
#: and each 16-bit float's storage type (its bits, ``uint16_t``) with its
#: conversions to and from float32, round-to-nearest-even, NaN and -0.0
#: kept as torch converts them (bfloat16: c10's ``round_to_nearest_even``,
#: whose NaN is 0x7fc0; float16: the FP16 library's
#: ``fp16_ieee_from_fp32_value``, whose NaN is 0x7e00 with the sign), in
#: integer arithmetic only, so that ``g++`` and ``nvcc`` compute the same
SUBWORD_PRELUDE = """\
#define REPRO_OP_SUBWORD 1
typedef uint16_t repro_op_bf16;
typedef uint16_t repro_op_f16;

REPRO_OP_FN int16_t repro_op_to_s(int32_t a) {
  const uint32_t u = (uint32_t)a & 0xffffu;
  return (int16_t)(u >= 0x8000u ? (int32_t)u - 0x10000 : (int32_t)u);
}
REPRO_OP_FN int8_t repro_op_to_c(int32_t a) {
  const uint32_t u = (uint32_t)a & 0xffu;
  return (int8_t)(u >= 0x80u ? (int32_t)u - 0x100 : (int32_t)u);
}
REPRO_OP_FN uint8_t repro_op_to_u(int32_t a) {
  return (uint8_t)((uint32_t)a & 0xffu);
}
REPRO_OP_FN uint32_t repro_op_f2bits(float a) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(a);
#else
  uint32_t u;
  memcpy(&u, &a, 4);
  return u;
#endif
}
REPRO_OP_FN float repro_op_bf2f(repro_op_bf16 h) {
  return repro_op_bits2f((uint32_t)h << 16);
}
REPRO_OP_FN repro_op_bf16 repro_op_f2bf(float a) {
  uint32_t u = repro_op_f2bits(a);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (repro_op_bf16)0x7fc0u;
  u += 0x7fffu + ((u >> 16) & 1u);
  return (repro_op_bf16)(u >> 16);
}
REPRO_OP_FN float repro_op_h2f(repro_op_f16 h) {
  const uint32_t sign = ((uint32_t)h & 0x8000u) << 16;
  uint32_t e = ((uint32_t)h >> 10) & 0x1fu, m = (uint32_t)h & 0x3ffu;
  if (e == 0x1fu)
    return repro_op_bits2f(sign | 0x7f800000u | (m ? 0x400000u : 0u) |
                           (m << 13));
  if (e == 0) {
    if (m == 0) return repro_op_bits2f(sign);
    e = 113;
    while (!(m & 0x400u)) {
      m <<= 1;
      --e;
    }
    return repro_op_bits2f(sign | (e << 23) | ((m & 0x3ffu) << 13));
  }
  return repro_op_bits2f(sign | ((e + 112) << 23) | (m << 13));
}
REPRO_OP_FN repro_op_f16 repro_op_f2h(float a) {
  const uint32_t u = repro_op_f2bits(a);
  const uint32_t sign = (u >> 16) & 0x8000u, x = u & 0x7fffffffu;
  if (x > 0x7f800000u) return (repro_op_f16)(sign | 0x7e00u);
  if (x >= 0x477ff000u) return (repro_op_f16)(sign | 0x7c00u);
  if (x >= 0x38800000u) {
    const uint32_t r = x - 0x38000000u;
    return (repro_op_f16)(sign | ((r + 0xfffu + ((r >> 13) & 1u)) >> 13));
  }
  if (x <= 0x33000000u) return (repro_op_f16)sign;
  const uint32_t m = (x & 0x7fffffu) | 0x800000u, sh = 126u - (x >> 23);
  uint32_t q = m >> sh;
  const uint32_t rem = m & ((1u << sh) - 1u), half = 1u << (sh - 1u);
  if (rem > half || (rem == half && (q & 1u))) ++q;
  return (repro_op_f16)(sign | q);
}
REPRO_OP_FN bool repro_op_bf_nan(repro_op_bf16 h) {
  return ((uint32_t)h & 0x7fffu) > 0x7f80u;
}
REPRO_OP_FN bool repro_op_h_nan(repro_op_f16 h) {
  return ((uint32_t)h & 0x7fffu) > 0x7c00u;
}
REPRO_OP_FN int32_t repro_op_key16(uint16_t h) {
  const int32_t s = (h & 0x8000u) ? (int32_t)h - 0x10000 : (int32_t)h;
  return s < 0 ? (s ^ 0x7fff) : s;
}
"""


@dataclasses.dataclass(frozen=True)
class Lowered:
    """An operator's generated header and its digest (SHA-256 of the
    header, 16 hex digits: two callables of the same body lower to the
    same header)."""
    header: str
    digest: str


class _Unsupported(Exception):
    """A node the lowering does not take; :func:`lower` names the
    operator around it."""

    def __init__(self, node: fx.Node, reason: str):
        # fx's interpreter may add lines to the exception on its way out;
        # the error names only this
        self.detail = reason if node is None else \
            f"node {node.name!r} ({_target_name(node)}): {reason}"
        super().__init__(self.detail)


def _target_name(node: fx.Node) -> str:
    t = node.target
    if node.op == "call_method":
        return f"Tensor.{t}"
    if node.op != "call_function":
        return f"{node.op} {t}"
    module = getattr(t, "__module__", None) or "torch"
    if module == "_operator":
        module = "operator"
    return f"{module}.{getattr(t, '__name__', repr(t))}"


# canonical op -> the fx targets that name it
_OPERATOR_FNS = {
    operator.add: "add", operator.sub: "sub", operator.mul: "mul",
    operator.floordiv: "floordiv", operator.mod: "remainder",
    operator.truediv: "div",
    operator.lshift: "lshift", operator.rshift: "rshift",
    operator.and_: "and", operator.or_: "or", operator.xor: "xor",
    operator.invert: "invert", operator.neg: "neg", operator.abs: "abs",
    operator.lt: "lt", operator.le: "le", operator.gt: "gt",
    operator.ge: "ge", operator.eq: "eq", operator.ne: "ne",
}
_TORCH_FNS = {
    torch.add: "add", torch.sub: "sub", torch.mul: "mul",
    torch.floor_divide: "floordiv", torch.div: "div",
    torch.true_divide: "div",
    torch.remainder: "remainder", torch.fmod: "fmod",
    torch.bitwise_and: "and", torch.bitwise_or: "or",
    torch.bitwise_xor: "xor", torch.bitwise_not: "invert",
    torch.neg: "neg", torch.abs: "abs",
    torch.minimum: "minimum", torch.maximum: "maximum",
    torch.min: "min2", torch.max: "max2",
    torch.clamp: "clamp",
    torch.clamp_min: "clamp_min", torch.clamp_max: "clamp_max",
    torch.where: "where",
    torch.lt: "lt", torch.le: "le", torch.gt: "gt", torch.ge: "ge",
    torch.eq: "eq", torch.ne: "ne",
    torch.logical_and: "logical_and", torch.logical_or: "logical_or",
    torch.logical_xor: "logical_xor", torch.logical_not: "logical_not",
}
_METHODS = {
    "add": "add", "sub": "sub", "mul": "mul", "floor_divide": "floordiv",
    "div": "div", "true_divide": "div", "remainder": "remainder",
    "fmod": "fmod",
    "bitwise_and": "and", "bitwise_or": "or", "bitwise_xor": "xor",
    "bitwise_not": "invert", "neg": "neg", "abs": "abs",
    "minimum": "minimum", "maximum": "maximum", "clamp": "clamp",
    "clamp_min": "clamp_min", "clamp_max": "clamp_max",
    "lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "eq": "eq", "ne": "ne",
    "logical_and": "logical_and", "logical_or": "logical_or",
    "logical_xor": "logical_xor", "logical_not": "logical_not",
    "to": "to", "int": "int", "bool": "bool", "float": "float",
}

# each canonical op's parameters, as torch names them (binding fx's
# positional and keyword arguments)
_PARAMS = {
    "add": ("input", "other"), "sub": ("input", "other"),
    "mul": ("input", "other"), "floordiv": ("input", "other"),
    "div": ("input", "other", "rounding_mode"),
    "remainder": ("input", "other"), "fmod": ("input", "other"),
    "lshift": ("input", "other"), "rshift": ("input", "other"),
    "and": ("input", "other"), "or": ("input", "other"),
    "xor": ("input", "other"), "invert": ("input",), "neg": ("input",),
    "abs": ("input",), "minimum": ("input", "other"),
    "maximum": ("input", "other"), "min2": ("input", "other"),
    "max2": ("input", "other"), "clamp": ("input", "min", "max"),
    "clamp_min": ("input", "min"), "clamp_max": ("input", "max"),
    "where": ("condition", "input", "other"),
    "lt": ("input", "other"), "le": ("input", "other"),
    "gt": ("input", "other"), "ge": ("input", "other"),
    "eq": ("input", "other"), "ne": ("input", "other"),
    "logical_and": ("input", "other"), "logical_or": ("input", "other"),
    "logical_xor": ("input", "other"), "logical_not": ("input",),
    "to": ("input", "dtype"), "int": ("input",), "bool": ("input",),
    "float": ("input",),
}

_COMPARE = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==",
            "ne": "!="}
_BITWISE = {"and": "&", "or": "|", "xor": "^"}
_LOGICAL = {"logical_and": "&&", "logical_or": "||", "logical_xor": "!="}
_WRAPPING = {"add": "repro_op_add", "sub": "repro_op_sub",
             "mul": "repro_op_mul"}
_ROUNDED = {"add": "repro_op_fadd", "sub": "repro_op_fsub",
            "mul": "repro_op_fmul", "div": "repro_op_fdiv"}
#: the C type of each node kind: int32, float32, bool, and a sub-word
#: operator's int16 ("s"), int8 ("c"), uint8 ("u"), bfloat16 ("bf") and
#: float16 ("h"), a 16-bit float held as its bits
_CTYPES = {"i": "int32_t", "f": "float", "b": "bool", "s": "int16_t",
           "c": "int8_t", "u": "uint8_t", "bf": "repro_op_bf16",
           "h": "repro_op_f16"}
_KINDS = {torch.int32: "i", torch.float32: "f", torch.bool: "b",
          torch.int16: "s", torch.int8: "c", torch.uint8: "u",
          torch.bfloat16: "bf", torch.float16: "h"}
_DTYPES = {k: d for d, k in _KINDS.items()}
#: the sub-word integer kinds, computed in int32 and narrowed
_NARROW = ("s", "c", "u")
#: the 16-bit float kinds, computed in float32 and rounded to the kind
_HALF = ("bf", "h")


def _canonical(node: fx.Node) -> str:
    if node.op == "call_function":
        name = _OPERATOR_FNS.get(node.target) or _TORCH_FNS.get(node.target)
    elif node.op == "call_method":
        name = _METHODS.get(node.target)
    elif node.op == "get_attr":
        raise _Unsupported(node, "a tensor constant (a closure over a "
                                 "tensor); close over Python ints instead")
    else:
        name = None
    if name is None:
        raise _Unsupported(node, "not an elementwise operation the "
                                 "lowering knows")
    return name


def _bind(node: fx.Node, name: str) -> dict:
    params = _PARAMS[name]
    if len(node.args) > len(params):
        raise _Unsupported(node, f"takes at most {len(params)} arguments")
    bound = dict(zip(params, node.args))
    for key, value in node.kwargs.items():
        if key not in params or key in bound:
            raise _Unsupported(node, f"argument {key!r} is not lowered")
        bound[key] = value
    return bound


#: ops whose second operand must be a Python constant
_CONSTANT_OTHER = {"floordiv": "the divisor", "div": "the divisor",
                   "remainder": "the divisor", "fmod": "the divisor",
                   "lshift": "the shift", "rshift": "the shift"}


def _check_operands(node: fx.Node, name: str, value: str) -> None:
    """Refuse, before any sample runs, a divisor or shift that is a
    tensor (the kernels divide and shift by constants only), and a zero
    divisor.  A float32 or sub-word operator's true division takes any
    divisor, with IEEE results."""
    bound = _bind(node, name)
    other = bound.get("other")
    if (name == "div" and value != "i"
            and bound.get("rounding_mode") is None):
        return
    if name in _CONSTANT_OTHER and isinstance(other, fx.Node):
        raise _Unsupported(node, f"{_CONSTANT_OTHER[name]} is a tensor; "
                                 f"only a Python constant is lowered")
    if _CONSTANT_OTHER.get(name) == "the divisor" and other == 0:
        raise _Unsupported(node, "divides by zero")


class _Prop(ShapeProp):
    """ShapeProp that raises :class:`_Unsupported` naming the node that
    fails on the samples (ShapeProp itself would print the traceback and
    raise a RuntimeError): each node first runs as a plain interpreter's
    would, and only a node that runs gets its meta."""

    def run_node(self, n):
        if n.op in ("placeholder", "output"):     # these consume the args
            return super().run_node(n)
        try:
            fx.Interpreter.run_node(self, n)
        except Exception as e:        # torch raises many kinds here
            first = (str(e).splitlines() or [""])[0]
            raise _Unsupported(n, f"fails on samples "
                                  f"({type(e).__name__}: {first})") from e
        return super().run_node(n)


def _propagate(gm: fx.GraphModule, kinds: tuple) -> None:
    """Every node's dtype on samples of the parameters' ``kinds``
    (``node.meta``); a node that fails on them raises
    :class:`_Unsupported`."""
    ints = torch.tensor([0, 1, -1, 7])
    floats = torch.tensor([0.0, 1.0, -1.0, 7.5])
    sample = {k: (floats if k in ("f",) + _HALF else ints).to(_DTYPES[k])
              for k in _KINDS.values() if k != "b"}
    _Prop(gm).propagate(sample[kinds[0]], sample[kinds[1]].flip(0))


def _float_literal(x) -> str:
    """``x`` as torch uses a Python scalar in a float32 operation: rounded
    to float32, written exactly (a hex-float literal)."""
    with np.errstate(over="ignore"):
        f = float(np.float32(x))
    if f != f:
        return "repro_op_fnan()"
    if f in (float("inf"), float("-inf")):
        return (f"repro_op_bits2f(0x{'7' if f > 0 else 'f'}f800000u)")
    return f"({f.hex()}f)"


def _exact_in(x, dtype: torch.dtype) -> bool:
    """Is the Python number ``x`` a value of ``dtype`` (NaN and ±inf
    included for a float type)?"""
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        return isinstance(x, int) and info.min <= x <= info.max
    y = float(torch.tensor(float(x), dtype=torch.float64).to(dtype))
    return y == x or (y != y and x != x)


@dataclasses.dataclass
class _Emitter:
    """C++ statements for one traced callable; every node becomes one
    ``const`` local of its dtype (``int32_t`` or ``bool``, and ``float``
    in a float32 operator: ``value`` ``"f"``; any kind of
    :data:`_CTYPES` in a sub-word operator)."""
    value: str = "i"
    lines: list = dataclasses.field(default_factory=list)
    names: dict = dataclasses.field(default_factory=dict)
    kinds: dict = dataclasses.field(default_factory=dict)

    @property
    def subword(self) -> bool:
        return self.value not in ("i", "f")

    def kind(self, node: fx.Node) -> str:
        meta = node.meta.get("tensor_meta")
        dtype = getattr(meta, "dtype", None)
        kind = _KINDS.get(dtype)
        if kind == "f" and self.value == "f" or kind in ("i", "b"):
            return kind
        if self.subword and kind is not None:
            return kind
        if self.subword:
            raise _Unsupported(node, f"gives {dtype or 'no tensor'}; a "
                                     f"sub-word operator's kernels evaluate "
                                     f"int32, float32, bool and its 16- and "
                                     f"8-bit types only")
        if self.value == "f":
            raise _Unsupported(node, f"gives {dtype or 'no tensor'}; a "
                                     f"float32 operator's kernels evaluate "
                                     f"float32, int32 and bool only")
        raise _Unsupported(node, f"gives {dtype or 'no tensor'}; the "
                                 f"kernels evaluate int32 and bool only")

    def convert(self, node: fx.Node, e: str, frm: str, to: str) -> str:
        """The expression ``e`` of kind ``frm`` as torch's ``.to`` converts
        it to kind ``to``: integers narrow modulo the width, a float
        rounds to nearest even, a float to int32 truncates."""
        if frm == to:
            return e
        if to == "b":
            if frm in _HALF:
                return f"(repro_op_{frm}2f({e}) != 0.0f)"
            return f"({e} != 0)"
        if to == "f":
            if frm == "b":
                return f"({e} ? 1.0f : 0.0f)"
            if frm in _HALF:
                return f"repro_op_{frm}2f({e})"
            return f"repro_op_i2f({e})"
        if to in _HALF:
            if frm in _HALF:
                return f"repro_op_f2{to}(repro_op_{frm}2f({e}))"
            return f"repro_op_f2{to}({self.convert(node, e, frm, 'f')})"
        if frm == "f" or frm in _HALF:
            if to != "i":
                raise _Unsupported(node, f"converts {_DTYPES[frm]} to "
                                         f"{_DTYPES[to]}; only a float to "
                                         f"int32 is lowered")
            return f"repro_op_f2i({self.convert(node, e, frm, 'f')})"
        if frm == "b" or to == "i":
            return f"({_CTYPES[to]}){e}"
        return f"repro_op_to_{to}((int32_t){e})"

    # an operand (a node or a Python constant) as an expression of kind
    # ``want``, converted as torch converts it
    def operand(self, node: fx.Node, x, want: str) -> str:
        if isinstance(x, fx.Node):
            return self.convert(node, self.names[x], self.kinds[x], want)
        if isinstance(x, bool):
            if want == "b":
                return "true" if x else "false"
            if want == "f":
                return "1.0f" if x else "0.0f"
            if want in _HALF:
                return f"repro_op_f2{want}({'1.0f' if x else '0.0f'})"
            return "1" if x else "0"
        if want in _HALF and isinstance(x, (int, float)):
            return f"repro_op_f2{want}({self.half_const(node, x, want)})"
        if want == "f" and isinstance(x, (int, float)):
            return _float_literal(x)
        if isinstance(x, int):
            if not INT32_MIN <= x <= INT32_MAX:
                raise _Unsupported(node, f"constant {x} lies outside int32")
            if want in _NARROW and not _exact_in(x, _DTYPES[want]):
                raise _Unsupported(node, f"constant {x} lies outside "
                                         f"{_DTYPES[want]}")
            if want == "b":
                return "true" if x else "false"
            return "(-2147483647 - 1)" if x == INT32_MIN else str(x)
        raise _Unsupported(node, f"operand {x!r} ({type(x).__name__}) is "
                                 f"not an int32 or bool tensor or constant")

    def const_int(self, node: fx.Node, x, what: str) -> int:
        if isinstance(x, fx.Node) or isinstance(x, bool) or \
                not isinstance(x, int):
            raise _Unsupported(node, f"{what} must be a Python int "
                                     f"constant, got {x!r}")
        self.operand(node, x, "i")            # range check
        return x

    def const_float(self, node: fx.Node, x, what: str) -> str:
        """A Python constant operand of a float32 node, not NaN."""
        if isinstance(x, fx.Node) or not isinstance(x, (int, float)):
            raise _Unsupported(node, f"{what} must be a Python constant, "
                                     f"got {x!r}")
        if x != x:
            raise _Unsupported(node, f"{what} is NaN")
        return self.operand(node, x, "f")

    def half_const(self, node: fx.Node, x, kind: str,
                   what: str = "a constant") -> str:
        """A Python constant of a 16-bit float node, as a float32 literal:
        it must be a value of the node's type (torch computes with the
        constant as float32, the reference rounds it to the type first;
        for such a constant both agree)."""
        if isinstance(x, fx.Node) or isinstance(x, bool) or \
                not isinstance(x, (int, float)):
            raise _Unsupported(node, f"{what} must be a Python constant, "
                                     f"got {x!r}")
        if not _exact_in(x, _DTYPES[kind]):
            raise _Unsupported(node, f"{what} {x!r} is not a value of "
                                     f"{_DTYPES[kind]}; torch and the "
                                     f"reference round it apart")
        return _float_literal(x)

    def half_operand(self, node: fx.Node, x, kind: str) -> str:
        """Operand ``x`` converted to the 16-bit float ``kind``, as a
        float32 expression (exact)."""
        if isinstance(x, fx.Node):
            return f"repro_op_{kind}2f({self.operand(node, x, kind)})"
        if isinstance(x, bool):
            return "1.0f" if x else "0.0f"
        return self.half_const(node, x, kind)

    def is_float(self, x) -> bool:
        """Does operand ``x`` make torch compute in float32?"""
        if isinstance(x, fx.Node):
            return self.kinds[x] == "f"
        return isinstance(x, float)

    def result_kind(self, xs) -> str:
        """The kind torch computes a comparison of ``xs`` in
        (``torch.result_type``)."""
        args = [torch.zeros(1, dtype=_DTYPES[self.kinds[x]])
                if isinstance(x, fx.Node) else x for x in xs]
        return _KINDS[torch.result_type(*args)]

    def float_expr(self, node: fx.Node, name: str, a: dict) -> str:
        """A float32 node's expression."""
        f = lambda x: self.operand(node, x, "f")          # noqa: E731
        if name == "div" and a.get("rounding_mode") is not None:
            if a["rounding_mode"] != "floor":
                raise _Unsupported(node, "only true division and "
                                         "rounding_mode='floor' are lowered")
            name = "floordiv"
        if name in _ROUNDED:
            return f"{_ROUNDED[name]}({f(a['input'])}, {f(a['other'])})"
        if name == "neg":
            return f"(-{f(a['input'])})"
        if name == "abs":
            return f"fabsf({f(a['input'])})"
        if name in ("remainder", "fmod"):
            # torch's vector loop computes a float fmod that its scalar
            # loop does not (3.4e38 % 0.75: NaN or 0.5, by the element's
            # place), so no lowering equals both
            raise _Unsupported(node, "a float remainder or fmod is not "
                                     "lowered: torch's scalar and vector "
                                     "loops disagree on it")
        if name == "floordiv":
            c = self.const_float(node, a["other"], "the divisor")
            return f"repro_op_ffloordiv({f(a['input'])}, {c})"
        if name in ("minimum", "maximum", "min2", "max2"):
            if not isinstance(a.get("other"), fx.Node):
                raise _Unsupported(node, "takes two tensors (a reduction "
                                         "or a scalar bound is not lowered)")
            fn = "repro_op_fminimum" if name in ("minimum", "min2") \
                else "repro_op_fmaximum"
            return f"{fn}({f(a['input'])}, {f(a['other'])})"
        if name in ("clamp", "clamp_min", "clamp_max"):
            out = f(a["input"])
            lo, hi = a.get("min"), a.get("max")
            if lo is None and hi is None:
                raise _Unsupported(node, "clamp without a bound")
            if lo is not None:
                out = (f"repro_op_fclamp_min({out}, "
                       f"{self.const_float(node, lo, 'a float bound')})")
            if hi is not None:
                out = (f"repro_op_fclamp_max({out}, "
                       f"{self.const_float(node, hi, 'a float bound')})")
            return out
        if name == "where":
            return (f"({self.operand(node, a['condition'], 'b')} ? "
                    f"{f(a['input'])} : {f(a['other'])})")
        if name in ("to", "float"):
            return f(a["input"])
        raise _Unsupported(node, "not lowered for float32 values")

    def half_expr(self, node: fx.Node, name: str, a: dict, k: str) -> str:
        """A 16-bit float node's expression: computed in float32, each
        operation rounded once, then rounded to the node's type, as
        torch's eager kernels compute it."""
        F = lambda x: self.half_operand(node, x, k)       # noqa: E731
        r = lambda e: f"repro_op_f2{k}({e})"              # noqa: E731
        if name == "div" and a.get("rounding_mode") is not None:
            if a["rounding_mode"] != "floor":
                raise _Unsupported(node, "only true division and "
                                         "rounding_mode='floor' are lowered")
            name = "floordiv"
        if name in _ROUNDED:
            return r(f"{_ROUNDED[name]}({F(a['input'])}, {F(a['other'])})")
        if name == "neg":
            return r(f"(-{F(a['input'])})")
        if name == "abs":
            return r(f"fabsf({F(a['input'])})")
        if name in ("remainder", "fmod"):
            raise _Unsupported(node, "a float remainder or fmod is not "
                                     "lowered: torch's scalar and vector "
                                     "loops disagree on it")
        if name == "floordiv":
            c = self.half_const(node, a["other"], k, "the divisor")
            return r(f"repro_op_ffloordiv({F(a['input'])}, {c})")
        if name in ("minimum", "maximum", "min2", "max2"):
            if not isinstance(a.get("other"), fx.Node):
                raise _Unsupported(node, "takes two tensors (a reduction "
                                         "or a scalar bound is not lowered)")
            fn = "repro_op_fminimum" if name in ("minimum", "min2") \
                else "repro_op_fmaximum"
            return r(f"{fn}({F(a['input'])}, {F(a['other'])})")
        if name in ("clamp", "clamp_min", "clamp_max"):
            out = F(a["input"])
            lo, hi = a.get("min"), a.get("max")
            if lo is None and hi is None:
                raise _Unsupported(node, "clamp without a bound")
            for bound, fn in ((lo, "min"), (hi, "max")):
                if bound is None:
                    continue
                if bound != bound:
                    raise _Unsupported(node, "a float bound is NaN")
                c = self.half_const(node, bound, k, "a float bound")
                out = f"repro_op_fclamp_{fn}({out}, {c})"
            return r(out)
        if name == "where":
            return (f"({self.operand(node, a['condition'], 'b')} ? "
                    f"{self.operand(node, a['input'], k)} : "
                    f"{self.operand(node, a['other'], k)})")
        raise _Unsupported(node, f"not lowered for {_DTYPES[k]} values")

    def expr(self, node: fx.Node, name: str, a: dict, kind: str) -> str:
        i = lambda x: self.operand(node, x, "i")          # noqa: E731
        b = lambda x: self.operand(node, x, "b")          # noqa: E731
        if name == "to":
            allowed = ((torch.int32, torch.bool, torch.float32)
                       if self.value == "f" else (torch.int32, torch.bool))
            if self.subword:
                allowed = tuple(_DTYPES.values())
            if a.get("dtype") not in allowed:
                raise _Unsupported(node, "only .to(" + " | ".join(
                    str(d) for d in allowed) + ") is lowered")
        if self.subword and name in ("to", "int", "bool", "float"):
            return self.operand(node, a["input"], kind)
        if kind in _HALF:
            return self.half_expr(node, name, a, kind)
        if kind == "f":
            return self.float_expr(node, name, a)
        if kind in _NARROW:
            # computed in int32 (wrapping), then narrowed
            for x in a.values():
                if not isinstance(x, (fx.Node, bool)) and \
                        isinstance(x, int):
                    self.operand(node, x, kind)   # a constant of the type
            if name in ("lshift", "rshift"):
                s = self.const_int(node, a["other"], "the shift")
                width = torch.iinfo(_DTYPES[kind]).bits
                if not 0 <= s < width:
                    raise _Unsupported(node, f"shift {s} lies outside "
                                             f"[0, {width - 1}]")
            return f"repro_op_to_{kind}({self.expr(node, name, a, 'i')})"
        if name in ("add", "sub", "mul", "neg", "abs", "floordiv", "div",
                    "remainder", "fmod", "lshift", "rshift", "minimum",
                    "maximum", "min2", "max2", "clamp", "clamp_min",
                    "clamp_max") and kind != "i":
            raise _Unsupported(node, "arithmetic that gives bool (torch's "
                                     "bool + bool) is not lowered")
        if name in _WRAPPING:
            return f"{_WRAPPING[name]}({i(a['input'])}, {i(a['other'])})"
        if name == "neg":
            return f"repro_op_neg({i(a['input'])})"
        if name == "abs":
            return f"repro_op_abs({i(a['input'])})"
        if name == "div":
            if a.get("rounding_mode") != "floor":
                raise _Unsupported(node, "only torch.div(..., "
                                         "rounding_mode='floor') is lowered")
            name = "floordiv"
        if name in ("floordiv", "remainder", "fmod"):
            c = self.const_int(node, a["other"], "the divisor")
            x = i(a["input"])
            if c in (1, -1):          # C's a / -1 overflows at INT_MIN
                if name == "floordiv":
                    return x if c == 1 else f"repro_op_neg({x})"
                return "0"
            if name == "fmod":
                return f"({x} % {c})"
            return f"repro_op_{name}({x}, {c})"
        if name in ("lshift", "rshift"):
            s = self.const_int(node, a["other"], "the shift")
            if not 0 <= s <= 31:
                raise _Unsupported(node, f"shift {s} lies outside [0, 31]")
            x = i(a["input"])
            return (f"repro_op_shl({x}, {s})" if name == "lshift"
                    else f"({x} >> {s})")
        if name in _BITWISE:
            op = _BITWISE[name]
            if kind == "b":
                return f"({b(a['input'])} {op} {b(a['other'])})"
            return f"({i(a['input'])} {op} {i(a['other'])})"
        if name == "invert":
            return (f"(!{b(a['input'])})" if kind == "b"
                    else f"(~{i(a['input'])})")
        if name in ("minimum", "maximum", "min2", "max2"):
            if not isinstance(a.get("other"), fx.Node):
                raise _Unsupported(node, "takes two tensors (a reduction "
                                         "or a scalar bound is not lowered)")
            fn = "repro_op_min" if name in ("minimum", "min2") \
                else "repro_op_max"
            return f"{fn}({i(a['input'])}, {i(a['other'])})"
        if name in ("clamp", "clamp_min", "clamp_max"):
            out = i(a["input"])
            lo, hi = a.get("min"), a.get("max")
            if lo is None and hi is None:
                raise _Unsupported(node, "clamp without a bound")
            if lo is not None:
                out = f"repro_op_max({out}, {i(lo)})"
            if hi is not None:
                out = f"repro_op_min({out}, {i(hi)})"
            return out
        if name == "where":
            pick = i if kind == "i" else b
            return (f"({b(a['condition'])} ? {pick(a['input'])} : "
                    f"{pick(a['other'])})")
        if name in _COMPARE:
            x, y = a["input"], a["other"]
            if self.subword:
                at = self.result_kind((x, y))
                if at in _HALF:
                    return (f"({self.half_operand(node, x, at)} "
                            f"{_COMPARE[name]} "
                            f"{self.half_operand(node, y, at)})")
                if at in _NARROW:     # constants of the type; exact in int32
                    for c in (x, y):
                        if not isinstance(c, fx.Node):
                            self.operand(node, c, at)
                    at = "i"
            else:
                at = "f" if self.is_float(x) or self.is_float(y) else "i"
            return (f"({self.operand(node, x, at)} {_COMPARE[name]} "
                    f"{self.operand(node, y, at)})")
        if name in _LOGICAL:
            return (f"({b(a['input'])} {_LOGICAL[name]} "
                    f"{b(a['other'])})")
        if name == "logical_not":
            return f"(!{b(a['input'])})"
        if name in ("to", "int", "bool"):
            return i(a["input"]) if kind == "i" else b(a["input"])
        raise _Unsupported(node, "not lowered")      # pragma: no cover

    def node(self, node: fx.Node) -> None:
        name = _canonical(node)
        args = _bind(node, name)
        kind = self.kind(node)
        var = f"t{len(self.lines)}"
        self.lines.append(f"  const {_CTYPES[kind]} {var} = "
                          f"{self.expr(node, name, args, kind)};")
        self.names[node], self.kinds[node] = var, kind


def _trace(fn: Callable) -> fx.GraphModule:
    """The fx graph of ``fn(a, b)``, traced from a root that calls it (so
    that a built-in torch function traces too)."""
    def root(a, b):
        return fn(a, b)
    return fx.symbolic_trace(root)


def _function(op: EdgeOp, what: str, fn: Callable, params: tuple,
              kinds: tuple, ret, value: str) -> tuple[str, str]:
    """One C++ function ``repro_op_<what>(params)`` of the traced ``fn``,
    whose parameters have ``kinds`` and which returns one of the kinds
    ``ret`` (``"i"``, ``"f"``, ``"b"``, ...); ``value`` is the operator's
    value kind.  Returns the function and the kind it returns."""
    dtype = _DTYPES[value]
    try:
        gm = _trace(fn)
    except Exception as e:   # fx raises TraceError, TypeError and others
        raise NotImplementedError(
            f"operator {op.name!r}: its {what} cannot be traced by "
            f"torch.fx ({type(e).__name__}: {e}); the CUDA kernels take "
            f"elementwise {str(dtype).removeprefix('torch.')} callables "
            f"without data-dependent control flow, so run it with "
            f"device='cpu'") from e
    nodes = list(gm.graph.nodes)
    em = _Emitter(value=value)
    try:
        for node in nodes:
            if node.op not in ("placeholder", "output"):
                _check_operands(node, _canonical(node), value)
        _propagate(gm, kinds)
        inputs = iter(zip(params, kinds))
        for node in nodes:
            if node.op == "placeholder":
                em.names[node], em.kinds[node] = next(inputs)
            elif node.op == "output":
                out = node.args[0]
                if not isinstance(out, fx.Node) or em.kinds.get(out) \
                        not in ret:
                    names = {'i': 'int32', 'f': 'float32', 'b': 'bool'}
                    want = names.get(ret[0]) if len(ret) == 1 else (
                        f"{dtype} (or a type it promotes to)")
                    raise _Unsupported(
                        node, f"the {what} must return one "
                              f"{want or _DTYPES[ret[0]]} tensor")
                em.lines.append(f"  return {em.names[out]};")
                out_kind = em.kinds[out]
            else:
                em.node(node)
    except _Unsupported as e:
        raise NotImplementedError(
            f"operator {op.name!r}: its {what} cannot be lowered to CUDA: "
            f"{e.detail}; run it with device='cpu'") from None
    body = "\n".join(em.lines)
    args = ", ".join(f"{_CTYPES[k]} {p}" for p, k in zip(params, kinds))
    return (f"REPRO_OP_FN {_CTYPES[out_kind]} repro_op_{what}({args}) "
            f"{{\n{body}\n}}\n"), out_kind


#: the combine's activation test, as :meth:`EdgeOp.improves` has it,
#: traced for an operator without an ``update`` (a sub-word operator's
#: candidate may be wider than its values, and its 16-bit floats compare
#: as floats, not as their bits)
_DEFAULT_UPDATES = {"min": lambda cand, cur: cand < cur,
                    "max": lambda cand, cur: cand > cur,
                    "add": lambda cand, cur: cand != 0}


def _widens(value: str) -> tuple:
    """The kinds a sub-word operator's message may return: its value type
    and each type torch promotes it to (the fold narrows the candidate as
    ``.to(dist.dtype)`` does)."""
    v = _DTYPES[value]
    return tuple(k for k, d in _DTYPES.items()
                 if k != "b" and torch.promote_types(v, d) == d)


def _narrow(value: str, msg: str) -> str:
    """The sub-word header's narrowing of the message's kind ``msg`` to
    the value kind ``value``, as ``.to(dist.dtype)`` narrows it."""
    narrow = _Emitter(value=value).convert(None, "m", msg, value)
    return (f"REPRO_OP_FN repro_op_val repro_op_narrow(repro_op_msg m) {{\n"
            f"  return {narrow};\n}}\n")


#: fx's symbolic tracing patches module-level functions while it runs, so
#: two threads (builds of several operators at once) trace one at a time
_TRACE_LOCK = threading.Lock()


def lower(op: EdgeOp) -> Lowered:
    """The C++ header of ``op``'s ``message`` and activation test (its
    ``update``, or the combine's default as :meth:`EdgeOp.improves` has
    it), for its value type (:func:`~repro_torch.core.operators.value_dtype`).
    Raises
    :class:`NotImplementedError` for an operator the kernels cannot take:
    another ``dtype``, ``add`` with a nonzero identity (both from
    :meth:`EdgeOp.kernel_codes`), or a callable outside the lowered op
    set.  Safe to call from several threads."""
    with _TRACE_LOCK:
        return _lower(op)


def _lower(op: EdgeOp) -> Lowered:
    _, comb, dtype = op.kernel_codes()
    v = _KINDS[dtype]
    subword = v not in ("i", "f")
    message, m = _function(op, "message", op.message, ("v", "w"), (v, "i"),
                           _widens(v) if subword else (v,), v)
    improves, _ = _function(op, "improves",
                            op.update or _DEFAULT_UPDATES[op.combine],
                            ("cand", "cur"), (m, v), ("b",), v)
    parts = [PRELUDE]
    if v != "i":
        parts.append(FLOAT_PRELUDE)
    if v == "f":
        parts.append("#define REPRO_OP_FLOAT 1\n")
    parts.append(f"#define REPRO_OP_COMB {comb}\n")
    if subword:
        try:
            narrow = _narrow(v, m)
        except _Unsupported as e:
            raise NotImplementedError(
                f"operator {op.name!r}: its message's result cannot be "
                f"narrowed to {dtype}: {e.detail}; run it with "
                f"device='cpu'") from None
        half = {"bf": "#define REPRO_OP_BF16 1\n",
                "h": "#define REPRO_OP_F16 1\n"}.get(v, "")
        parts += [SUBWORD_PRELUDE, f"typedef {_CTYPES[v]} repro_op_val;\n"
                  + half, message, f"typedef {_CTYPES[m]} repro_op_msg;\n",
                  improves, narrow]
    else:
        parts += [message, improves]
    header = "\n".join(parts)
    return Lowered(header=header,
                   digest=hashlib.sha256(header.encode()).hexdigest()[:16])
