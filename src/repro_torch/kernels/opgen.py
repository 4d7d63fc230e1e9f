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
combine's code (``REPRO_OP_COMB``).  ``kernels._build.custom_lib``
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
value.  Anything else (another dtype, a reduction, indexing,
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
#define REPRO_OP_FLOAT 1
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
        self.detail = f"node {node.name!r} ({_target_name(node)}): {reason}"
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
#: the C type of each node kind: int32, float32, bool
_CTYPES = {"i": "int32_t", "f": "float", "b": "bool"}
_KINDS = {torch.int32: "i", torch.float32: "f", torch.bool: "b"}


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
    divisor.  A float32 operator's true division (``value`` ``"f"``)
    takes any divisor, with IEEE results."""
    bound = _bind(node, name)
    other = bound.get("other")
    if (name == "div" and value == "f"
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
    sample = {"i": torch.tensor([0, 1, -1, 7], dtype=torch.int32),
              "f": torch.tensor([0.0, 1.0, -1.0, 7.5])}
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


@dataclasses.dataclass
class _Emitter:
    """C++ statements for one traced callable; every node becomes one
    ``const`` local of its dtype (``int32_t`` or ``bool``, and ``float``
    in a float32 operator: ``value`` ``"f"``)."""
    value: str = "i"
    lines: list = dataclasses.field(default_factory=list)
    names: dict = dataclasses.field(default_factory=dict)
    kinds: dict = dataclasses.field(default_factory=dict)

    def kind(self, node: fx.Node) -> str:
        meta = node.meta.get("tensor_meta")
        dtype = getattr(meta, "dtype", None)
        kind = _KINDS.get(dtype)
        if kind == "f" and self.value == "f" or kind in ("i", "b"):
            return kind
        if self.value == "f":
            raise _Unsupported(node, f"gives {dtype or 'no tensor'}; a "
                                     f"float32 operator's kernels evaluate "
                                     f"float32, int32 and bool only")
        raise _Unsupported(node, f"gives {dtype or 'no tensor'}; the "
                                 f"kernels evaluate int32 and bool only")

    # an operand (a node or a Python constant) as an int32, float32 or
    # bool expression, converted as torch converts it
    def operand(self, node: fx.Node, x, want: str) -> str:
        if isinstance(x, fx.Node):
            name, kind = self.names[x], self.kinds[x]
            if kind == want:
                return name
            if want == "b":
                return f"({name} != 0)"
            if want == "f":
                return (f"({name} ? 1.0f : 0.0f)" if kind == "b"
                        else f"repro_op_i2f({name})")
            return (f"repro_op_f2i({name})" if kind == "f"
                    else f"(int32_t){name}")
        if isinstance(x, bool):
            if want == "b":
                return "true" if x else "false"
            if want == "f":
                return "1.0f" if x else "0.0f"
            return "1" if x else "0"
        if want == "f" and isinstance(x, (int, float)):
            return _float_literal(x)
        if isinstance(x, int):
            if not INT32_MIN <= x <= INT32_MAX:
                raise _Unsupported(node, f"constant {x} lies outside int32")
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

    def is_float(self, x) -> bool:
        """Does operand ``x`` make torch compute in float32?"""
        if isinstance(x, fx.Node):
            return self.kinds[x] == "f"
        return isinstance(x, float)

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

    def expr(self, node: fx.Node, name: str, a: dict, kind: str) -> str:
        i = lambda x: self.operand(node, x, "i")          # noqa: E731
        b = lambda x: self.operand(node, x, "b")          # noqa: E731
        if name == "to":
            allowed = ((torch.int32, torch.bool, torch.float32)
                       if self.value == "f" else (torch.int32, torch.bool))
            if a.get("dtype") not in allowed:
                raise _Unsupported(node, "only .to(" + " | ".join(
                    str(d) for d in allowed) + ") is lowered")
        if kind == "f":
            return self.float_expr(node, name, a)
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
              kinds: tuple, ret: str, value: str) -> str:
    """One C++ function ``repro_op_<what>(params)`` of the traced ``fn``,
    whose parameters have ``kinds`` and which returns kind ``ret``
    (``"i"``, ``"f"`` or ``"b"``); ``value`` is the operator's value
    kind."""
    dtype = "float32" if value == "f" else "int32"
    try:
        gm = _trace(fn)
    except Exception as e:   # fx raises TraceError, TypeError and others
        raise NotImplementedError(
            f"operator {op.name!r}: its {what} cannot be traced by "
            f"torch.fx ({type(e).__name__}: {e}); the CUDA kernels take "
            f"elementwise {dtype} callables without data-dependent control "
            f"flow, so run it with device='cpu'") from e
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
                if not isinstance(out, fx.Node) or em.kinds.get(out) != ret:
                    raise _Unsupported(
                        node, f"the {what} must return one "
                              f"{ {'i': 'int32', 'f': 'float32'}.get(ret, 'bool')} "
                              f"tensor")
                em.lines.append(f"  return {em.names[out]};")
            else:
                em.node(node)
    except _Unsupported as e:
        raise NotImplementedError(
            f"operator {op.name!r}: its {what} cannot be lowered to CUDA: "
            f"{e.detail}; run it with device='cpu'") from None
    body = "\n".join(em.lines)
    args = ", ".join(f"{_CTYPES[k]} {p}" for p, k in zip(params, kinds))
    return (f"REPRO_OP_FN {_CTYPES[ret]} repro_op_{what}({args}) "
            f"{{\n{body}\n}}\n")


_DEFAULT_IMPROVES = {"min": "cand < cur", "max": "cand > cur",
                     "add": "cand != 0"}


#: fx's symbolic tracing patches module-level functions while it runs, so
#: two threads (builds of several operators at once) trace one at a time
_TRACE_LOCK = threading.Lock()


def lower(op: EdgeOp) -> Lowered:
    """The C++ header of ``op``'s ``message`` and activation test (its
    ``update``, or the combine's default as :meth:`EdgeOp.improves` has
    it), for its value type (int32 or float32).  Raises
    :class:`NotImplementedError` for an operator the kernels cannot take:
    another ``dtype``, ``add`` with a nonzero identity (both from
    :meth:`EdgeOp.kernel_codes`), or a callable outside the lowered op
    set.  Safe to call from several threads."""
    with _TRACE_LOCK:
        return _lower(op)


def _lower(op: EdgeOp) -> Lowered:
    _, comb, dtype = op.kernel_codes()
    v = "f" if dtype == torch.float32 else "i"
    parts = [PRELUDE] + ([FLOAT_PRELUDE] if v == "f" else []) + [
        f"#define REPRO_OP_COMB {comb}\n",
        _function(op, "message", op.message, ("v", "w"), (v, "i"), v, v)]
    if op.update is not None:
        parts.append(_function(op, "improves", op.update, ("cand", "cur"),
                               (v, v), "b", v))
    else:
        parts.append(f"REPRO_OP_FN bool repro_op_improves({_CTYPES[v]} cand, "
                     f"{_CTYPES[v]} cur) {{\n  return "
                     f"{_DEFAULT_IMPROVES[op.combine]};\n}}\n")
    header = "\n".join(parts)
    return Lowered(header=header,
                   digest=hashlib.sha256(header.encode()).hexdigest()[:16])
