"""Lower a user-defined :class:`~repro_torch.core.operators.EdgeOp` to CUDA
C++, so that the relax kernels (B1, B2, B1's batch contract) and the fused
fixed point evaluate it on the card.

The reference traces an operator's ``message`` and ``update`` into its
Pallas kernels and its fused ``lax.while_loop``.  A hand-written CUDA
kernel cannot call Python, so the port traces the same pure elementwise
callables with :func:`torch.fx.symbolic_trace`, gives every node its
dtype with :class:`~torch.fx.passes.shape_prop.ShapeProp` on int32
samples, and emits one header of two functions, each
``__host__ __device__ __forceinline__``::

    int32_t repro_op_message(int32_t v, int32_t w);
    bool repro_op_improves(int32_t cand, int32_t cur);

and the combine's code (``REPRO_OP_COMB``).  ``kernels._build.custom_lib``
compiles ``csrc/relax.cu`` and ``csrc/fused.cu`` once more with it, for
that one operator (``MSG_CUSTOM`` in ``csrc/relax_lanes.cuh``).

Every supported node computes what torch computes on int32 and bool
tensors on the CPU, bit for bit on every input (docs/operators_torch.md):
``+ - *`` and negation wrap (in ``uint32_t``), ``//`` rounds down and
``%`` takes the divisor's sign (only by a nonzero int constant;
``INT_MIN // -1`` wraps), ``fmod`` takes the dividend's, shifts take a
constant in [0, 31], ``abs(INT_MIN)`` is ``INT_MIN``, ``& | ^ ~`` work on
int32 and bool, and so do comparisons, ``minimum``/``maximum``,
``clamp``, ``where``, the logical ops and ``.to(int32 | bool)``.
Anything else (a float anywhere, true division, a reduction, indexing,
``.item()``, control flow on values, division by a tensor, a constant
outside int32) raises :class:`NotImplementedError` naming the operator
and the fx node, before anything is built: such an operator runs with
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import operator
import threading
from typing import Callable

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
        super().__init__(f"node {node.name!r} ({_target_name(node)}): "
                         f"{reason}")


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
    operator.lshift: "lshift", operator.rshift: "rshift",
    operator.and_: "and", operator.or_: "or", operator.xor: "xor",
    operator.invert: "invert", operator.neg: "neg", operator.abs: "abs",
    operator.lt: "lt", operator.le: "le", operator.gt: "gt",
    operator.ge: "ge", operator.eq: "eq", operator.ne: "ne",
}
_TORCH_FNS = {
    torch.add: "add", torch.sub: "sub", torch.mul: "mul",
    torch.floor_divide: "floordiv", torch.div: "div",
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
    "div": "div", "remainder": "remainder", "fmod": "fmod",
    "bitwise_and": "and", "bitwise_or": "or", "bitwise_xor": "xor",
    "bitwise_not": "invert", "neg": "neg", "abs": "abs",
    "minimum": "minimum", "maximum": "maximum", "clamp": "clamp",
    "clamp_min": "clamp_min", "clamp_max": "clamp_max",
    "lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "eq": "eq", "ne": "ne",
    "logical_and": "logical_and", "logical_or": "logical_or",
    "logical_xor": "logical_xor", "logical_not": "logical_not",
    "to": "to", "int": "int", "bool": "bool",
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
}

_COMPARE = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==",
            "ne": "!="}
_BITWISE = {"and": "&", "or": "|", "xor": "^"}
_LOGICAL = {"logical_and": "&&", "logical_or": "||", "logical_xor": "!="}
_WRAPPING = {"add": "repro_op_add", "sub": "repro_op_sub",
             "mul": "repro_op_mul"}


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
        raise _Unsupported(node, "not an elementwise int32 operation the "
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


#: ops whose second operand must be a Python int constant
_CONSTANT_OTHER = {"floordiv": "the divisor", "div": "the divisor",
                   "remainder": "the divisor", "fmod": "the divisor",
                   "lshift": "the shift", "rshift": "the shift"}


def _check_operands(node: fx.Node, name: str) -> None:
    """Refuse, before any sample runs, a divisor or shift that is a
    tensor (the kernels divide and shift by constants only)."""
    other = _bind(node, name).get("other")
    if name in _CONSTANT_OTHER and isinstance(other, fx.Node):
        raise _Unsupported(node, f"{_CONSTANT_OTHER[name]} is a tensor; "
                                 f"only a Python int constant is lowered")
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
            raise _Unsupported(n, f"fails on int32 samples "
                                  f"({type(e).__name__}: {first})") from e
        return super().run_node(n)


def _propagate(gm: fx.GraphModule) -> None:
    """Every node's dtype on int32 samples (``node.meta``); a node that
    fails on them raises :class:`_Unsupported`."""
    sample = torch.tensor([0, 1, -1, 7], dtype=torch.int32)
    _Prop(gm).propagate(sample, sample.flip(0))


@dataclasses.dataclass
class _Emitter:
    """C++ statements for one traced callable; every node becomes one
    ``const`` local of its dtype (``int32_t`` or ``bool``)."""
    lines: list = dataclasses.field(default_factory=list)
    names: dict = dataclasses.field(default_factory=dict)
    kinds: dict = dataclasses.field(default_factory=dict)

    def kind(self, node: fx.Node) -> str:
        meta = node.meta.get("tensor_meta")
        dtype = getattr(meta, "dtype", None)
        if dtype == torch.int32:
            return "i"
        if dtype == torch.bool:
            return "b"
        raise _Unsupported(node, f"gives {dtype or 'no tensor'}; the "
                                 f"kernels evaluate int32 and bool only")

    # an operand (a node or a Python constant) as an int32 or a bool
    # expression
    def operand(self, node: fx.Node, x, want: str) -> str:
        if isinstance(x, fx.Node):
            name, kind = self.names[x], self.kinds[x]
            if kind == want:
                return name
            return f"(int32_t){name}" if want == "i" else f"({name} != 0)"
        if isinstance(x, bool):
            if want == "b":
                return "true" if x else "false"
            return "1" if x else "0"
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

    def expr(self, node: fx.Node, name: str, a: dict, kind: str) -> str:
        i = lambda x: self.operand(node, x, "i")          # noqa: E731
        b = lambda x: self.operand(node, x, "b")          # noqa: E731
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
            return f"({i(a['input'])} {_COMPARE[name]} {i(a['other'])})"
        if name in _LOGICAL:
            return (f"({b(a['input'])} {_LOGICAL[name]} "
                    f"{b(a['other'])})")
        if name == "logical_not":
            return f"(!{b(a['input'])})"
        if name in ("to", "int", "bool"):
            if name == "to" and a.get("dtype") not in (torch.int32,
                                                       torch.bool):
                raise _Unsupported(node, "only .to(torch.int32) and "
                                         ".to(torch.bool) are lowered")
            return i(a["input"]) if kind == "i" else b(a["input"])
        raise _Unsupported(node, "not lowered")      # pragma: no cover

    def node(self, node: fx.Node) -> None:
        name = _canonical(node)
        args = _bind(node, name)
        kind = self.kind(node)
        var = f"t{len(self.lines)}"
        ctype = "int32_t" if kind == "i" else "bool"
        self.lines.append(f"  const {ctype} {var} = "
                          f"{self.expr(node, name, args, kind)};")
        self.names[node], self.kinds[node] = var, kind


def _trace(fn: Callable) -> fx.GraphModule:
    """The fx graph of ``fn(a, b)``, traced from a root that calls it (so
    that a built-in torch function traces too)."""
    def root(a, b):
        return fn(a, b)
    return fx.symbolic_trace(root)


def _function(op: EdgeOp, what: str, fn: Callable, params: tuple,
              ret: str) -> str:
    """One C++ function ``repro_op_<what>(params)`` of the traced
    ``fn``, returning ``ret`` (``int32_t`` or ``bool``)."""
    try:
        gm = _trace(fn)
    except Exception as e:   # fx raises TraceError, TypeError and others
        raise NotImplementedError(
            f"operator {op.name!r}: its {what} cannot be traced by "
            f"torch.fx ({type(e).__name__}: {e}); the CUDA kernels take "
            f"elementwise int32 callables without data-dependent control "
            f"flow, so run it with device='cpu'") from e
    nodes = list(gm.graph.nodes)
    em = _Emitter()
    want = "i" if ret == "int32_t" else "b"
    try:
        for node in nodes:
            if node.op not in ("placeholder", "output"):
                _check_operands(node, _canonical(node))
        _propagate(gm)
        inputs = iter(params)
        for node in nodes:
            if node.op == "placeholder":
                em.names[node], em.kinds[node] = next(inputs), "i"
            elif node.op == "output":
                out = node.args[0]
                if not isinstance(out, fx.Node) or em.kinds.get(out) != want:
                    raise _Unsupported(
                        node, f"the {what} must return one "
                              f"{'int32' if want == 'i' else 'bool'} tensor")
                em.lines.append(f"  return {em.names[out]};")
            else:
                em.node(node)
    except _Unsupported as e:
        raise NotImplementedError(
            f"operator {op.name!r}: its {what} cannot be lowered to CUDA: "
            f"{e}; run it with device='cpu'") from None
    body = "\n".join(em.lines)
    return (f"REPRO_OP_FN {ret} repro_op_{what}(int32_t {params[0]}, "
            f"int32_t {params[1]}) {{\n{body}\n}}\n")


_DEFAULT_IMPROVES = {"min": "cand < cur", "max": "cand > cur",
                     "add": "cand != 0"}


#: fx's symbolic tracing patches module-level functions while it runs, so
#: two threads (builds of several operators at once) trace one at a time
_TRACE_LOCK = threading.Lock()


def lower(op: EdgeOp) -> Lowered:
    """The C++ header of ``op``'s ``message`` and activation test (its
    ``update``, or the combine's default as :meth:`EdgeOp.improves` has
    it).  Raises :class:`NotImplementedError` for an operator the kernels
    cannot take: non-int32 ``dtype``, ``add`` with a nonzero identity
    (both from :meth:`EdgeOp.kernel_codes`), or a callable outside the
    lowered op set.  Safe to call from several threads."""
    with _TRACE_LOCK:
        return _lower(op)


def _lower(op: EdgeOp) -> Lowered:
    _, comb = op.kernel_codes()
    parts = [PRELUDE, f"#define REPRO_OP_COMB {comb}\n",
             _function(op, "message", op.message, ("v", "w"), "int32_t")]
    if op.update is not None:
        parts.append(_function(op, "improves", op.update, ("cand", "cur"),
                               "bool"))
    else:
        parts.append(f"REPRO_OP_FN bool repro_op_improves(int32_t cand, "
                     f"int32_t cur) {{\n  return "
                     f"{_DEFAULT_IMPROVES[op.combine]};\n}}\n")
    header = "\n".join(parts)
    return Lowered(header=header,
                   digest=hashlib.sha256(header.encode()).hexdigest()[:16])
