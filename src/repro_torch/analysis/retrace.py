"""Recompile-hazard lint: AST rules over the port's compile boundaries
(rules RT001–RT004, RT000), the port of :mod:`repro.analysis.retrace`.

The reference lints functions under ``jax.jit``.  The port's compile
boundaries are ``torch.compile`` and ``torch.jit.script``; PyTorch runs
everything else eagerly, and a host-stepped loop that merely calls
compiled code is out of scope, as in the reference.  The rules:

``RT001`` **compiled-control-param** — a parameter of a
    ``torch.compile``-d function steers Python control flow (``if`` /
    ``while`` tests, ``assert``, a conditional expression,
    ``for _ in range(param)``).  Dynamo specialises on the value: a guard,
    and a recompile for each value it sees (after ``recompile_limit``
    values it falls back to eager).  ``x is None`` tests are exempt: one
    guard on the argument's structure.  ``torch.jit.script`` compiles
    control flow into its graph, so the rule does not apply to it.

``RT002`` **compiled-mutable-default** — a parameter of a compiled
    function defaults to a list/dict/set literal: one object shared by
    every call, guarded by identity and contents (a mutation recompiles;
    TorchScript refuses such defaults).

``RT003`` **compiled-module-tensor-closure** — a compiled function reads
    a module-level tensor (``NAME = torch.<ctor>(...)``).  It is captured
    as a constant of the graph: rebinding the module value recompiles,
    and the buffer stays pinned on its device.  Pass it as an argument.

``RT004`` **compiled-impure-call** — a clock read (``time.*``) or a host
    RNG call (``random.*``, ``numpy.random.*``) inside compiled code: it
    breaks the graph or is frozen at trace time, so timings measure
    nothing and "random" values repeat.  Use ``torch`` RNG with a
    ``torch.Generator``.

``RT000`` — the file does not parse.

Scope: functions *decorated* with ``torch.compile`` (bare, with options,
or through ``functools.partial``) or ``torch.jit.script``, with the
``def`` s nested inside them.  The port has no such function today
(its kernels are hand-written CUDA launched from eager code), so the
pass reports nothing on ``src/repro_torch``; it stands ready for a
compiled or graph-captured decode step.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, Optional

from repro_torch.analysis.findings import Finding

PASS_NAME = "retrace"
RULES = ("RT001", "RT002", "RT003", "RT004")

#: dotted call prefixes that read the host clock or the host RNG
IMPURE_CALLS = (
    "time.time", "time.perf_counter", "time.monotonic",
    "time.process_time", "time.time_ns", "time.perf_counter_ns",
    "np.random.", "numpy.random.",
    "random.random", "random.randint", "random.randrange",
    "random.uniform", "random.choice", "random.shuffle", "random.sample",
    "random.gauss", "random.seed",
)

#: torch constructors whose module-level results are tensors (RT003)
_TENSOR_CTORS = {
    "tensor", "as_tensor", "from_numpy", "arange", "zeros", "ones", "full",
    "linspace", "eye", "empty", "rand", "randn", "randint", "zeros_like",
    "ones_like", "full_like", "empty_like",
}

_COMPILE = ("torch.compile", "compile")
_SCRIPT = ("torch.jit.script", "jit.script")


def _dotted(node: ast.AST) -> str:
    """'a.b.c' for Name/Attribute chains, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _boundary(dec: ast.AST) -> Optional[str]:
    """``"compile"`` or ``"script"`` when the decorator puts the function
    behind a compile boundary, else None."""
    target = dec
    if isinstance(dec, ast.Call):
        if _dotted(dec.func) in ("partial", "functools.partial"):
            if not dec.args:
                return None
            target = dec.args[0]           # @partial(torch.compile, ...)
        else:
            target = dec.func              # @torch.compile(...)
    name = _dotted(target)
    if name in _COMPILE:
        return "compile"
    if name in _SCRIPT:
        return "script"
    return None


def _param_names(fn: ast.FunctionDef) -> list:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]


def _names_in(node: ast.AST) -> Iterable[ast.Name]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
            yield sub


def _module_tensors(tree: ast.Module) -> dict:
    """Module-level ``NAME = torch.<ctor>(...)`` bindings -> line."""
    out: dict = {}
    for node in tree.body:
        targets, value = [], None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if not isinstance(value, ast.Call):
            continue
        head, _, tail = _dotted(value.func).rpartition(".")
        if head == "torch" and tail in _TENSOR_CTORS:
            for t in targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node.lineno
    return out


def _local_bindings(fn: ast.FunctionDef) -> set:
    """Names bound anywhere inside ``fn`` (params, assignments, defs,
    imports, comprehension targets): loads of these are not closures."""
    bound = set(_param_names(fn))
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            bound.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            bound.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                bound.add((alias.asname or alias.name).split(".")[0])
        elif isinstance(node, ast.arg):
            bound.add(node.arg)
    return bound


def _none_checked(test: ast.AST) -> set:
    """``id()`` of Name nodes appearing only as ``X is [not] None``
    operands (one guard on structure, not one per value)."""
    out: set = set()
    for sub in ast.walk(test):
        if (isinstance(sub, ast.Compare)
                and all(isinstance(o, (ast.Is, ast.IsNot)) for o in sub.ops)
                and all(isinstance(c, ast.Constant) and c.value is None
                        for c in sub.comparators)):
            for name in _names_in(sub):
                out.add(id(name))
    return out


def _control_flow_params(fn: ast.FunctionDef) -> dict:
    """Parameter names read by Python control flow in ``fn``'s own body
    (nested defs excluded: their params are their own) -> first line."""
    params = set(_param_names(fn))
    hits: dict = {}

    def visit(node: ast.AST, in_nested: bool):
        for child in ast.iter_child_nodes(node):
            nested = in_nested or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            if not in_nested:
                test = None
                if isinstance(child, (ast.If, ast.While, ast.Assert,
                                      ast.IfExp)):
                    test = child.test
                elif isinstance(child, ast.For):
                    it = child.iter
                    if isinstance(it, ast.Call) and _dotted(it.func) == \
                            "range":
                        test = it
                if test is not None:
                    skip = _none_checked(test)
                    for name in _names_in(test):
                        if (name.id in params and name.id not in hits
                                and id(name) not in skip):
                            hits[name.id] = test.lineno
            visit(child, nested)

    visit(fn, False)
    return hits


_MUTABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
            ast.SetComp)


def _defaults_by_name(fn: ast.FunctionDef) -> dict:
    a = fn.args
    out: dict = {}
    pos = a.posonlyargs + a.args
    for param, default in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        out[param.arg] = default
    for param, default in zip(a.kwonlyargs, a.kw_defaults):
        if default is not None:
            out[param.arg] = default
    return out


def check_file(path: str, text: Optional[str] = None) -> list:
    """Run RT001–RT004 over one Python source file."""
    if text is None:
        text = Path(path).read_text(encoding="utf-8")
    try:
        tree = ast.parse(text, filename=path)
    except SyntaxError as exc:
        return [Finding(
            rule="RT000", file=path, line=exc.lineno or 0,
            message=f"file does not parse: {exc.msg}",
            hint="fix the syntax error (every other pass skipped it)")]
    module_tensors = _module_tensors(tree)
    findings: list = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        for dec in node.decorator_list:
            kind = _boundary(dec)
            if kind is not None:
                findings.extend(
                    _check_compiled(path, node, kind, module_tensors))
                break
    return findings


def _check_compiled(path: str, fn: ast.FunctionDef, kind: str,
                    module_tensors: dict) -> list:
    findings = []
    boundary = "torch.compile" if kind == "compile" else "torch.jit.script"

    # RT001: control flow on a parameter specialises the compiled graph
    if kind == "compile":
        for name, lineno in sorted(_control_flow_params(fn).items()):
            findings.append(Finding(
                rule="RT001", file=path, line=lineno,
                message=(
                    f"{boundary} function {fn.name!r} branches on "
                    f"parameter {name!r} — dynamo guards on its value and "
                    f"recompiles for each value it sees"),
                hint=(f"make {name!r} a tensor and branch with "
                      f"torch.where / torch.cond, or branch in the eager "
                      f"caller and compile one function per case")))

    # RT002: a mutable default is one object shared by every call
    for name, default in sorted(_defaults_by_name(fn).items()):
        if isinstance(default, _MUTABLE):
            findings.append(Finding(
                rule="RT002", file=path, line=default.lineno,
                message=(
                    f"parameter {name!r} of {boundary} function "
                    f"{fn.name!r} defaults to a mutable "
                    f"{type(default).__name__.lower()} literal — one "
                    f"object shared by every call and guarded by its "
                    f"contents, so a mutation recompiles"),
                hint="use a tuple / frozenset / None-sentinel default"))

    # RT003 + RT004 cover the whole compiled region incl. nested defs
    local = _local_bindings(fn)
    seen: set = set()
    for sub in ast.walk(fn):
        if (isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load)
                and sub.id in module_tensors and sub.id not in local
                and sub.id not in seen):
            seen.add(sub.id)
            findings.append(Finding(
                rule="RT003", file=path, line=sub.lineno,
                message=(
                    f"{boundary} function {fn.name!r} reads module-level "
                    f"tensor {sub.id!r} (defined at line "
                    f"{module_tensors[sub.id]}) — captured as a graph "
                    f"constant: rebinding it recompiles, and the buffer "
                    f"stays pinned on its device"),
                hint=f"pass {sub.id!r} as a function argument instead"))
        if isinstance(sub, ast.Call):
            dotted = _dotted(sub.func)
            if dotted and _is_impure(dotted):
                findings.append(Finding(
                    rule="RT004", file=path, line=sub.lineno,
                    message=(
                        f"{dotted}() inside {boundary} function "
                        f"{fn.name!r} breaks the graph or is frozen at "
                        f"trace time"),
                    hint=("hoist the call to the eager caller, or draw "
                          "from a torch.Generator passed in")))
    return findings


def _is_impure(dotted: str) -> bool:
    for pat in IMPURE_CALLS:
        if pat.endswith("."):
            if dotted.startswith(pat):
                return True
        elif dotted == pat:
            return True
    return False


def run(paths: list) -> list:
    """Pass entry point: lint every ``*.py`` under ``paths``."""
    findings: list = []
    for p in paths:
        root = Path(p)
        for f in (sorted(root.rglob("*.py")) if root.is_dir() else [root]):
            if f.suffix == ".py":
                findings.extend(check_file(str(f)))
    return findings
