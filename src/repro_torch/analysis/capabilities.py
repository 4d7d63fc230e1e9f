"""Capability cross-checker (rules CP001–CP003), the port of
:mod:`repro.analysis.capabilities`.

The strategy registry's capability flags (:mod:`repro_torch.core.strategies`)
are promises, and the engine gates on the flags alone:

* ``SHARDABLE`` promises a sharded lowering: the strategy's fused kernel
  has a step in :data:`repro_torch.core.shard.SHARDED_STEPS`;
* ``PRIORITY_SCHEDULE`` promises delta-stepping phases: the fused kernel
  has a step in :data:`repro_torch.core.priority.DELTA_STEPS`;
* ``FRONTIER_INIT`` promises that ``iterate`` can start from an arbitrary
  dense (dist, mask) pair: the class overrides ``iterate``.

Three rules:

* **CP001 — phantom capability**: a registered strategy declares a flag
  that the lowering behind it does not back.
* **CP002 — undeclared capability gate**: a source-level gate tests a
  capability name that is not one of the registry's flags (a typo'd
  string or a stale constant: the gate can never pass, or never fail).
* **CP003 — unknown capability flag**: a registered strategy declares a
  flag outside the known vocabulary; no gate ever looks at it.

The reference's fourth flag, ``PALLAS_BACKEND``, and its probes (a
``backend`` parameter on the entry point and on the sharded step) have
no counterpart: the port has no ``backend=`` argument, the tensor's
device decides which version of a kernel runs.

CP001/CP003 inspect the live registry; CP002 is a static AST scan over
the given paths.  :func:`check_strategy` takes an unregistered class, so
tests can hold fixtures without touching the registry.
"""

from __future__ import annotations

import ast
import inspect
from pathlib import Path

from repro_torch.analysis.findings import RUNTIME_FILE, Finding

PASS_NAME = "capabilities"
RULES = ("CP001", "CP002", "CP003")


def known_flags() -> dict:
    """Constant name -> flag string, the registry's vocabulary."""
    from repro_torch.core import strategies
    return {
        "FRONTIER_INIT": strategies.FRONTIER_INIT,
        "SHARDABLE": strategies.SHARDABLE,
        "PRIORITY_SCHEDULE": strategies.PRIORITY_SCHEDULE,
    }


def _anchor(cls) -> tuple:
    """(file, line) of a strategy class, best effort."""
    try:
        return (inspect.getsourcefile(cls) or RUNTIME_FILE,
                inspect.getsourcelines(cls)[1])
    except (OSError, TypeError):
        return RUNTIME_FILE, 0


def _overrides_iterate(cls) -> bool:
    from repro_torch.core.strategies import StrategyBase
    return getattr(cls, "iterate", None) is not StrategyBase.iterate


def check_strategy(name: str, cls) -> list:
    """Cross-check one strategy class's declared capabilities against the
    lowerings that would back them.  Usable on unregistered fixtures."""
    from repro_torch.core import strategies
    from repro_torch.core.fused import fused_kernel_name
    from repro_torch.core.priority import DELTA_STEPS
    from repro_torch.core.shard import SHARDED_STEPS

    file, line = _anchor(cls)
    findings: list = []

    def finding(rule, message, hint):
        findings.append(Finding(
            rule=rule, message=message, file=file, line=line, hint=hint))

    caps = frozenset(getattr(cls, "capabilities", frozenset()))
    flags = known_flags()
    for flag in sorted(caps - frozenset(flags.values())):
        finding(
            "CP003",
            f"strategy {name!r} declares unknown capability {flag!r} — "
            f"no engine gate ever tests it "
            f"(known: {sorted(flags.values())})",
            "use the constants exported by repro_torch.core.strategies, "
            "or add the new flag (and its gate) there first")

    kernel = fused_kernel_name(cls)

    if strategies.SHARDABLE in caps and kernel not in SHARDED_STEPS:
        finding(
            "CP001",
            f"strategy {name!r} declares SHARDABLE but its fused kernel "
            f"({kernel!r}) has no sharded step in repro_torch.core.shard "
            f"(SHARDED_STEPS={tuple(SHARDED_STEPS)}) — "
            f"engine.run(..., shards=) would pass the gate and fail at "
            f"dispatch",
            "drop SHARDABLE from the declaration, or add the kernel's "
            "step to repro_torch.core.shard.SHARDED_STEPS")

    if strategies.PRIORITY_SCHEDULE in caps and kernel not in DELTA_STEPS:
        finding(
            "CP001",
            f"strategy {name!r} declares PRIORITY_SCHEDULE but its fused "
            f"kernel ({kernel!r}) has no delta-stepping phase in "
            f"repro_torch.core.priority "
            f"(DELTA_STEPS={tuple(DELTA_STEPS)}) "
            f"— schedule='delta' would pass the gate with no phase "
            f"lowering behind it",
            "drop PRIORITY_SCHEDULE, or add the kernel's delta-stepping "
            "step to repro_torch.core.priority.DELTA_STEPS")

    if strategies.FRONTIER_INIT in caps and not _overrides_iterate(cls):
        finding(
            "CP001",
            f"strategy {name!r} declares FRONTIER_INIT but overrides "
            f"no ``iterate`` — it cannot consume an arbitrary dense "
            f"(dist, frontier-mask) pair, so engine.fixed_point "
            f"would pass the gate and hit NotImplementedError",
            "override iterate(state, dist, updated_mask, count, ...) "
            "or drop FRONTIER_INIT")

    return findings


def check_registry() -> list:
    """CP001/CP003 over every registered strategy."""
    from repro_torch.core.strategies import STRATEGIES
    findings: list = []
    for name in sorted(STRATEGIES):
        findings.extend(check_strategy(name, STRATEGIES[name]))
    return findings


# ---------------------------------------------------------------------------
# CP002: static scan of gate sites
# ---------------------------------------------------------------------------

def _gate_tests(tree: ast.AST):
    """Yield (node, tested_operand) for every ``X in Y.capabilities`` /
    ``X not in strategy_capabilities(...)`` membership test."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        for cmp_op, target in zip(node.ops, node.comparators):
            if not isinstance(cmp_op, (ast.In, ast.NotIn)):
                continue
            is_caps = (isinstance(target, ast.Attribute)
                       and target.attr == "capabilities")
            is_caps_call = (
                isinstance(target, ast.Call)
                and isinstance(target.func, (ast.Name, ast.Attribute))
                and (target.func.id if isinstance(target.func, ast.Name)
                     else target.func.attr) == "strategy_capabilities")
            if is_caps or is_caps_call:
                yield node, node.left


def check_file(path, text=None) -> list:
    """CP002 over one source file."""
    path = Path(path)
    if text is None:
        text = path.read_text(encoding="utf-8")
    try:
        tree = ast.parse(text, filename=str(path))
    except SyntaxError:
        return []  # the retrace pass reports RT000 for unparseable files
    flags = known_flags()
    findings: list = []
    for node, operand in _gate_tests(tree):
        bad = None
        if isinstance(operand, ast.Constant) and isinstance(
                operand.value, str):
            if operand.value not in flags.values():
                bad = repr(operand.value)
        elif isinstance(operand, ast.Name):
            # lowercase names are locals holding a flag; an UPPERCASE name
            # outside the vocabulary is a stale or typo'd constant
            if operand.id not in flags and operand.id == operand.id.upper():
                bad = operand.id
        if bad is not None:
            findings.append(Finding(
                rule="CP002",
                message=(
                    f"gate tests undeclared capability {bad} against a "
                    f"capabilities set — no registered strategy can ever "
                    f"declare it (known flags: {sorted(flags.values())})"),
                file=str(path), line=node.lineno,
                hint=("gate on the constants exported by "
                      "repro_torch.core.strategies; if this is a new "
                      "flag, declare it there")))
    return findings


def run(paths) -> list:
    """The full capability pass: registry cross-check + gate-site scan."""
    findings = check_registry()
    for p in paths:
        p = Path(p)
        for f in (sorted(p.rglob("*.py")) if p.is_dir() else [p]):
            findings.extend(check_file(f))
    return findings
