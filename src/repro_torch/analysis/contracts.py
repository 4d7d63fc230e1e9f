"""EdgeOp contract verifier: monoid laws, checked by evaluation (CT001–CT006),
the port of :mod:`repro.analysis.contracts`.

Every strategy, both execution modes and both schedules reach the same
bits only because of the algebra an :class:`repro_torch.core.operators.EdgeOp`
declares: ``combine`` is an associative, commutative monoid with neutral
element ``identity``; the activation predicate fires exactly when a
candidate changes the value; ``weight_additive`` promises candidates land
in later delta buckets.  Nothing in the dataclass enforces those laws, so
this pass evaluates them with the operator's own callables, on int32 CPU
tensors, over the **full int8 domain** (every value in ``[-128, 127]``,
plus the operator's ``identity`` and source seed, restricted by its
declared :attr:`~repro_torch.core.operators.EdgeOp.value_min`):

``CT001`` **identity-neutrality** — ``combine(identity, x) == x`` for
    every domain value.  Masked lanes fold the identity by design.

``CT002`` **relax-order-independence** — delivering candidates ``a``
    then ``b`` equals ``b`` then ``a`` equals the pre-folded
    ``combine(a, b)``, where "delivering" is the engine's gated step
    ``apply(cur, c) = where(improves(c, cur), combine(cur, c), cur)``.
    Strategies chunk deliveries differently (a BS column, a WD iteration,
    a fused chunk), so a violation makes them disagree.

``CT003`` **activation-consistency** — ``improves(c, cur)`` is true
    exactly when ``combine(cur, c) != cur`` (for ``add``: when
    ``c != identity``).  Too strict misses re-activations; too loose
    never converges (the fused kernel would spin to its iteration cap).

``CT004`` **re-delivery idempotence** — ``apply(apply(x, c), c) ==
    apply(x, c)`` for an operator that claims ``idempotent``:
    delta-stepping re-relaxes settled buckets, and the graph server's
    distance cache keys results without the schedule.

``CT005`` **weight-additive consistency** — under
    :attr:`EdgeOp.weight_additive`, ``rank(message(v, w)) >= rank(v) + w``
    (:func:`repro_torch.core.worklist.bucket_rank`); the light/heavy
    split of :mod:`repro_torch.core.priority` defers heavy edges on it.

``CT006`` **message-dtype stability** — ``message`` maps int32 tensors
    to int32 tensors of the same shape.

The rules, their order, the domain and the first counterexample of each
are the reference's, so both packages refuse a broken operator with the
same finding.  The triple sweep of CT002 runs in slabs of :data:`_SLAB`
values of ``x``, so the temporaries stay a few hundred MB.

Run it as ``python -m repro_torch.analysis`` (every registered operator),
:func:`check_operator` (one operator), or at ``register_operator()`` time
with ``REPRO_CHECK_CONTRACTS=1`` exported
(:func:`repro_torch.core.operators.register_operator` refuses an
operator with error findings).
"""

from __future__ import annotations

import inspect
from typing import Optional

import torch

from repro_torch.analysis.findings import RUNTIME_FILE, Finding

PASS_NAME = "contracts"
RULES = ("CT001", "CT002", "CT003", "CT004", "CT005", "CT006")

#: x-axis slice width of the triple sweep — 257³ values are evaluated in
#: slabs so peak memory stays a few hundred MB of int32 temporaries
_SLAB = 32


def _dtype_name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def _fold(combine: str, a, b):
    if combine == "min":
        return torch.minimum(a, b)
    if combine == "max":
        return torch.maximum(a, b)
    return a + b


def _improves(op, cand, cur):
    return torch.as_tensor(op.improves(cand, cur)).to(torch.bool)


def _apply(op, cur, cand):
    """The engine's gated relax step, on CPU tensors."""
    return torch.where(_improves(op, cand, cur),
                       _fold(op.combine, cur, cand), cur)


def _domain(op) -> torch.Tensor:
    """The full int8 domain plus the operator's own sentinels, restricted
    to the operator's declared value domain (``EdgeOp.value_min``),
    sorted ascending."""
    extras = [int(op.identity)]
    if op.source_value is not None:
        extras.append(int(op.source_value))
    vals = torch.unique(torch.cat([
        torch.arange(-128, 128, dtype=torch.int64),
        torch.tensor(extras, dtype=torch.int64)]))
    value_min = getattr(op, "value_min", None)
    if value_min is not None:
        vals = vals[vals >= int(value_min)]
    return vals.to(op.dtype)


def _anchor(op) -> tuple:
    """(file, line) of the operator's defining module, best effort."""
    for obj in (op.message, op.update):
        if obj is None:
            continue
        try:
            code = obj.__code__
            return code.co_filename, code.co_firstlineno
        except AttributeError:
            continue
    try:
        mod = inspect.getmodule(type(op))
        return inspect.getsourcefile(mod) or RUNTIME_FILE, 0
    except TypeError:
        return RUNTIME_FILE, 0


def _first(mask: torch.Tensor) -> tuple:
    """Index tuple of the first True of ``mask`` in row-major order."""
    flat = int(mask.reshape(-1).to(torch.uint8).argmax())
    idx = []
    for size in reversed(mask.shape):
        idx.append(flat % size)
        flat //= size
    return tuple(reversed(idx))


def _first_bad(mask: torch.Tensor, *grids) -> tuple:
    """Values of the grids at the first violation of a 'bad' mask."""
    return tuple(int(g[i]) for g, i in zip(grids, _first(mask)))


def check_operator(op, *, domain: Optional[torch.Tensor] = None) -> list:
    """Evaluate CT001–CT006 for one operator; returns findings."""
    file, line = _anchor(op)
    D = _domain(op) if domain is None else torch.as_tensor(domain).to(
        op.dtype)
    findings: list = []

    def finding(rule, message, hint):
        findings.append(Finding(rule=rule, message=message, hint=hint,
                                file=file, line=line))

    ident = torch.tensor(op.identity, dtype=op.dtype)
    dname = _dtype_name(op.dtype)

    # CT006 first: if message mangles dtype/shape the other sweeps would
    # report derived noise
    w = torch.ones_like(D)
    try:
        msg = torch.as_tensor(op.message(D, w))
    except Exception as exc:
        finding("CT006",
                f"operator {op.name!r}: message raised {exc!r} on plain "
                f"{dname} tensors",
                "message must be a pure elementwise torch function of "
                "(val_src, w)")
        return findings
    if tuple(msg.shape) != tuple(D.shape) or msg.dtype != op.dtype:
        finding("CT006",
                f"operator {op.name!r}: message({dname}[{D.numel()}], w) "
                f"returned {_dtype_name(msg.dtype)}{list(msg.shape)} — "
                f"dtype/shape must be preserved or the scatter changes "
                f"representation mid-traversal",
                "cast inside message (e.g. keep Python scalars out of "
                "int32 arithmetic, or .to(op.dtype))")

    # CT001: identity neutrality (the raw monoid, both sides)
    bad = (_fold(op.combine, ident, D) != D) | (_fold(op.combine, D, ident)
                                                != D)
    if bool(bad.any()):
        (x,) = _first_bad(bad, D)
        folded = int(_fold(op.combine, ident,
                           torch.tensor(x, dtype=op.dtype)))
        finding("CT001",
                f"operator {op.name!r}: identity {int(op.identity)} is "
                f"not neutral for combine={op.combine!r} — e.g. "
                f"combine({int(op.identity)}, {x}) = {folded} != {x}; "
                f"masked/padded lanes scatter the identity and would "
                f"clobber real values",
                "set identity to the true neutral element (min: INF, "
                "max: dtype min, add: 0), or declare the restricted "
                "domain the identity is neutral over (EdgeOp.value_min)")

    # CT003: activation fires iff the fold changes the value
    C, X = torch.meshgrid(D, D, indexing="ij")
    imp = _improves(op, C, X)
    if op.combine == "add":
        changes = C != ident
    else:
        changes = _fold(op.combine, X, C) != X
    bad = imp != changes
    if bool(bad.any()):
        i, j = _first(bad)
        c, x = int(D[i]), int(D[j])
        direction = ("never re-converges (livelock under mode='fused')"
                     if bool(imp[bad].any()) else
                     "misses frontier re-activations (wrong fixed point)")
        finding("CT003",
                f"operator {op.name!r}: improves({c}, {x}) = "
                f"{bool(imp[i, j])} but combine({x}, {c}) "
                f"{'changes' if bool(changes[i, j]) else 'does not change'}"
                f" the value — an activation predicate inconsistent with "
                f"the monoid {direction}",
                "make update equivalent to 'combine(cur, cand) != cur' "
                "(strict improvement for min/max), or drop update to get "
                "the consistent default")

    # CT004: re-delivering the same candidate is a no-op
    once = _apply(op, X, C)
    twice = _apply(op, once, C)
    bad = once != twice
    if op.idempotent and bool(bad.any()):
        c, x = _first_bad(bad, D, D)
        finding("CT004",
                f"operator {op.name!r} (combine={op.combine!r}) claims "
                f"idempotence but re-delivering candidate {c} to value "
                f"{x} moves it twice — delta-stepping re-relaxation and "
                f"the DistanceCache's schedule-free key both assume "
                f"re-delivery is a no-op",
                "fix the update predicate (a too-loose improves re-fires "
                "on equal values), or use an add-style non-idempotent "
                "declaration and schedule='bsp'")

    # CT002: relax-order independence over the full triple domain
    counter = _order_independence_counterexample(op, D)
    if counter is not None:
        x, a, b, ab, ba = counter
        finding("CT002",
                f"operator {op.name!r}: relax order changes the result — "
                f"value {x} receiving candidates ({a}, then {b}) settles "
                f"at {ab}, but ({b}, then {a}) settles at {ba}; schedules "
                f"chunk deliveries differently (BS per edge column, WD "
                f"per merge-path tile), so strategies would disagree "
                f"bit-for-bit",
                "the gated step where(improves(c, cur), combine(cur, c), "
                "cur) must be an associative+commutative action — fix "
                "update/combine so delivery order cannot matter")

    # CT005: weight-additive rank growth
    if op.weight_additive:
        from repro_torch.core.graph import INF
        from repro_torch.core.worklist import bucket_rank
        desc = op.combine == "max"
        v = D[(D >= 0) & (D < INF)]
        if v.numel():
            wts = torch.arange(0, 128, dtype=op.dtype)
            V, W = torch.meshgrid(v, wts, indexing="ij")
            rank_v = bucket_rank(V, descending=desc).to(torch.int64)
            rank_m = bucket_rank(torch.as_tensor(op.message(V, W)),
                                 descending=desc).to(torch.int64)
            bad = rank_m < rank_v + W
            if bool(bad.any()):
                i, j = _first(bad)
                vv, ww = int(v[i]), int(wts[j])
                finding(
                    "CT005",
                    f"operator {op.name!r} declares weight_additive=True "
                    f"but rank(message({vv}, {ww})) = {int(rank_m[i, j])}"
                    f" < rank({vv}) + {ww} — a heavy edge deferred past "
                    f"its bucket epoch would then settle too late "
                    f"(wrong delta-stepping distances)",
                    "declare weight_additive=False (every edge treated "
                    "as light — still correct, nothing deferred), or fix "
                    "message to grow the rank by at least w")
    return findings


def _order_independence_counterexample(op, D: torch.Tensor):
    """First (x, a, b) where delivery order or pre-folding changes the
    outcome, or None.  Swept in slabs of the triple grid."""
    n = D.numel()
    a = D[None, :, None]
    b = D[None, None, :]
    ab_fold = _fold(op.combine, a, b)
    for lo in range(0, n, _SLAB):
        x = D[lo:lo + _SLAB][:, None, None].expand(-1, n, n)
        ab = _apply(op, _apply(op, x, a.expand_as(x)), b.expand_as(x))
        ba = _apply(op, _apply(op, x, b.expand_as(x)), a.expand_as(x))
        folded = _apply(op, x, ab_fold.expand_as(x))
        bad = (ab != ba) | (ab != folded)
        if bool(bad.any()):
            i, j, k = _first(bad)
            return (int(D[lo + i]), int(D[j]), int(D[k]),
                    int(ab[i, j, k]), int(ba[i, j, k]))
    return None


def run(paths: list) -> list:
    """Pass entry point: verify every registered operator.

    ``paths`` is unused (this is a registry pass, not a file pass) but
    accepted so all passes share one signature."""
    del paths
    from repro_torch.core.operators import OPERATORS
    findings: list = []
    for op in OPERATORS.values():
        findings.extend(check_operator(op))
    return findings
