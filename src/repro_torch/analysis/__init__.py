"""repro_torch.analysis — static contract checking for the port's strategy
and kernel stack (the port of :mod:`repro.analysis`, ROADMAP A13).

The strategies are swappable because they compute the same fixed point,
and that rests on contracts a test checks only when it happens to run
them: the :class:`~repro_torch.core.operators.EdgeOp` monoid laws, the
strategy registry's capability flags, the schedule's fields, the
kernels' shared-memory budgets and compile-boundary discipline.  These
passes check them before anything runs, so a third-party operator or
strategy is held to the built-ins' contract from its first day.

Five passes, each a module with ``PASS_NAME``, ``RULES`` and
``run(paths) -> list[Finding]``:

================  ======================  =================================
pass              rules                   checks
================  ======================  =================================
``retrace``       RT001–RT004 (+RT000)    ``torch.compile`` / ``jit.script``
                                          recompile hazards
``contracts``     CT001–CT006             EdgeOp monoid laws (int8 domain)
``capabilities``  CP001–CP003             capability flags vs. lowerings
``smem``          SM001–SM002             CUDA blocks' shared memory and
                                          block sizes (the reference's
                                          ``vmem``)
``schedules``     SC001–SC003             Schedule fields vs. readers
================  ======================  =================================

Run ``python -m repro_torch.analysis [paths]`` (defaults to
``src/repro_torch``); suppress single findings with
``# repro: disable=RULE`` comments (:mod:`repro_torch.analysis.findings`).
The contract pass also runs at ``register_operator()`` time when
``REPRO_CHECK_CONTRACTS`` is set.  Nothing here needs a card.
"""

from __future__ import annotations

from repro_torch.analysis.findings import (  # noqa: F401
    Finding, SEVERITIES, apply_suppressions, parse_suppressions,
    render_json, render_pretty)

#: pass name -> module path; order is report order.  Imported on first
#: use (:func:`get_pass`), so ``--passes=retrace`` imports no torch.
PASSES = {
    "retrace": "repro_torch.analysis.retrace",
    "contracts": "repro_torch.analysis.contracts",
    "capabilities": "repro_torch.analysis.capabilities",
    "smem": "repro_torch.analysis.smem",
    "schedules": "repro_torch.analysis.schedules",
}


def get_pass(name: str):
    """Import and return one pass module by registry name."""
    import importlib
    try:
        modpath = PASSES[name]
    except KeyError:
        raise KeyError(
            f"unknown pass {name!r}; available: {sorted(PASSES)}") from None
    return importlib.import_module(modpath)


def run_all(paths, passes=None) -> list:
    """Run the named passes (default: all) over ``paths``; returns the
    concatenated, unsuppressed findings."""
    findings: list = []
    for name in (passes or PASSES):
        findings.extend(get_pass(name).run(paths))
    return findings
