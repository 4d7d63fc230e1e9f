"""Finding records, suppression handling and reporters (a copy of
:mod:`repro.analysis.findings`, so that both packages read the same
suppression comments and write the same reports).

The shared vocabulary of every :mod:`repro_torch.analysis` pass: a pass is a
callable returning a list of :class:`Finding` records, each anchored to
a ``file:line`` with a rule id, severity and a fix hint.  The runner
(:mod:`repro_torch.analysis.__main__`) filters findings through per-file
suppression comments before reporting.

Suppression syntax (docs/analysis.md):

* ``# repro: disable=RT001`` on a line *with code* suppresses the named
  rule(s) for that line only;
* the same comment on a line *of its own* suppresses the rule(s) for the
  whole file;
* several rules may be listed: ``# repro: disable=RT001,CT002``.

Suppressions are part of the reviewed source — the pretty reporter
prints how many findings each file suppressed so a
``disable=``-everything file cannot hide silently.
"""

from __future__ import annotations

import dataclasses
import json
import re
from collections import Counter
from pathlib import Path
from typing import Iterable, Optional

#: severity levels, in increasing order of badness.  Only ``error``
#: findings fail the CLI (and CI); ``warning`` findings are reported but
#: non-blocking, for rules whose static evidence is circumstantial.
SEVERITIES = ("warning", "error")

#: file anchor used when a finding concerns a runtime object (a
#: registered operator or strategy) whose defining file could not be
#: resolved — e.g. a class built inside a test.
RUNTIME_FILE = "<runtime>"

_SUPPRESS_RE = re.compile(r"#\s*repro:\s*disable=([A-Za-z0-9_,\- ]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analysis result: what rule fired, where, and how to fix it."""

    rule: str                 # rule id, e.g. "RT001"
    message: str              # what is wrong, with concrete evidence
    file: str                 # path (repo-relative when possible)
    line: int                 # 1-based; 0 = whole-file / no anchor
    severity: str = "error"
    hint: str = ""            # how to fix (or legitimately suppress)

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, "
                f"got {self.severity!r}")

    def location(self) -> str:
        return f"{self.file}:{self.line}" if self.line else self.file

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Suppressions:
    """Parsed ``# repro: disable=`` comments of one source file."""

    file_rules: frozenset           # rules disabled for the whole file
    line_rules: dict                # line (1-based) -> frozenset of rules

    def covers(self, finding: Finding) -> bool:
        if finding.rule in self.file_rules:
            return True
        return finding.rule in self.line_rules.get(finding.line, ())


def parse_suppressions(text: str) -> Suppressions:
    """Extract suppression comments from source text (see module doc)."""
    file_rules: set = set()
    line_rules: dict = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = frozenset(
            r.strip() for r in m.group(1).split(",") if r.strip())
        before = line[: m.start()].strip()
        if not before:                      # standalone comment line
            file_rules |= rules
        else:                               # trailing comment on code
            line_rules[lineno] = line_rules.get(lineno, frozenset()) | rules
    return Suppressions(frozenset(file_rules), line_rules)


def apply_suppressions(findings: Iterable[Finding]) -> tuple[list, int]:
    """Filter findings through their files' suppression comments.

    Returns ``(kept, suppressed_count)``.  Files that cannot be read
    (runtime anchors, deleted files) suppress nothing.
    """
    cache: dict[str, Suppressions] = {}
    kept: list[Finding] = []
    suppressed = 0
    for f in findings:
        if f.file not in cache:
            try:
                cache[f.file] = parse_suppressions(
                    Path(f.file).read_text(encoding="utf-8"))
            except OSError:
                cache[f.file] = Suppressions(frozenset(), {})
        if cache[f.file].covers(f):
            suppressed += 1
        else:
            kept.append(f)
    return kept, suppressed


# ---------------------------------------------------------------------------
# reporters
# ---------------------------------------------------------------------------

def render_pretty(findings: list, *, suppressed: int = 0,
                  passes: Optional[list] = None) -> str:
    """Human-readable report, one ``file:line: [RULE] message`` per
    finding, sorted by location, with the fix hint indented below."""
    lines = []
    for f in sorted(findings, key=lambda f: (f.file, f.line, f.rule)):
        lines.append(f"{f.location()}: {f.severity}: [{f.rule}] {f.message}")
        if f.hint:
            lines.append(f"    hint: {f.hint}")
    counts = Counter(f.rule for f in findings)
    summary = ", ".join(f"{r}={n}" for r, n in sorted(counts.items()))
    ran = f" (passes: {', '.join(passes)})" if passes else ""
    lines.append(
        f"{len(findings)} finding(s){', ' + summary if summary else ''}"
        f", {suppressed} suppressed{ran}")
    return "\n".join(lines)


def render_json(findings: list, *, suppressed: int = 0,
                passes: Optional[list] = None) -> str:
    """Machine-readable report, in the reference's format."""
    counts = Counter(f.rule for f in findings)
    return json.dumps({
        "version": 1,
        "passes": list(passes or []),
        "counts": dict(sorted(counts.items())),
        "total": len(findings),
        "suppressed": suppressed,
        "findings": [f.to_dict() for f in sorted(
            findings, key=lambda f: (f.file, f.line, f.rule))],
    }, indent=2)
