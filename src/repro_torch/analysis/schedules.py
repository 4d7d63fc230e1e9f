"""Schedule-consistency checker (rules SC001–SC003), the port of
:mod:`repro.analysis.schedules`.

The :class:`~repro_torch.core.schedule.Schedule` dataclass is the one
declarative source of the work-assignment knobs (worklist floors, MDT,
AD's thresholds, delta-stepping's Δ).  Two conventions make it worth
having, and this pass checks them:

* every field is read by some lowering — a field nobody reads is dead
  configuration that claims to control behaviour it does not;
* every reader spells the field names right — an attribute read on a
  frozen dataclass raises only when that path runs.

Three rules:

* **SC001 — dead schedule field**: a ``Schedule`` field that no scanned
  file reads through a schedule-named receiver.  The reference's Pallas
  block shapes (:data:`repro_torch.core.schedule.CARRIED_FIELDS`) are
  declared as carried for the round trip and are not counted.
* **SC002 — unknown schedule attribute**: an attribute read on a
  schedule-named receiver (``sched``, ``schedule``, ``*_schedule``, or a
  trailing ``.schedule`` chain) that is neither a field nor a public
  method or property.
* **SC003 — schedule round-trip failure**: a registered strategy's
  default schedule does not survive ``to_json``/``from_json`` or
  ``to_dict``/``from_dict`` (:meth:`Schedule.to_json`,
  :meth:`Schedule.to_dict`) bit for bit; the calibration cache of
  :mod:`repro_torch.core.costmodel` keys on the JSON form.

SC001/SC002 are static AST scans over the given paths; SC003 inspects the
live registry.  The receiver-name rule is narrow on purpose: a variable
holding a schedule under another name is invisible to SC001/SC002.
"""

from __future__ import annotations

import ast
import inspect
from pathlib import Path

from repro_torch.analysis.findings import RUNTIME_FILE, Finding

PASS_NAME = "schedules"
RULES = ("SC001", "SC002", "SC003")

#: receiver identifiers treated as schedule-typed.  Exact names; a
#: trailing ``_schedule`` suffix (``work_schedule``) also matches.
_RECEIVER_NAMES = frozenset({"sched", "schedule"})


def schedule_vocabulary() -> tuple:
    """``(fields, allowed_attrs)``: the dataclass fields, and the public
    attribute surface (fields + methods/properties) a reader may touch."""
    from repro_torch.core.schedule import SCHEDULE_FIELDS, Schedule
    allowed = frozenset(
        name for name in dir(Schedule) if not name.startswith("_"))
    return SCHEDULE_FIELDS, allowed | frozenset(SCHEDULE_FIELDS)


def _anchor() -> tuple:
    """(file, line) of the Schedule class definition, best effort."""
    from repro_torch.core import schedule
    try:
        file = inspect.getsourcefile(schedule) or RUNTIME_FILE
        line = inspect.getsourcelines(schedule.Schedule)[1]
    except (OSError, TypeError):
        file, line = RUNTIME_FILE, 0
    return file, line


def _receiver_name(node: ast.AST):
    """The terminal identifier of an attribute receiver, or None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _is_schedule_receiver(name) -> bool:
    if name is None:
        return False
    return name in _RECEIVER_NAMES or name.endswith("_schedule")


def scan_file(path, text=None) -> tuple:
    """``(findings, fields_read)`` for one source file: its SC002
    findings, and the fields it reads through a schedule-named receiver
    (SC001's evidence, gathered by :func:`run`)."""
    path = Path(path)
    if text is None:
        text = path.read_text(encoding="utf-8")
    try:
        tree = ast.parse(text, filename=str(path))
    except SyntaxError:
        return [], set()  # the retrace pass reports RT000 for these
    fields, allowed = schedule_vocabulary()
    field_set = frozenset(fields)
    findings: list = []
    fields_read: set = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Attribute):
            continue
        if not _is_schedule_receiver(_receiver_name(node.value)):
            continue
        if node.attr in field_set:
            fields_read.add(node.attr)
        elif node.attr not in allowed and not node.attr[:1].isupper():
            # uppercase attrs are module accesses (schedule.Schedule,
            # schedule.DEFAULT_SCHEDULE), not dataclass field reads
            findings.append(Finding(
                rule="SC002",
                message=(
                    f"schedule attribute {node.attr!r} is not a Schedule "
                    f"field or method — this raises AttributeError the "
                    f"first time the lowering path runs (fields: "
                    f"{', '.join(fields)})"),
                file=str(path), line=node.lineno,
                hint=("fix the field name, or rename the receiver if it "
                      "is not a repro_torch.core.schedule.Schedule")))
    return findings, fields_read


def check_dead_fields(fields_read) -> list:
    """SC001: fields the whole scan never saw read, less the carried
    ones."""
    from repro_torch.core.schedule import CARRIED_FIELDS
    fields, _ = schedule_vocabulary()
    dead = [f for f in fields
            if f not in fields_read and f not in CARRIED_FIELDS]
    if not dead:
        return []
    file, line = _anchor()
    return [Finding(
        rule="SC001",
        message=(
            f"Schedule field(s) {', '.join(repr(f) for f in dead)} are "
            f"never read by any scanned lowering — dead configuration "
            f"that claims to control behaviour it does not"),
        file=file, line=line,
        hint=("thread the field into the strategy/kernel that should "
              "honour it, or remove it from Schedule (the JSON form, and "
              "so the costmodel cache key, changes)"))]


def check_roundtrips() -> list:
    """SC003 over every registered strategy's default schedule."""
    from repro_torch.core.schedule import (DEFAULT_SCHEDULE, Schedule,
                                           default_schedule)
    from repro_torch.core.strategies import STRATEGIES

    file, line = _anchor()
    findings: list = []
    seen = {"<default>": DEFAULT_SCHEDULE}
    for name in sorted(STRATEGIES):
        seen[name] = default_schedule(name)
    for name, sched in seen.items():
        problems = []
        try:
            via_json = Schedule.from_json(sched.to_json())
            if via_json != sched or hash(via_json) != hash(sched):
                problems.append("to_json/from_json is lossy")
        except Exception as exc:  # noqa: BLE001 - report, don't crash
            problems.append(f"to_json/from_json raised {exc!r}")
        try:
            via_dict = Schedule.from_dict(sched.to_dict())
            if via_dict != sched:
                problems.append("to_dict/from_dict is lossy")
        except Exception as exc:  # noqa: BLE001
            problems.append(f"to_dict/from_dict raised {exc!r}")
        for problem in problems:
            findings.append(Finding(
                rule="SC003",
                message=(
                    f"default schedule of strategy {name!r} does not "
                    f"survive serialisation: {problem} — the calibration "
                    f"cache keys on the JSON form, so distinct schedules "
                    f"would alias onto one cache entry"),
                file=file, line=line,
                hint=("make every Schedule field a JSON-stable scalar "
                      "(ints, canonicalised floats, None) and keep "
                      "to_dict/from_dict symmetric")))
    return findings


def run(paths) -> list:
    """The full schedule pass: round trips + dead-field/typo scan."""
    findings = check_roundtrips()
    fields_read: set = set()
    for p in paths:
        p = Path(p)
        for f in (sorted(p.rglob("*.py")) if p.is_dir() else [p]):
            file_findings, file_fields = scan_file(f)
            findings.extend(file_findings)
            fields_read |= file_fields
    findings.extend(check_dead_fields(fields_read))
    return findings
