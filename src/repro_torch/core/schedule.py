"""Work-assignment schedules (a numpy-only copy of
:mod:`repro.core.schedule`, so that the two packages serialise a schedule
alike).

A :class:`Schedule` says how one iteration's relax work is shaped: the
worklist capacity floor, HP's MDT policy and switch threshold, AD's
decision thresholds, delta-stepping's bucket width, and the Pallas block
shapes ``tile_r``/``tile_c``/``chunk``.  The CUDA kernels of this package
do not read the Pallas block shapes; they stay as fields so a schedule
round-trips between the two packages unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

#: pre-extraction defaults, frozen here so the golden-parity tests can
#: say "the default Schedule IS the old constants" in one place
_DEFAULTS = dict(min_bucket=256, tile_r=8, tile_c=128, chunk=128)

#: TPU VPU lane width every last-dimension block size must divide into
#: (mirrors repro.analysis.vmem.LANE without importing it)
LANE = 128


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Declarative work-assignment description for one traversal.

    Frozen + hashable on purpose: a ``Schedule`` is passed whole as a
    single static argument to the fused/priority/sharded jits, so equal
    schedules share one compiled executable and a changed field is a
    deliberate recompile.  All fields are plain Python scalars — never
    put arrays here.

    Worklist / driver fields
      ``min_bucket``        power-of-two floor of the capacity buckets
                            (``worklist.bucket(n, minimum=...)``)
    NS / HP MDT policy
      ``mdt``               maximum degree threshold; ``None`` = derive
                            from the degree histogram at ``setup``
                            (``node_split.find_mdt``)
      ``histogram_bins``    bins of that derivation
      ``switch_threshold``  HP's hybrid fallback: frontiers at or below
                            it take the straight-WD path
    AD decision thresholds (the fixed arXiv:1911.09135 tree; ignored
    when a measured :mod:`repro.core.costmodel` drives the choice)
      ``small_frontier``, ``imbalance_threshold``, ``hp_edges_threshold``
    Priority (delta-stepping) policy
      ``delta``             bucket width; ``None`` = auto
                            (``delta_multiplier × mean weight``, ≥ 1)
      ``delta_multiplier``  the auto rule's multiplier
    Pallas block/lane shapes (``repro.kernels.relax``)
      ``tile_r`` × ``tile_c``  work items per grid step (the VPU vector
                            registers); ``tile_c`` must be a multiple
                            of the 128 lane width
      ``chunk``             table chunk streamed per broadcast-compare
                            pass; multiple of 128
    """

    # worklist / stepped drivers
    min_bucket: int = _DEFAULTS["min_bucket"]
    # NS / HP MDT policy
    mdt: Optional[int] = None
    histogram_bins: int = 10
    switch_threshold: int = 1024
    # AD fixed decision tree thresholds
    small_frontier: int = 512
    imbalance_threshold: float = 4.0
    hp_edges_threshold: int = 1 << 15
    # priority (delta-stepping) policy
    delta: Optional[int] = None
    delta_multiplier: int = 4
    # Pallas block/lane shapes
    tile_r: int = _DEFAULTS["tile_r"]
    tile_c: int = _DEFAULTS["tile_c"]
    chunk: int = _DEFAULTS["chunk"]

    def __post_init__(self):
        for name in ("min_bucket", "histogram_bins", "switch_threshold",
                     "small_frontier", "hp_edges_threshold",
                     "delta_multiplier", "tile_r", "tile_c", "chunk"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(
                    f"Schedule.{name} must be a positive int, got {v!r}")
        for name in ("mdt", "delta"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int)
                                  or isinstance(v, bool) or v < 1):
                raise ValueError(
                    f"Schedule.{name} must be None or a positive int, "
                    f"got {v!r}")
        if self.min_bucket & (self.min_bucket - 1):
            raise ValueError(
                f"Schedule.min_bucket must be a power of two, got "
                f"{self.min_bucket}")
        for name in ("tile_c", "chunk"):
            v = getattr(self, name)
            if v % LANE:
                raise ValueError(
                    f"Schedule.{name} must be a multiple of the {LANE} "
                    f"lane width, got {v}")
        # the fused AD selector compares imbalance in float32 on device;
        # canonicalize so host and device hold the same representable
        # value and can never disagree within one rounding step
        object.__setattr__(self, "imbalance_threshold",
                           float(np.float32(self.imbalance_threshold)))

    # -- derived -----------------------------------------------------------

    @property
    def tile(self) -> int:
        """Work items per Pallas grid step (``tile_r × tile_c``)."""
        return self.tile_r * self.tile_c

    def resolve_mdt(self, degrees) -> int:
        """The concrete MDT for a degree array: the declared ``mdt`` or
        the histogram derivation (``node_split.find_mdt``)."""
        if self.mdt is not None:
            return int(self.mdt)
        from repro_torch.core import node_split
        return int(node_split.find_mdt(np.asarray(degrees),
                                       self.histogram_bins))

    def resolved(self, degrees) -> "Schedule":
        """A copy with ``mdt`` made concrete for ``degrees`` — what the
        fused/priority/sharded lowerings receive as their static."""
        return dataclasses.replace(self, mdt=self.resolve_mdt(degrees))

    def replace(self, **overrides) -> "Schedule":
        """``dataclasses.replace`` convenience (re-validates)."""
        return dataclasses.replace(self, **overrides)

    # -- lossless serialization -------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Schedule":
        known = {f.name for f in dataclasses.fields(cls)}
        bad = set(d) - known
        if bad:
            raise ValueError(
                f"unknown Schedule fields {sorted(bad)}; known: "
                f"{sorted(known)}")
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Schedule":
        return cls.from_dict(json.loads(s))


#: the pre-extraction constants as one immutable value; lowerings use it
#: as the default so zero-config callers get bit-identical behaviour
DEFAULT_SCHEDULE = Schedule()

#: every field name, in declaration order — the schedule-consistency
#: analysis pass (repro_torch.analysis.schedules) checks each is actually read
#: by some lowering
SCHEDULE_FIELDS = tuple(f.name for f in dataclasses.fields(Schedule))

#: the reference's Pallas block shapes: carried so that a schedule
#: round-trips between the two packages, read by no lowering of this one
#: (the schedules pass does not count them as dead)
CARRIED_FIELDS = ("tile_r", "tile_c", "chunk")


def default_schedule(strategy_name: str) -> Schedule:
    """The default :class:`Schedule` of a registered strategy.

    All built-ins currently share :data:`DEFAULT_SCHEDULE` (the
    pre-extraction constants); the hook exists so a strategy — or an
    autotuner (:mod:`repro.core.costmodel`) — can register a tuned
    default without touching driver code."""
    return SCHEDULE_DEFAULTS.get(strategy_name, DEFAULT_SCHEDULE)


#: per-strategy default overrides; see :func:`default_schedule`
SCHEDULE_DEFAULTS: dict[str, Schedule] = {}


def resolve_overrides(name: str, schedule: Optional[Schedule],
                      **overrides) -> Schedule:
    """Constructor-kwarg precedence shared by every strategy:
    explicit non-``None`` kwarg > supplied ``schedule`` > the strategy's
    default.  Keeps historical call sites
    (``make_strategy("HP", switch_threshold=4, mdt=3)``) working
    unchanged alongside ``make_strategy("HP", schedule=...)``."""
    base = schedule if schedule is not None else default_schedule(name)
    explicit = {k: v for k, v in overrides.items() if v is not None}
    return dataclasses.replace(base, **explicit) if explicit else base
