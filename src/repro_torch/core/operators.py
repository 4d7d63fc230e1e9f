"""Composable edge operators: algorithm semantics apart from the
load-balancing schedule (the port of :mod:`repro.core.operators`).

An :class:`EdgeOp` is a per-edge ``message`` plus a commutative monoid
(``combine`` ∈ min/max/add with neutral ``identity``) that folds messages
into the destination's value, and an activation predicate
(:meth:`EdgeOp.improves`).  Callables take values of the operator's
``dtype`` and int32 weights, as the reference passes them.

The hand-written CUDA relax kernels cannot call Python, so
:meth:`EdgeOp.kernel_codes` maps the built-in message functions (by
identity) and ``combine`` to the integer codes the kernels switch on.  An
operator with a message of its own or an ``update`` predicate, and every
operator of another value type than int32, takes the code
:data:`MSG_CUSTOM`: on CUDA tensors its callables are lowered to C++
(:mod:`repro_torch.kernels.opgen`) and the kernels are built once more
for it, with its value type, at first use (``kernels._build.custom_lib``).

The value type (:func:`value_dtype`) is the operator's ``dtype``, except
that float64 and int64 run as float32 and int32: the reference runs them
so (JAX with x64 off), and the port returns its answers, not float64's.
A bfloat16 ``dist`` reaches the host as a float32 array that holds the
exact bfloat16 values (:func:`host_values`: numpy has no bfloat16).

A float ``min`` or ``max`` (float32, bfloat16, float16) folds as IEEE
754-2019 ``minimum`` and ``maximum`` do, and as the reference's
``.at[].min/max`` does: −0.0 ranks below +0.0 and a NaN absorbs every
other value (:meth:`EdgeOp.scatter`, :meth:`EdgeOp.fold_values`).  Float
``add`` depends on the order of its terms, on the card (a
compare-and-swap of the rounded sum) as in the reference.  Integer
``add`` wraps at the value type's width.

Built-ins (same semantics as the reference):

=================  =======  ========  ===============  ======================
operator           combine  identity  message(v, w)    computes
=================  =======  ========  ===============  ======================
``shortest_path``  min      INF       ``v + w``        SSSP / BFS levels
``min_label``      min      INF       ``v``            CC labels
``widest_path``    max      0         ``min(v, w)``    max-min bottleneck
``reach_count``    add      0         ``v``            path counts on
                                                       layered DAGs
=================  =======  ========  ===============  ======================
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.graph import INF

_COMBINES = ("min", "max", "add")

#: combine codes shared with kernels/csrc/relax.cu (COMB_*)
KERNEL_COMBINES = {"min": 0, "max": 1, "add": 2}

_SCATTER_REDUCE = {"min": "amin", "max": "amax", "add": "sum"}

#: why ``add`` with a nonzero identity has no kernel: the reference's
#: answer for it depends on its schedule, so there is nothing to port
ADD_IDENTITY_FAULT = ("ROADMAP.md queue C, \"The reference's faults\": add "
                      "with a nonzero identity")

#: the value types the CUDA kernels are built for
KERNEL_DTYPES = (torch.int32, torch.float32, torch.bfloat16, torch.float16,
                 torch.int16, torch.int8, torch.uint8)

#: the value type a 64-bit operator runs in, as the reference (JAX with
#: x64 off) runs it
_NARROWED = {torch.float64: torch.float32, torch.int64: torch.int32}

#: the NaN a float fold writes where a candidate is NaN, by the value
#: type's width in bits and by combine: the card's fold keeps it against
#: every later candidate (``fold`` in kernels/csrc/relax_lanes.cuh), and
#: the plain fold writes the same
FOLD_NAN_BITS = {32: {"min": -1, "max": 0x7FFFFFFF},
                 16: {"min": -1, "max": 0x7FFF}}

#: the integer type whose bits a float type's values are viewed as
_BITS_DTYPE = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
               torch.float16: torch.int16}


def value_dtype(op: "EdgeOp") -> torch.dtype:
    """The type of ``op``'s values: its ``dtype``, but float32 for
    float64 and int32 for int64, as the reference (JAX with x64 off)
    runs them.  Every ``dist`` of a run is allocated with it."""
    return _NARROWED.get(op.dtype, op.dtype)


def host_values(values: torch.Tensor) -> np.ndarray:
    """``values`` as a numpy array on the host: the same dtype, except
    that bfloat16 (which numpy lacks) widens to float32, exactly (NaN and
    −0.0 kept)."""
    values = values.cpu()
    if values.dtype == torch.bfloat16:
        values = values.float()
    return values.numpy()


@dataclasses.dataclass(frozen=True)
class EdgeOp:
    """One relax-style algorithm, expressed as message + monoid."""

    name: str
    #: the fold monoid: "min" | "max" | "add"
    combine: str
    #: neutral element of ``combine``; also the "unreached" value
    identity: float
    #: value seeded at an active source; ``None`` = the node's own id
    source_value: Optional[float]
    #: ``(val_src, w) -> candidate``: values of ``dtype``, int32 weights
    message: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    #: optional activation override ``(candidate, current) -> bool``
    update: Optional[Callable[[torch.Tensor, torch.Tensor],
                              torch.Tensor]] = None
    dtype: torch.dtype = torch.int32
    #: delta-stepping hint, as in the reference: a candidate over an edge
    #: of weight w lands at least w past its source, so heavy edges can be
    #: deferred (``priority.plan_delta`` splits only such operators)
    weight_additive: bool = False
    #: lower bound of the value domain, as in the reference
    value_min: Optional[float] = None

    def __post_init__(self):
        if self.combine not in _COMBINES:
            raise ValueError(
                f"combine must be one of {_COMBINES}, got {self.combine!r}")

    def improves(self, cand: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
        """Does ``cand`` constitute progress over ``cur`` (activate dst)?"""
        if self.update is not None:
            return self.update(cand, cur)
        if self.combine == "min":
            return cand < cur
        if self.combine == "max":
            return cand > cur
        return cand != self.identity          # add: any real contribution

    def scatter(self, dist: torch.Tensor, dst: torch.Tensor,
                cand: torch.Tensor, improve: torch.Tensor) -> torch.Tensor:
        """Fold improving candidates into ``dist[dst]`` **in place** and
        return ``dist``.  Masked lanes contribute ``identity``, which is
        neutral for the monoid.  A float ``min``/``max`` folds by
        :func:`_scatter_ordered`: ``scatter_reduce_`` would keep whichever
        of −0.0 and +0.0 comes first."""
        vals = torch.where(improve, cand, self.identity).to(dist.dtype)
        # a message wider than the values (int16 + int32 weights) is
        # narrowed before the fold, as the reference's .at[] casts it
        if dist.is_floating_point() and self.combine != "add":
            return _scatter_ordered(dist, dst.long(), vals, self.combine)
        return dist.scatter_reduce_(0, dst.long(), vals,
                                    _SCATTER_REDUCE[self.combine],
                                    include_self=True)

    def fold_values(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The monoid of ``a`` and ``b`` elementwise.  A float ``min`` or
        ``max`` of −0.0 and +0.0 gives −0.0 or +0.0 whatever their order
        (``torch.minimum``/``maximum`` return either, by the loop that
        evaluates the element); NaN propagates."""
        if self.combine == "add":
            return a + b
        low = self.combine == "min"
        out = (torch.minimum if low else torch.maximum)(a, b)
        if a.is_floating_point():
            neg = (a.signbit() | b.signbit()) if low else \
                (a.signbit() & b.signbit())
            out = torch.where((a == 0) & (b == 0),
                              torch.where(neg, -0.0, 0.0).to(out.dtype), out)
        return out

    def seed(self, source: int) -> int:
        """Initial value planted at an active source."""
        return source if self.source_value is None else self.source_value

    @property
    def idempotent(self) -> bool:
        return self.combine in ("min", "max")

    def kernel_codes(self) -> tuple[int, int, torch.dtype]:
        """``(message code, combine code, value type)`` for the CUDA
        kernels: an int32 operator (or an int64 one, which runs as int32)
        whose message is a built-in one and which has no ``update`` keeps
        its message's code (:data:`KERNEL_MESSAGES`); any other operator
        takes :data:`MSG_CUSTOM` and runs its lowered callables (a build of
        its own, for its value type, :func:`value_dtype`).  Raises
        ``NotImplementedError`` for what no kernel takes: a value type
        outside :data:`KERNEL_DTYPES`, or ``add`` with a nonzero identity
        (:data:`ADD_IDENTITY_FAULT`)."""
        dtype = value_dtype(self)
        if dtype not in KERNEL_DTYPES:
            raise NotImplementedError(
                f"operator {self.name!r} ({self.dtype}): the CUDA relax "
                f"kernels take values of "
                f"{', '.join(str(d) for d in KERNEL_DTYPES)}")
        if self.combine == "add" and self.identity != 0:
            # every masked lane adds the identity, so the reference's
            # answer depends on its schedule: no fold to port
            raise NotImplementedError(
                f"operator {self.name!r}: add with the nonzero identity "
                f"{self.identity} is not a monoid fold, in the reference "
                f"either ({ADD_IDENTITY_FAULT}); run it with device='cpu'")
        msg = KERNEL_MESSAGES.get(self.message)
        if msg is None or self.update is not None or dtype != torch.int32:
            msg = MSG_CUSTOM
        return msg, KERNEL_COMBINES[self.combine], dtype


def _order_keys(bits: torch.Tensor, width: int) -> torch.Tensor:
    """The bits of floats ``width`` wide (as int32, sign-extended) to int32
    keys in the values' order, −0.0 below +0.0: the negative values' bits
    reflected.  The same map takes keys back to bits."""
    return torch.where(bits < 0, bits ^ ((1 << (width - 1)) - 1), bits)


def _scatter_ordered(dist: torch.Tensor, dst: torch.Tensor,
                     vals: torch.Tensor, combine: str) -> torch.Tensor:
    """``dist[dst]`` folded with ``vals`` by IEEE 754-2019 ``minimum``
    (``maximum``), in place, at the width of ``dist``'s float type: as the
    reference's ``.at[].min/max`` and the card's fold, whatever the order
    of the lanes.  An entry that was NaN stays as it was; one that takes a
    NaN becomes :data:`FOLD_NAN_BITS`."""
    reduce = _SCATTER_REDUCE[combine]
    neutral = 2 ** 31 - 1 if combine == "min" else -2 ** 31
    bits_dtype = _BITS_DTYPE[dist.dtype]
    width = torch.iinfo(bits_dtype).bits
    bits = dist.view(bits_dtype)
    was_nan, nan = torch.isnan(dist), torch.isnan(vals)
    keys = _order_keys(bits.to(torch.int32), width).masked_fill(was_nan,
                                                                neutral)
    keys.scatter_reduce_(0, dst, _order_keys(
        vals.view(bits_dtype).to(torch.int32), width).masked_fill(
            nan, neutral), reduce, include_self=True)
    took_nan = torch.zeros(dist.shape, dtype=torch.uint8,
                           device=dist.device).scatter_reduce_(
        0, dst, nan.to(torch.uint8), "amax").bool()
    out = torch.where(took_nan, FOLD_NAN_BITS[width][combine],
                      _order_keys(keys, width)).to(bits_dtype)
    bits.copy_(torch.where(was_nan, bits, out))
    return dist


def _sum_message(v, w):
    return v + w


def _copy_message(v, w):
    return v


def _bottleneck_message(v, w):
    return torch.minimum(v, w)


#: message codes shared with kernels/csrc/relax_lanes.cuh (MSG_*), keyed
#: by the built-in message functions themselves
KERNEL_MESSAGES = {_sum_message: 0, _copy_message: 1, _bottleneck_message: 2}
#: the message code of an operator whose callables are lowered to C++
#: (``MSG_CUSTOM``)
MSG_CUSTOM = 3


shortest_path = EdgeOp(
    name="shortest_path", combine="min", identity=INF, source_value=0,
    message=_sum_message, weight_additive=True)

min_label = EdgeOp(
    name="min_label", combine="min", identity=INF, source_value=None,
    message=_copy_message)

widest_path = EdgeOp(
    name="widest_path", combine="max", identity=0, source_value=INF,
    message=_bottleneck_message, value_min=0)

reach_count = EdgeOp(
    name="reach_count", combine="add", identity=0, source_value=1,
    message=_copy_message)

#: name -> operator; extended via :func:`register_operator`
OPERATORS: dict[str, EdgeOp] = {
    op.name: op
    for op in (shortest_path, min_label, widest_path, reach_count)
}


def register_operator(op: EdgeOp) -> EdgeOp:
    """Add a user-defined operator to :data:`OPERATORS` (name must be new).

    With ``REPRO_CHECK_CONTRACTS`` set (non-empty, not ``0``) the operator
    is first held to the monoid laws its declarations promise (the
    :mod:`repro_torch.analysis.contracts` pass, as the reference runs it
    at registration) and refused with the findings when it breaks them.
    Off by default: the int8-domain sweep costs a fraction of a second an
    operator."""
    if not isinstance(op, EdgeOp):
        raise TypeError(f"{op!r} is not an EdgeOp")
    if op.name in OPERATORS:
        raise ValueError(f"operator {op.name!r} already registered")
    if os.environ.get("REPRO_CHECK_CONTRACTS", "0") not in ("", "0"):
        from repro_torch.analysis import contracts

        errors = [f for f in contracts.check_operator(op)
                  if f.severity == "error"]
        if errors:
            detail = "; ".join(f"[{f.rule}] {f.message}" for f in errors)
            raise ValueError(
                f"operator {op.name!r} fails its declared contracts "
                f"(REPRO_CHECK_CONTRACTS is set): {detail}")
    OPERATORS[op.name] = op
    return op


def resolve(op) -> EdgeOp:
    """Accept an :class:`EdgeOp` or a registered name, return the EdgeOp."""
    if isinstance(op, EdgeOp):
        return op
    try:
        return OPERATORS[op]
    except (KeyError, TypeError):
        raise KeyError(f"unknown operator {op!r}; registered: "
                       f"{sorted(OPERATORS)}") from None
