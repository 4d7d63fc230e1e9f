"""The closed-form cost of B4 and B5 calls, and the counter that their
meta branches feed.

Each of :func:`attention_cost`, :func:`attention_bwd_cost`,
:func:`ssd_cost` and :func:`ssd_bwd_cost` gives ``(bytes, FLOPs)`` of one
kernel call: the bytes the call must move (each input read once, each
output written once) and the products it does over the pairs the kernel
keeps (a causal call skips the masked half).  ``chip_smoke.py`` bounds
each kernel's time by them, and the wrappers' meta branches (the dry run's
abstract step, :mod:`repro_torch.launch.dryrun`) add them to the
:class:`KernelCounter` of :func:`count_kernels` instead of launching.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses


# ---------------------------------------------------------------------------
# the kernels' closed forms: (bytes, FLOPs) of one call
# ---------------------------------------------------------------------------

def attention_cost(S: int, dtype, causal: bool, heads, Sk=None) -> tuple:
    """(bytes, operations) of one B4 call at the path's heads: q, k, v
    read once and out written once; 2 FLOP per multiply-add of QK^T (hd)
    and PV (hd_v) over the (query, key) pairs the mask keeps (causal:
    S = Sk, top-left)."""
    hq, hkv, hd, *rest = heads
    hd_v, Sk = (rest[0] if rest else hd), Sk or S
    size = 2 if str(dtype).endswith("bfloat16") else 4
    nbytes = size * (hq * S * (hd + hd_v) + hkv * Sk * (hd + hd_v))
    pairs = S * (S + 1) // 2 if causal else S * Sk
    return nbytes, 2 * hq * pairs * (hd + hd_v)


def attention_bwd_cost(heads, B: int, S: int, Sk: int, causal: bool,
                       dtype) -> tuple:
    """(bytes, operations) of one B4 backward call: q, k, v, out, dout
    and lse read once, dq, dk, dv written once; per kept (query, key)
    pair the recomputed logits (hd), dV (hd_v), dP (hd_v), dQ and dK
    (hd each), 2 FLOP a multiply-add."""
    hq, hkv, hd, hd_v = heads
    size = 2 if str(dtype).endswith("bfloat16") else 4
    nbytes = B * (size * (2 * hq * S * (hd + hd_v) + 2 * hkv * Sk
                          * (hd + hd_v)) + 4 * hq * S)
    pairs = S * (S + 1) // 2 if causal else S * Sk
    return nbytes, 2 * B * hq * pairs * (3 * hd + 2 * hd_v)


def ssd_cost(BN, c, H, P, N, dtype) -> tuple:
    """(bytes, operations) of one B5 call: x̄, cum, B, C read once, y and
    the states written once (f32); C·B's causal half once per chunk (it
    is shared by the heads), and per head M·x̄'s causal half and the
    state product, 2 FLOP per multiply-add."""
    size = 2 if str(dtype).endswith("bfloat16") else 4
    nbytes = (size * BN * c * (H * P + 2 * N) + 4 * BN * c * H
              + 4 * BN * c * H * P + 4 * BN * H * N * P)
    tri = c * (c + 1) // 2
    ops = BN * tri * N * 2 + BN * H * (tri * P * 2 + c * N * P * 2)
    return nbytes, ops


def ssd_bwd_cost(BN, c, H, P, N, dtype) -> tuple:
    """(bytes, operations) of one B5 backward call: x̄, cum, B, C, dy and
    dstate read once, dx̄, dcum, dB and dC written once; C·B's causal half
    once a chunk and dCB's two products with B and C (the heads' dCB
    summed first), and per head dM and Mᵀdy over the causal half and the
    state's two products, 2 FLOP a multiply-add."""
    size = 2 if str(dtype).endswith("bfloat16") else 4
    nbytes = (2 * size * BN * c * (H * P + 2 * N)
              + 4 * BN * c * H * (P + 2) + 4 * BN * H * N * P)
    tri = c * (c + 1) // 2
    ops = 2 * BN * (3 * tri * N + H * (2 * tri * P + 2 * c * N * P))
    return nbytes, ops


def _top_left_pairs(Sq: int, Sk: int) -> int:
    """(query, key) pairs a top-left causal mask keeps: query i sees keys
    j <= i, at most Sk of them."""
    if Sq <= Sk:
        return Sq * (Sq + 1) // 2
    return Sk * (Sk + 1) // 2 + (Sq - Sk) * Sk


def attention_call_cost(B, Hq, Hkv, Sq, Sk, hd, hd_v, causal, dtype,
                        backward: bool = False) -> tuple:
    """(bytes, FLOPs) of one B4 call of batch B, forward or backward: the
    closed forms above (:func:`attention_cost` per batch row).  Where a
    causal call has more queries than keys (``Sq > Sk``, which no model
    makes) the closed forms' ``S(S+1)/2`` pairs become the kept pairs of
    :func:`_top_left_pairs`."""
    heads = (Hq, Hkv, hd, hd_v)
    if backward:
        nbytes, flops = attention_bwd_cost(heads, B, Sq, Sk, causal, dtype)
        per_pair = 2 * B * Hq * (3 * hd + 2 * hd_v)
    else:
        nbytes, flops = attention_cost(Sq, dtype, causal, heads, Sk)
        nbytes, flops = B * nbytes, B * flops
        per_pair = 2 * B * Hq * (hd + hd_v)
    if causal and Sq > Sk:
        flops = per_pair * _top_left_pairs(Sq, Sk)
    return nbytes, flops


# ---------------------------------------------------------------------------
# the kernel counter the meta branches feed
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KernelCounter:
    """Calls, bytes and FLOPs by kernel name of the meta calls made while
    it is active (the names are those of ``kernels._build.LAUNCHES``).

    A counter held by the caller's context, not ``torch.library``
    custom ops with fake and FLOP registrations: the wrappers already pick
    their path by the tensors' device in Python, so the meta path is one
    more branch and the CUDA and CPU paths stay as they are, where a
    custom op would route both through the dispatcher and need its own
    autograd registration beside ``FlashAttention``/``SSDChunkDual``; and
    the closed forms count bytes too, which a FLOP formula does not."""
    calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    flops: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def add(self, name: str, nbytes: int, flops: int) -> None:
        self.calls[name] += 1
        self.bytes[name] += nbytes
        self.flops[name] += flops

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())

    @property
    def total_flops(self) -> int:
        return sum(self.flops.values())


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_kernel_counter", default=None)


@contextlib.contextmanager
def count_kernels():
    """``with count_kernels() as counter:`` the kernels' meta calls inside
    the block add their closed-form cost to ``counter``."""
    counter = KernelCounter()
    token = _ACTIVE.set(counter)
    try:
        yield counter
    finally:
        _ACTIVE.reset(token)


def record_meta_call(name: str, nbytes: int, flops: int) -> None:
    """A kernel wrapper's meta branch: add one call's closed-form cost to
    the active counter (none active: nothing is recorded)."""
    counter = _ACTIVE.get()
    if counter is not None:
        counter.add(name, int(nbytes), int(flops))
