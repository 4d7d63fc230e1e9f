"""Data-driven worklist machinery (the port of :mod:`repro.core.worklist`).

A worklist is a fixed-capacity int32 index tensor padded with -1 plus a
valid count; a push is flag → scan → compact.  Drivers round the live size
up to a power of two (:func:`bucket`), which keeps the reference's launch
shapes and so its iteration-by-iteration accounting.

Priority (value) buckets: delta-stepping (:mod:`repro_torch.core.priority`)
partitions the frontier by ``rank // Δ`` of its tentative values.  The
rank, bucket-index and minimum-live-bucket helpers live here because a
priority bucket is a worklist whose membership reads the value array.
"""

from __future__ import annotations

import torch

from repro_torch.core.graph import INF

MIN_BUCKET = 256

#: bucket index of an empty slot: above every real bucket (real indices
#: are at most INF), so ``min`` folds ignore it
NO_BUCKET = torch.iinfo(torch.int32).max


def bucket(n: int, minimum: int = MIN_BUCKET) -> int:
    """Round up to the next power of two (≥ minimum)."""
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


def compact_mask(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """Boolean mask [N] -> index worklist [cap] (ascending, padded with -1,
    truncated to ``cap`` like ``jnp.nonzero(size=cap)``)."""
    idx = torch.nonzero(mask).flatten()[:cap].to(torch.int32)
    out = torch.full((cap,), -1, dtype=torch.int32, device=mask.device)
    out[:idx.numel()] = idx
    return out


def mask_count(mask: torch.Tensor) -> int:
    return int(mask.sum())


def run_fill(starts: torch.Tensor, lengths: torch.Tensor, total_hint: int,
             cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Variable-length run fill (the work-chunked push): the
    concatenation ``[starts[0], starts[0]+len0) ++ [starts[1], ...) ++ ...``
    padded with -1 to ``cap``.  Returns ``(values [cap], valid [cap])``."""
    lengths = lengths.to(torch.int32)
    prefix = torch.cumsum(lengths, 0, dtype=torch.int32)        # inclusive
    exclusive = prefix - lengths
    k = torch.arange(cap, dtype=torch.int32, device=lengths.device)
    if lengths.numel() == 0:
        return torch.full_like(k, -1), torch.zeros_like(k, dtype=torch.bool)
    run = torch.searchsorted(prefix, k, right=True, out_int32=True)
    run_c = run.clamp(0, lengths.numel() - 1)
    vals = starts[run_c] + (k - exclusive[run_c])
    valid = k < min(int(total_hint), int(prefix[-1]))
    return torch.where(valid, vals, -1).to(torch.int32), valid


# ---------------------------------------------------------------------------
# priority (value) buckets: delta-stepping (repro_torch.core.priority)
# ---------------------------------------------------------------------------

def value_inf(dtype: torch.dtype) -> torch.Tensor:
    """:data:`INF` converted to values of ``dtype`` as the reference's
    weak-typed ``jnp.clip`` bound converts it: an integer type keeps INF's
    low bits (int16 and int8: -1; uint8: 255), a float type rounds it
    (float32 and bfloat16: 2^30; float16: inf)."""
    return torch.tensor(INF, dtype=torch.int64).to(dtype)


def bucket_rank(vals: torch.Tensor, *, descending: bool = False
                ) -> torch.Tensor:
    """Tentative values to a non-negative rank, smaller settling earlier:
    values clipped to ``[0, INF]``; a ``max`` monoid (``descending``)
    settles large values first, so its rank is ``INF - v``.  Computed in
    the values' dtype, as the reference computes it: the clip takes the
    lower bound first and :func:`value_inf` as its upper bound (so an
    int16 or int8 rank is -1 and its reflection 0), and the reflection
    wraps (integers) or rounds once (floats)."""
    hi = value_inf(vals.dtype).to(vals.device)
    v = torch.minimum(torch.maximum(vals, torch.zeros_like(hi)), hi)
    return (hi - v) if descending else v


def bucket_index(vals: torch.Tensor, delta: int, *,
                 descending: bool = False) -> torch.Tensor:
    """Delta-stepping bucket of each value: ``rank // delta``, int32.  An
    integer rank is divided as int32; a float rank by ``delta`` converted
    to its dtype, rounded once.  A bfloat16 or float16 rank that is not
    finite (float16's INF is inf) gives bucket 0, as the reference's
    conversion gives it; a float32 NaN gives INT32_MIN."""
    rank = bucket_rank(vals, descending=descending)
    if not rank.is_floating_point():
        return torch.div(rank.to(torch.int32), delta, rounding_mode="floor")
    d = float(torch.tensor(delta, dtype=torch.int64).to(rank.dtype))
    out = torch.div(rank, d, rounding_mode="floor")
    if rank.dtype != torch.float32:
        out = torch.where(torch.isfinite(out), out, 0)
    return out.to(torch.int32)


def min_live_bucket(mask: torch.Tensor, bkt: torch.Tensor) -> int:
    """Smallest bucket index with a live frontier node (:data:`NO_BUCKET`
    if the frontier is empty)."""
    return int(torch.where(mask, bkt, NO_BUCKET).min()) if mask.numel() \
        else NO_BUCKET
