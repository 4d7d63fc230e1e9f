"""Data-driven worklist machinery (the port of :mod:`repro.core.worklist`).

A worklist is a fixed-capacity int32 index tensor padded with -1 plus a
valid count; a push is flag → scan → compact.  Drivers round the live size
up to a power of two (:func:`bucket`), which keeps the reference's launch
shapes and so its iteration-by-iteration accounting.  The priority-bucket
helpers come with delta-stepping (ROADMAP.md A10).
"""

from __future__ import annotations

import torch

MIN_BUCKET = 256


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
