"""Plain oracles of the port's kernels (the counterpart of
:mod:`repro.kernels.ref`)."""

from __future__ import annotations

import torch

from repro_torch.kernels.find_offsets import find_offsets_plain


def find_offsets_ref(prefix: torch.Tensor, cap_work: int) -> torch.Tensor:
    """``searchsorted(prefix, arange(cap_work), side="right")`` as int32."""
    return find_offsets_plain(prefix, cap_work)
