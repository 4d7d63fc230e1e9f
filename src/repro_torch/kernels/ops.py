"""Public wrappers around the port's kernels (the counterpart of
:mod:`repro.kernels.ops`)."""

from __future__ import annotations

import torch

from repro_torch.kernels.find_offsets import find_offsets


def wd_find_offsets(prefix: torch.Tensor, cap_work: int) -> torch.Tensor:
    """WD merge-path offsets (paper Fig. 4 ``find_offsets``): the frontier
    slot of each of ``cap_work`` work items, on the prefix's device."""
    return find_offsets(prefix, cap_work)
