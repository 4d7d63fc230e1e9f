"""Public wrappers around the port's kernels (the counterpart of
:mod:`repro.kernels.ops`)."""

from __future__ import annotations

import torch

from repro_torch.kernels.find_offsets import find_offsets
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_chunk import ssd_chunk_dual


def wd_find_offsets(prefix: torch.Tensor, cap_work: int) -> torch.Tensor:
    """WD merge-path offsets (paper Fig. 4 ``find_offsets``): the frontier
    slot of each of ``cap_work`` work items, on the prefix's device."""
    return find_offsets(prefix, cap_work)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """Flash attention (B4) on the tensors' device.  No padding: the kernel
    masks ragged query and key tails itself."""
    return flash_attention(q, k, v, causal=causal)


def ssd_chunk(xbar, cum, Bm, Cm):
    """The SSD intra-chunk dual form (B5) on the inputs' device."""
    return ssd_chunk_dual(xbar, cum, Bm, Cm)
