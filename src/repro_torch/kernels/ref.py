"""Plain oracles of the port's kernels (the counterpart of
:mod:`repro.kernels.ref`)."""

from __future__ import annotations

import torch

from repro_torch.kernels.find_offsets import find_offsets_plain
from repro_torch.kernels.ssd_chunk import ssd_chunk_dual_plain


def find_offsets_ref(prefix: torch.Tensor, cap_work: int) -> torch.Tensor:
    """``searchsorted(prefix, arange(cap_work), side="right")`` as int32."""
    return find_offsets_plain(prefix, cap_work)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """Naive softmax attention with GQA head grouping, all in float32."""
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, hd).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * hd ** -0.5
    if causal:
        keep = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = s.masked_fill(~keep, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Sq, hd).to(q.dtype)


def ssd_chunk_ref(xbar, cum, Bm, Cm):
    """One-chunk SSD dual form: ``(y_intra, state)`` in float32."""
    return ssd_chunk_dual_plain(xbar, cum, Bm, Cm)
