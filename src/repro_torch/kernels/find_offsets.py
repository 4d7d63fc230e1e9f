"""B3: the WD offset search (the paper's ``find_offsets``).

Work item *k* of a workload-decomposition step belongs to frontier slot
``rank(k) = #{i : prefix[i] <= k}`` of the inclusive prefix sum of the
frontier's degrees — ``searchsorted(prefix, k, side="right")``.

:func:`find_offsets` launches the CUDA kernel ``repro_find_offsets``
(``csrc/relax.cu``: a block tile of consecutive items finds the slots of
its first and last item, stages that prefix slice in shared memory and
ranks every item there) for a CUDA tensor, and runs
:func:`find_offsets_plain` for a CPU tensor.  The same search is B1's
first step (:func:`repro_torch.kernels.relax.wd_relax_lanes`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import LAUNCHES, check_tensor, stream_of


def find_offsets_plain(prefix: torch.Tensor, cap_work: int) -> torch.Tensor:
    """The plain version: ``torch.searchsorted(..., right=True)``."""
    k = torch.arange(cap_work, dtype=torch.int32, device=prefix.device)
    if prefix.numel() == 0:     # empty frontier: every item ranks to 0
        return torch.zeros_like(k)
    return torch.searchsorted(prefix, k, right=True, out_int32=True)


def _find_offsets_cuda(prefix: torch.Tensor, cap_work: int) -> torch.Tensor:
    dev = prefix.device
    check_tensor("prefix", prefix, dev, torch.int32)
    out = torch.empty(cap_work, dtype=torch.int32, device=dev)
    if cap_work == 0:
        return out
    with torch.cuda.device(dev):
        _build.check("find_offsets", _build.lib().repro_find_offsets(
            prefix.data_ptr(), prefix.numel(), cap_work, out.data_ptr(),
            stream_of(dev)))
    LAUNCHES["find_offsets"] += 1
    return out


def find_offsets(prefix: torch.Tensor, cap_work: int) -> torch.Tensor:
    """``prefix [F]`` inclusive, non-decreasing int32 -> frontier slot of
    each work item ``[cap_work]`` int32 (zeros when ``F == 0``).  The
    device is the prefix's: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if cap_work < 0 or cap_work >= 2 ** 31:
        raise ValueError(f"cap_work must be in [0, 2**31), got {cap_work}")
    if prefix.device.type == "cuda":
        return _find_offsets_cuda(prefix, cap_work)
    if prefix.device.type == "cpu":
        return find_offsets_plain(prefix, cap_work)
    raise ValueError(f"no find_offsets for device {prefix.device}")
