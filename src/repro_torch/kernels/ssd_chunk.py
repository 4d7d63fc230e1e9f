"""B5: the Mamba-2 SSD intra-chunk dual form.

For each (chunk-batch, head) cell, with the chunk's discretised inputs
``x̄ [c,P]``, decay log-cumsum ``cum [c]`` and head-shared ``B, C [c,N]``:

    y_intra[i] = Σ_{j≤i} (C_i·B_j) · exp(cum_i − cum_j) · x̄_j     [c,P]
    state      = Σ_j exp(cum_{c-1} − cum_j) · B_j ⊗ x̄_j            [N,P]

:func:`ssd_chunk_dual` launches the CUDA kernel ``repro_ssd_chunk_dual``
(``csrc/ssd_chunk.cu``) for CUDA tensors and runs
:func:`ssd_chunk_dual_plain` for CPU tensors.  Inputs are upcast to
float32; both outputs are float32 (``repro/kernels/ssd_chunk.py``).  The
kernel is chosen by dtype: bfloat16 inputs run on the tensor cores (C·B
once per chunk and head group, the f32 factors as bf16 hi + lo terms),
float32 inputs on the CUDA cores in f32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import (DTYPE_CODES, LAUNCHES, check_aligned,
                                        check_dense)

#: largest state size N and head dim P the kernel's register tiles hold
MAX_NP = 128
#: largest chunk the bf16 kernel takes: it keeps 64 rows of C·B, 64 x c
#: float32, in shared memory beside its tiles (184 KB at c = 512, N = P =
#: 128, 8 heads a block; the C entry point checks only that its shared
#: memory fits the card)
MAX_CHUNK_BF16 = 512


def _shapes(xbar, cum, Bm, Cm):
    if xbar.dim() != 4:
        raise ValueError(f"xbar must be [BN,c,H,P], got {tuple(xbar.shape)}")
    BN, c, H, P = xbar.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    if (tuple(cum.shape) != (BN, c, H) or tuple(Bm.shape) != (BN, c, N)
            or Cm.shape != Bm.shape or min(BN, c, H, P, N) < 1):
        raise ValueError(f"xbar {tuple(xbar.shape)}, cum {tuple(cum.shape)}, "
                         f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)} are "
                         f"not [BN,c,H,P], [BN,c,H], [BN,c,N], [BN,c,N]")
    return BN, c, H, P, N


def ssd_chunk_dual_plain(xbar, cum, Bm, Cm):
    """The plain version: the reference's einsums with the whole
    ``[c, c]`` decay matrix."""
    _shapes(xbar, cum, Bm, Cm)
    xb, cum = xbar.float(), cum.float()
    Bm, Cm = Bm.float(), Cm.float()
    c = xb.shape[1]
    ii = torch.arange(c, device=xb.device)
    seg = cum[:, :, None, :] - cum[:, None, :, :]              # [BN,i,j,H]
    L = torch.where((ii[:, None] >= ii[None, :])[None, :, :, None],
                    torch.exp(seg), 0.0)
    CB = torch.einsum("bis,bjs->bij", Cm, Bm)
    y = torch.einsum("bijh,bjhp->bihp", CB[..., None] * L, xb)
    decay_end = torch.exp(cum[:, -1:, :] - cum)                # [BN,c,H]
    Bd = Bm[:, :, None, :] * decay_end[..., None]              # [BN,c,H,N]
    st = torch.einsum("bjhs,bjhp->bhsp", Bd, xb)
    return y, st


def _ssd_chunk_dual_cuda(xbar, cum, Bm, Cm):
    BN, c, H, P, N = _shapes(xbar, cum, Bm, Cm)
    dev, dtype = xbar.device, xbar.dtype
    if dtype not in DTYPE_CODES:
        raise TypeError(f"ssd_chunk_dual takes float32 or bfloat16 inputs, "
                        f"got {dtype}")
    if P > MAX_NP or N > MAX_NP:
        raise ValueError(f"ssd_chunk_dual's kernel takes P, N <= {MAX_NP}, "
                         f"got P={P}, N={N}")
    if dtype == torch.bfloat16 and c > MAX_CHUNK_BF16:
        raise ValueError(f"ssd_chunk_dual's bf16 kernel takes c <= "
                         f"{MAX_CHUNK_BF16}, got c={c}")
    if BN > 65535 or H > 65535:
        raise ValueError(f"BN {BN} or H {H} exceed the grid")
    check_dense("xbar", xbar, dev, dtype, (BN, c, H, P))
    check_dense("cum", cum, dev, torch.float32, (BN, c, H))
    check_dense("Bm", Bm, dev, dtype, (BN, c, N))
    check_dense("Cm", Cm, dev, dtype, (BN, c, N))
    if dtype == torch.bfloat16:
        check_aligned(xbar=xbar, Bm=Bm, Cm=Cm)
    y = torch.empty((BN, c, H, P), dtype=torch.float32, device=dev)
    state = torch.empty((BN, H, N, P), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.check("ssd_chunk_dual", _build.lib().repro_ssd_chunk_dual(
            xbar.data_ptr(), cum.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), state.data_ptr(), BN, c, H, P, N,
            DTYPE_CODES[dtype], _build.stream_of(dev)))
    LAUNCHES["ssd_chunk_dual"] += 1
    return y, state


def ssd_chunk_dual(xbar, cum, Bm, Cm):
    """``xbar [BN,c,H,P]``, ``cum [BN,c,H]`` float32, ``Bm/Cm [BN,c,N]``
    (``BN`` = batch × chunks) -> ``(y_intra [BN,c,H,P], state [BN,H,N,P])``
    in float32, on the inputs' device: the CUDA kernel for CUDA tensors
    (xbar/Bm/Cm of one dtype, float32 or bfloat16, contiguous; P, N <= 128;
    c <= 512 in bfloat16; anything else raises), the plain version for CPU
    tensors."""
    if xbar.device.type == "cuda":
        return _ssd_chunk_dual_cuda(xbar, cum, Bm, Cm)
    if xbar.device.type == "cpu":
        return ssd_chunk_dual_plain(xbar, cum, Bm, Cm)
    raise ValueError(f"no ssd_chunk_dual for device {xbar.device}")
