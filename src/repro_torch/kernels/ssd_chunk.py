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

Training differentiates through :class:`SSDChunkDual`, which
:func:`ssd_chunk_dual` takes when an input requires a gradient.  Its
backward, :func:`ssd_chunk_dual_bwd`, takes the cotangents ``(dy, dstate)``
and returns ``(dxbar, dcum, dB, dC)``: the CUDA kernel
``repro_ssd_chunk_dual_bwd`` for CUDA tensors (one block per chunk-batch
row and group of heads, as many groups as fill the SMs once; each writes
the dB and dC of its heads, which all heads share, to a partial that a
second launch folds in group order: no float atomics; f32 sums on the
CUDA cores for both dtypes) and
:func:`ssd_chunk_dual_bwd_plain` for CPU tensors.  Both apply the causal
mask *before* the exponential, so ``exp(cum_i - cum_j)`` with ``i < j`` is
never formed.  Autograd through the forward's ``where(mask, exp(seg),
0)`` (the reference's ``ssd_chunked`` and ``ssd_chunk_ref``) is NaN once
a chunk's decay spans more than ~88: above the diagonal ``exp(seg)``
overflows to inf, and the backward multiplies it by a zero cotangent.

Meta tensors (the dry run's abstract step) take neither: the forward and
the backward return empty outputs of the kernel's shapes and dtypes and
add the call's closed-form bytes and FLOPs
(:func:`repro_torch.kernels.cost.ssd_cost`, ``ssd_bwd_cost``) to the
active :func:`~repro_torch.kernels.cost.count_kernels` counter.  They
add nothing to ``LAUNCHES``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import (DTYPE_CODES, LAUNCHES, check_aligned,
                                        check_dense)
from repro_torch.kernels.cost import record_meta_call, ssd_bwd_cost, ssd_cost

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


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions' sums: float32, or float64 for float64 inputs
    (gradient checks)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def ssd_chunk_dual_plain(xbar, cum, Bm, Cm):
    """The plain version: the reference's einsums with the whole
    ``[c, c]`` decay matrix."""
    acc = _acc_dtype(xbar)
    _shapes(xbar, cum, Bm, Cm)
    xb, cum = xbar.to(acc), cum.to(acc)
    Bm, Cm = Bm.to(acc), Cm.to(acc)
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


def ssd_chunk_dual_bwd_plain(xbar, cum, Bm, Cm, dy, dstate):
    """The backward pass as explicit formulas on whole tensors, the mask
    applied before the exponential.  With ``M = (C·Bᵀ) ∘ L``, ``dM[i,j] =
    dy_i·x̄_j``, ``Q = dM ∘ M`` and ``d_j = exp(cum_last - cum_j)``:
    ``dx̄ = Mᵀ dy + d·(B dstate)``, ``dC = (Σ_h dM∘L) B``, ``dB = (Σ_h
    dM∘L)ᵀ C + Σ_h d·(x̄ dstateᵀ)``, and ``dcum`` the rows of Q minus its
    columns, minus ``dd_j·d_j`` with ``dd_j = Σ dstate∘(B_j ⊗ x̄_j)``, plus
    their sum at the chunk's last row.  Returns ``(dxbar, dcum, dB, dC)``
    in the inputs' dtypes (dcum float32)."""
    acc = _acc_dtype(xbar)
    _shapes(xbar, cum, Bm, Cm)
    xb, cf = xbar.to(acc), cum.to(acc)
    Bf, Cf = Bm.to(acc), Cm.to(acc)
    dy, dstate = dy.to(acc), dstate.to(acc)
    c = xb.shape[1]
    ii = torch.arange(c, device=xb.device)
    keep = (ii[:, None] >= ii[None, :])[None, :, :, None]
    seg = cf[:, :, None, :] - cf[:, None, :, :]                # [BN,i,j,H]
    L = torch.exp(torch.where(keep, seg, float("-inf")))
    M = torch.einsum("bis,bjs->bij", Cf, Bf)[..., None] * L
    dM = torch.einsum("bihp,bjhp->bijh", dy, xb)
    Q = dM * M
    dCB = (dM * L).sum(-1)                                     # [BN,i,j]
    decay_end = torch.exp(cf[:, -1:, :] - cf)                  # [BN,c,H]
    T = torch.einsum("bjhp,bhsp->bjhs", xb, dstate)            # [BN,c,H,N]
    dd = torch.einsum("bjhs,bjs->bjh", T, Bf) * decay_end
    last = torch.zeros_like(dd)
    last[:, -1] = dd.sum(1)
    dcum = Q.sum(2) - Q.sum(1) - dd + last
    dxb = (torch.einsum("bijh,bihp->bjhp", M, dy) + decay_end[..., None]
           * torch.einsum("bjs,bhsp->bjhp", Bf, dstate))
    dB = (torch.einsum("bij,bis->bjs", dCB, Cf)
          + torch.einsum("bjh,bjhs->bjs", decay_end, T))
    dC = torch.einsum("bij,bjs->bis", dCB, Bf)
    return (dxb.to(xbar.dtype), dcum, dB.to(Bm.dtype), dC.to(Cm.dtype))


def _check_kernel_args(xbar, cum, Bm, Cm, name: str):
    BN, c, H, P, N = _shapes(xbar, cum, Bm, Cm)
    dev, dtype = xbar.device, xbar.dtype
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16 inputs, got "
                        f"{dtype}")
    if P > MAX_NP or N > MAX_NP:
        raise ValueError(f"{name}'s kernel takes P, N <= {MAX_NP}, got "
                         f"P={P}, N={N}")
    check_dense("xbar", xbar, dev, dtype, (BN, c, H, P))
    check_dense("cum", cum, dev, torch.float32, (BN, c, H))
    check_dense("Bm", Bm, dev, dtype, (BN, c, N))
    check_dense("Cm", Cm, dev, dtype, (BN, c, N))
    return BN, c, H, P, N


def _empty(shape, dtype, like) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=like.device)


def _ssd_chunk_dual_meta(xbar, cum, Bm, Cm):
    """The meta branch of the forward: empty float32 ``(y, state)`` and
    the closed-form cost recorded."""
    BN, c, H, P, N = _shapes(xbar, cum, Bm, Cm)
    record_meta_call("ssd_chunk_dual", *ssd_cost(BN, c, H, P, N,
                                                 xbar.dtype))
    return (_empty((BN, c, H, P), torch.float32, xbar),
            _empty((BN, H, N, P), torch.float32, xbar))


def _ssd_chunk_dual_bwd_meta(xbar, cum, Bm, Cm):
    """The meta branch of the backward: empty ``(dxbar, dcum, dB, dC)``
    and the closed-form cost recorded."""
    BN, c, H, P, N = _shapes(xbar, cum, Bm, Cm)
    record_meta_call("ssd_chunk_dual_bwd", *ssd_bwd_cost(BN, c, H, P, N,
                                                         xbar.dtype))
    return (_empty(xbar.shape, xbar.dtype, xbar),
            _empty(cum.shape, torch.float32, xbar),
            _empty(Bm.shape, Bm.dtype, xbar), _empty(Cm.shape, Cm.dtype, xbar))


def _ssd_chunk_dual_bwd_cuda(xbar, cum, Bm, Cm, dy, dstate):
    BN, c, H, P, N = _check_kernel_args(xbar, cum, Bm, Cm,
                                        "ssd_chunk_dual_bwd")
    dev, dtype = xbar.device, xbar.dtype
    check_dense("dy", dy, dev, torch.float32, (BN, c, H, P))
    check_dense("dstate", dstate, dev, torch.float32, (BN, H, N, P))
    dxbar = torch.empty((BN, c, H, P), dtype=torch.float32, device=dev)
    dcum = torch.empty((BN, c, H), dtype=torch.float32, device=dev)
    dB, dC = (torch.empty((BN, c, N), dtype=torch.float32, device=dev)
              for _ in range(2))
    groups = _build.lib().repro_ssd_bwd_groups(BN, H)
    # the head groups' dB and dC partials, folded by the kernel's second
    # launch
    work = (torch.empty((2, BN, groups, c, N), dtype=torch.float32,
                        device=dev) if groups > 1 else None)
    with torch.cuda.device(dev):
        _build.check("ssd_chunk_dual_bwd",
                     _build.lib().repro_ssd_chunk_dual_bwd(
                         xbar.data_ptr(), cum.data_ptr(), Bm.data_ptr(),
                         Cm.data_ptr(), dy.data_ptr(), dstate.data_ptr(),
                         dxbar.data_ptr(), dcum.data_ptr(), dB.data_ptr(),
                         dC.data_ptr(), None if work is None
                         else work.data_ptr(), BN, c, H, P, N,
                         DTYPE_CODES[dtype], _build.stream_of(dev)))
    LAUNCHES["ssd_chunk_dual_bwd"] += 1
    return dxbar.to(dtype), dcum, dB.to(dtype), dC.to(dtype)


def ssd_chunk_dual_bwd(xbar, cum, Bm, Cm, dy, dstate):
    """``(dxbar, dcum, dB, dC)`` of :func:`ssd_chunk_dual` at the
    cotangents ``dy [BN,c,H,P]`` and ``dstate [BN,H,N,P]`` (float32), on
    the tensors' device: the CUDA kernel for CUDA tensors (P, N <= 128;
    anything else raises), the plain version for CPU tensors."""
    if xbar.device.type == "cuda":
        return _ssd_chunk_dual_bwd_cuda(xbar, cum, Bm, Cm, dy, dstate)
    if xbar.device.type == "cpu":
        return ssd_chunk_dual_bwd_plain(xbar, cum, Bm, Cm, dy, dstate)
    if xbar.device.type == "meta":
        return _ssd_chunk_dual_bwd_meta(xbar, cum, Bm, Cm)
    raise ValueError(f"no ssd_chunk_dual_bwd for device {xbar.device}")


class SSDChunkDual(torch.autograd.Function):
    """:func:`ssd_chunk_dual` with a gradient through
    :func:`ssd_chunk_dual_bwd`."""

    @staticmethod
    def forward(ctx, xbar, cum, Bm, Cm):
        y, state = _ssd_chunk_dual(xbar, cum, Bm, Cm)
        ctx.save_for_backward(xbar, cum, Bm, Cm)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        xbar, cum, Bm, Cm = ctx.saved_tensors
        BN, c, H, P = xbar.shape
        N = Bm.shape[-1]
        if dy is None:
            dy = torch.zeros((BN, c, H, P), device=xbar.device)
        if dstate is None:
            dstate = torch.zeros((BN, H, N, P), device=xbar.device)
        return ssd_chunk_dual_bwd(xbar, cum, Bm, Cm,
                                  dy.float().contiguous(),
                                  dstate.float().contiguous())


def _ssd_chunk_dual_cuda(xbar, cum, Bm, Cm):
    BN, c, H, P, N = _check_kernel_args(xbar, cum, Bm, Cm, "ssd_chunk_dual")
    dev, dtype = xbar.device, xbar.dtype
    if dtype == torch.bfloat16 and c > MAX_CHUNK_BF16:
        raise ValueError(f"ssd_chunk_dual's bf16 kernel takes c <= "
                         f"{MAX_CHUNK_BF16}, got c={c}")
    if BN > 65535 or H > 65535:
        raise ValueError(f"BN {BN} or H {H} exceed the grid")
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
    tensors.  Where gradients are on and an input requires one, it runs as
    :class:`SSDChunkDual`."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xbar, cum, Bm, Cm)):
        return SSDChunkDual.apply(xbar, cum, Bm, Cm)
    return _ssd_chunk_dual(xbar, cum, Bm, Cm)


def _ssd_chunk_dual(xbar, cum, Bm, Cm):
    if xbar.device.type == "cuda":
        return _ssd_chunk_dual_cuda(xbar, cum, Bm, Cm)
    if xbar.device.type == "cpu":
        return ssd_chunk_dual_plain(xbar, cum, Bm, Cm)
    if xbar.device.type == "meta":
        return _ssd_chunk_dual_meta(xbar, cum, Bm, Cm)
    raise ValueError(f"no ssd_chunk_dual for device {xbar.device}")
