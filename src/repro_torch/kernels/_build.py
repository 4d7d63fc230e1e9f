"""Build and load the CUDA kernels of :mod:`repro_torch.kernels`.

The sources under ``csrc/`` have a plain C interface.  At first use each
``.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all started
together, and the objects are linked into one shared library named by the
hash of the sources, under ``kernels/build/`` (listed in ``.gitignore``),
and loaded with ``ctypes``.  A library whose hash matches is reused, so a
process builds at most once per source change.  Nothing is built or
loaded at import time.

A user-defined operator, and every float32 one
(:data:`~repro_torch.core.operators.MSG_CUSTOM`), gets a library of its
own at first use (:func:`custom_lib`): its callables lowered to a header
(:mod:`repro_torch.kernels.opgen`) that also names the value type
(``REPRO_OP_FLOAT``: ``float`` values), ``relax.cu`` and ``fused.cu``
compiled once more with it for that one operator and value type, named
by the hash of the header, the sources and the flags, and cached in the
process and on disk, so two callables of the same body and value type
share one.  :func:`op_library` gives each launch site its library and
codes.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> launches so far; each wrapper adds one where it
#: launches its kernel and nowhere else
LAUNCHES = {"wd_relax_lanes": 0, "relax_lanes": 0, "find_offsets": 0,
            "flash_attention": 0, "ssd_chunk_dual": 0,
            "flash_attention_bwd": 0, "ssd_chunk_dual_bwd": 0,
            "fused_fixed_point": 0, "wd_relax_lanes_batch": 0,
            "ad_choice_probe": 0, "barrier_probe": 0}

#: kernel name -> lanes launched so far, for the kernels whose work is a
#: lane count (B1's ``cap_work``, its batch's union lanes times the row
#: quads ``Kp / 4``, B2's ``L``); summed where the launch is counted, so
#: ``LANES[k] / LAUNCHES[k]`` is a run's mean lanes a launch
LANES = {"wd_relax_lanes": 0, "relax_lanes": 0, "wd_relax_lanes_batch": 0}

#: ``dtype`` argument of the float kernels
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: compiler output of the build this process ran (``-Xptxas -v``
#: registers and spills), empty when the library was already built
BUILD_LOG: list[str] = []

#: header digest -> ``{"op", "seconds", "log"}`` of each custom build this
#: process ran (the operator's name, the build's wall seconds and its
#: compiler output)
CUSTOM_BUILDS: dict[str, dict] = {}

#: the sources a custom build compiles, and the entry points it exports
CUSTOM_SOURCES = ("relax.cu", "fused.cu")
CUSTOM_ENTRIES = ("repro_relax_lanes", "repro_wd_relax_lanes",
                  "repro_wd_relax_union", "repro_fused_fixed_point",
                  "repro_fused_delta", "repro_relax_block_attrs",
                  "repro_fused_block_attrs")

_P = ctypes.c_void_p
_I = ctypes.c_int
_OUT = ctypes.POINTER(ctypes.c_int)
#: cells of a block-attributes report (``ATTR_CELLS`` in csrc/attrs.cuh)
ATTR_CELLS = 7
_F = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    # dist, n, src, dst, w, valid, lanes, msg, comb, target, upd, imp,
    # stream
    "repro_relax_lanes": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    # dist, n, prefix, excl, start, src_ids, f, col, wt, e, cap_work,
    # msg, comb, target, upd, imp, stream
    "repro_wd_relax_lanes": [_P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I,
                             _I, _I, _P, _P, _P, _P],
    # dist, n, kp, front, prefix, excl, start, src_ids, f, row_excl,
    # cap_work, col, wt, e, max_lanes, msg, comb, target, upd, stream
    "repro_wd_relax_union": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _I,
                             _P, _P, _I, ctypes.c_longlong, _I, _I, _P, _P,
                             _P],
    # prefix, f, cap_work, out, stream
    "repro_find_offsets": [_P, _I, _I, _P, _P],
    # q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, hd, hd_v, causal, dtype,
    # scale, stream
    "repro_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, ctypes.c_float, _P],
    # q, k, v, out, dout, lse, D, dq, dk, dv, B, Hq, Hkv, Sq, Sk, hd, hd_v,
    # causal, dtype, scale, stream
    "repro_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                  ctypes.c_float, _P],
    # xbar, cum, Bm, Cm, y, state, BN, c, H, P, N, dtype, stream
    "repro_ssd_chunk_dual": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _P],
    # xbar, cum, Bm, Cm, dy, dstate, dxbar, dcum, dB, dC, work, BN, c, H,
    # P, N, dtype, stream
    "repro_ssd_chunk_dual_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _P],
    # BN, H -> head groups of a backward call
    "repro_ssd_bwd_groups": [_I, _I],
    # n, delta, narrow_edges, out bytes
    "repro_fused_workspace_bytes": [_I, _I, _I,
                                    ctypes.POINTER(ctypes.c_longlong)],
    # row_ptr, col, wt, n, e, aux, dist0, mask0, kernel, msg, comb,
    # max_iterations, mdt, switch_threshold, small_frontier,
    # imbalance_threshold, hp_edges_threshold, tail_width,
    # tail_min_columns, coeffs, dist, workspace, workspace_bytes, result,
    # stream
    "repro_fused_fixed_point": [_P, _P, _P, _I, _I, _P, _P, _P, _I, _I,
                                _I, _I, _I, _I, _I, ctypes.c_float, _I, _I,
                                _I, _F, _P, _P, ctypes.c_longlong, _P, _P],
    # light row_ptr, col, wt, e; heavy row_ptr, col, wt, e; n, aux, dist0,
    # mask0, kernel, msg, comb, delta, max_epochs, mdt, switch_threshold,
    # small_frontier, imbalance_threshold, hp_edges_threshold, tail_width,
    # tail_min_columns, narrow_edges, dist, mask, workspace,
    # workspace_bytes, result, stream
    "repro_fused_delta": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                          _I, _I, _I, _I, _P, _P, _P, ctypes.c_longlong, _P,
                          _P],
    # which, out [ATTR_CELLS]: threads, static shared bytes, registers,
    # local bytes, blocks per SM, SMs, dynamic shared bytes requested
    "repro_relax_block_attrs": [_I, _OUT],
    # dtype, hd, hd_v, out
    "repro_flash_block_attrs": [_I, _I, _I, _OUT],
    # dtype, hd, hd_v, which (0 dK/dV, 1 dQ), out
    "repro_flash_bwd_block_attrs": [_I, _I, _I, _I, _OUT],
    # dtype, BN, c, H, P, N, out
    "repro_ssd_block_attrs": [_I, _I, _I, _I, _I, _I, _OUT],
    # dtype, P, N, out
    "repro_ssd_bwd_block_attrs": [_I, _I, _I, _OUT],
    # coeffs (host, 9), count, degree_sum, m, out, stream
    "repro_fused_ad_choice_probe": [_F, _P, _P, _I, _P, _P],
    "repro_fused_block_attrs": [_I, _OUT],
    # k, bar (two zeroed words: the barrier and its count), stream
    "repro_fused_barrier_probe": [_I, _P, _P],
}

_lib = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; the "
            "CUDA kernels of repro_torch are built from source at first use")
    return found


def _digest(*texts: str) -> str:
    """The hash of ``texts``, every source and the flags."""
    digest = hashlib.sha256()
    for text in texts:
        digest.update(text.encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_kernels_{_digest()}.so"


def _nvcc_build(out: Path, units: dict, log: list) -> None:
    """Compile each unit (``stem -> source path``, or ``stem -> the text``
    of a unit) by its own nvcc, all started together, and link the objects
    into ``out``.  Compiling and linking happen in a private directory and
    the library is renamed into place: a concurrent build never loads a
    half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for stem, src in units.items():
            if not isinstance(src, Path):
                path = Path(tmp) / f"{stem}.cu"
                path.write_text(src)
                src = path
            obj = str(Path(tmp) / f"{stem}.o")
            jobs.append((src.name, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for name, _, proc in jobs:
            stdout, stderr = proc.communicate()
            log.append(stdout + stderr)
            if proc.returncode != 0:
                failed.append(f"nvcc {name} failed ({proc.returncode}):\n"
                              f"{stdout}\n{stderr}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib_tmp = str(Path(tmp) / out.name)
        proc = subprocess.run(
            [nvcc, "-shared", "-o", lib_tmp, *(obj for _, obj, _ in jobs)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(lib_tmp, out)


def build() -> Path:
    """Compile the sources unless a library of the same hash exists."""
    out = library_path()
    if not out.exists():
        _nvcc_build(out, {s.stem: s for s in _sources() if s.suffix == ".cu"},
                    BUILD_LOG)
    return out


def _load(path: Path, names) -> ctypes.CDLL:
    handle = ctypes.CDLL(str(path))
    for name in names:
        fn = getattr(handle, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    handle.repro_error_string.argtypes = [ctypes.c_int]
    handle.repro_error_string.restype = ctypes.c_char_p
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    if _lib is None:
        _lib = _load(build(), _SIGNATURES)
    return _lib


#: custom libraries loaded by this process, by path and by operator
_custom_by_path: dict[Path, ctypes.CDLL] = {}
_custom_by_op: dict = {}


def custom_library_path(header: str) -> Path:
    """Where the custom library of a lowered header lies."""
    return BUILD_DIR / f"librepro_op_{_digest(header)}.so"


def _custom_units(header: Path) -> dict:
    """One unit a source of :data:`CUSTOM_SOURCES`: it names ``header`` in
    ``REPRO_CUSTOM_OP_HEADER`` and includes the source, which then
    instantiates its kernels for that operator only."""
    return {f"{Path(name).stem}_op":
            f"#define REPRO_CUSTOM_OP_HEADER {json.dumps(str(header))}\n"
            f"#include {json.dumps(str(CSRC / name))}\n"
            for name in CUSTOM_SOURCES}


def custom_build(op) -> Path:
    """The path of the library of the user-defined operator ``op``
    (message code ``MSG_CUSTOM``), compiled unless a library of the same
    hash exists; not loaded.  Safe to call from several threads (builds
    of several operators at once).  Raises ``NotImplementedError`` before
    any build if ``op`` cannot be lowered, and ``RuntimeError`` with the
    compiler's output if nvcc fails."""
    from repro_torch.kernels import opgen   # imports core.operators

    lowered = opgen.lower(op)
    out = custom_library_path(lowered.header)
    if not out.exists():
        t0 = time.perf_counter()
        log: list[str] = []
        # the header lies beside its library (a concurrent build of the
        # same operator renames the same text into place)
        header = out.with_suffix(".h")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(
                "w", dir=BUILD_DIR, suffix=".h", delete=False) as f:
            f.write(lowered.header)
        os.replace(f.name, header)
        _nvcc_build(out, _custom_units(header), log)
        CUSTOM_BUILDS[lowered.digest] = {
            "op": op.name, "seconds": time.perf_counter() - t0, "log": log}
    return out


def custom_lib(op) -> ctypes.CDLL:
    """The relax and fused kernels built for the user-defined operator
    ``op`` (:func:`custom_build`, at its first call unless a library of
    the same hash exists), loaded and cached by operator."""
    handle = _custom_by_op.get(op)
    if handle is not None:
        return handle
    out = custom_build(op)
    handle = _custom_by_path.get(out)
    if handle is None:
        handle = _custom_by_path[out] = _load(out, CUSTOM_ENTRIES)
    _custom_by_op[op] = handle
    return handle


def op_library(op) -> tuple[ctypes.CDLL, int, int]:
    """``(library, message code, combine code)`` of a kernel launch for
    ``op``: the built-in messages run the base library (:func:`lib`),
    any other operator its own (:func:`custom_lib`).  Every relax and
    fused launch site resolves its operator here."""
    from repro_torch.core.operators import MSG_CUSTOM

    msg, comb, _ = op.kernel_codes()
    return (custom_lib(op) if msg == MSG_CUSTOM else lib()), msg, comb


def check(name: str, status: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if status != 0:
        what = lib().repro_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {what} ({status})")


def check_tensor(name: str, t: torch.Tensor, device: torch.device,
                 dtype: torch.dtype, numel: int | None = None) -> None:
    """What a kernel wrapper accepts: a contiguous 1-D tensor of ``dtype``
    on ``device`` (of ``numel`` elements when given); anything else
    raises."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or (numel is not None and t.numel() != numel):
        raise ValueError(
            f"{name} has shape {tuple(t.shape)}, expected "
            f"[{'any' if numel is None else numel}]")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name} has {t.numel()} elements; the kernels "
                         f"index with int32")


def check_dense(name: str, t: torch.Tensor, device: torch.device,
                dtype: torch.dtype, shape: tuple) -> None:
    """What a float kernel wrapper accepts: a contiguous tensor of
    ``dtype`` and exactly ``shape`` on ``device``; anything else raises."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name} has {t.numel()} elements; the kernels "
                         f"index rows with int32")


def check_aligned(**tensors: torch.Tensor) -> None:
    """The bf16 kernels copy rows in 16-byte pieces (``cp.async``), so
    their wrappers hold each bf16 tensor to a 16-byte start (a fresh
    allocation has one; a view with an offset may not).  The f32 kernels
    load element by element and take any start."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
