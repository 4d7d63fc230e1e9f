"""Measured cost model for AD's kernel choice (the port of
:mod:`repro.core.costmodel`, ROADMAP A9).

AD's fixed decision tree (:func:`repro_torch.core.strategies.choose_kernel`)
carries thresholds tuned on another GPU.  This module lets the card's own
timings choose instead:

1. **Calibration** (:func:`calibrate`): time one dense step of each of BS,
   WD and HP (:data:`KERNELS`, the order of
   ``repro_torch.core.fused._AD_KERNEL_ORDER``) from synthetic frontier
   masks of the target graph at several densities (:func:`measure`), then
   fit per kernel, by ridge least squares, the step's seconds as
   ``a + b · degree_sum + c · count`` (:func:`fit`).  On the card a step
   is one launch of the fused kernel (``csrc/fused.cu``) with that kernel
   and ``max_iterations=1``, timed with CUDA events; on the CPU it is the
   plain step body of :mod:`repro_torch.core.fused`, timed with
   ``perf_counter``.  The fit persists as JSON keyed by the graph's shape
   and the device's name (:func:`graph_signature`, :func:`cache_path`),
   so a second calibration of the same shape on the same card is a cache
   hit (``python -m repro_torch.core.costmodel`` prints ``cache:
   hit|miss``).
2. **Selection** (:meth:`CostModel.choose`): the argmin of the predicted
   costs, in float32 with ``a + b·es + c·cn`` rounded after each
   operation, first index on ties; degenerate frontiers take BS.  The
   fused kernel's ``ad_choice`` evaluates the same ``[3, 3]`` float32
   coefficients (:meth:`CostModel.coeff_array`) with ``__fmul_rn`` and
   ``__fadd_rn``, so both engines choose alike.
3. **Online refinement** (:meth:`CostModel.observe`): stepped AD with
   ``online=True`` folds each iteration's seconds into recursive ridge
   normal equations.
4. **Block feasibility** (:func:`block_feasibility`): the port's own block
   shapes (B1's 1,024-lane tile and 2,048-slot slice, B2's 512-lane tile,
   the fused kernel's cooperative grid) as the card reports them
   (``cudaFuncGetAttributes``, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
   each marked infeasible by arithmetic against the H100's limits.  It
   replaces the reference's Pallas VMEM filter, which has no meaning here.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import time
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core.graph import CSRGraph, resolve_device
from repro_torch.core.schedule import DEFAULT_SCHEDULE, Schedule

#: kernel order of the coefficient rows; equals
#: ``repro_torch.core.fused._AD_KERNEL_ORDER`` (spelled out here against
#: an import cycle, checked in the tests)
KERNELS = ("BS", "WD", "HP")

#: the model family and benchmark protocol; part of the cache key
VERSION = 2

#: frontier densities the calibration sweeps (two mask families each)
DENSITIES = (0.02, 0.1, 0.3, 0.7, 1.0)

#: ridge regularizer of the (recursive) normal equations
RIDGE = 1e-9


def _features(degree_sum, count) -> np.ndarray:
    """The regression row ``[1, degree_sum, count]`` (float64; the
    prediction path is float32, as the device selector's)."""
    return np.array([1.0, float(degree_sum), float(count)], np.float64)


@dataclasses.dataclass
class CostModel:
    """Per-kernel affine iteration-cost models, argmin-selected.

    ``coeffs[k]`` is ``(a, b, c)`` for ``KERNELS[k]``: predicted seconds
    ``a + b·degree_sum + c·count``.  ``xtx``/``xty`` carry the normal
    equations, so :meth:`observe` refines without storing samples."""

    coeffs: np.ndarray                     # [3, 3] float64
    xtx: Optional[np.ndarray] = None       # [3, 3, 3] float64
    xty: Optional[np.ndarray] = None       # [3, 3] float64
    calibrated_on: Optional[dict] = None   # graph signature of the fit

    def __post_init__(self):
        self.coeffs = np.asarray(self.coeffs, np.float64).reshape(
            (len(KERNELS), 3))
        if self.xtx is None:
            self.xtx = np.tile(np.eye(3) * RIDGE, (len(KERNELS), 1, 1))
        if self.xty is None:
            self.xty = np.zeros((len(KERNELS), 3), np.float64)

    @classmethod
    def fresh(cls) -> "CostModel":
        """An uncalibrated model: zero coefficients, so every choice ties
        and takes BS until :meth:`observe` refines it."""
        return cls(coeffs=np.zeros((len(KERNELS), 3), np.float64))

    def coeff_array(self) -> np.ndarray:
        """The ``[3, 3]`` float32 coefficients the fused selector reads."""
        return self.coeffs.astype(np.float32)

    def predict(self, count: int, degree_sum: int) -> np.ndarray:
        """Predicted seconds per kernel, float32, each operation rounded
        (the device's order: ``a + b·es``, then ``+ c·cn``)."""
        c = self.coeff_array()
        es = np.float32(degree_sum)
        cn = np.float32(count)
        return c[:, 0] + c[:, 1] * es + c[:, 2] * cn

    def choose(self, count: int, degree_sum: int) -> str:
        """The cheapest kernel for one frontier; an edgeless or empty
        frontier takes BS."""
        if degree_sum == 0 or count == 0:
            return "BS"
        return KERNELS[int(np.argmin(self.predict(count, degree_sum)))]

    def observe(self, kernel: str, degree_sum: int, count: int,
                seconds: float) -> None:
        """Fold one measured iteration into the model."""
        if kernel not in KERNELS or not np.isfinite(seconds) or seconds < 0:
            return
        k = KERNELS.index(kernel)
        x = _features(degree_sum, count)
        self.xtx[k] += np.outer(x, x)
        self.xty[k] += x * float(seconds)
        self.coeffs[k] = np.linalg.solve(self.xtx[k], self.xty[k])

    def to_dict(self) -> dict:
        return {
            "version": VERSION,
            "kernels": list(KERNELS),
            "coeffs": self.coeffs.tolist(),
            "xtx": self.xtx.tolist(),
            "xty": self.xty.tolist(),
            "calibrated_on": self.calibrated_on,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CostModel":
        if d.get("version") != VERSION or tuple(d.get("kernels", ())) != \
                KERNELS:
            raise ValueError("incompatible cost-model cache")
        return cls(coeffs=np.asarray(d["coeffs"], np.float64),
                   xtx=np.asarray(d["xtx"], np.float64),
                   xty=np.asarray(d["xty"], np.float64),
                   calibrated_on=d.get("calibrated_on"))

    def save(self, path: str) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(self.to_dict(), fh)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "CostModel":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def device_name(device) -> str:
    """What a calibration's device is called: the card's name, or
    ``"cpu"``."""
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def graph_signature(graph: CSRGraph, device="cuda",
                    sched: Schedule = DEFAULT_SCHEDULE) -> dict:
    """What a calibration is valid for: the graph's shape, the device it
    was timed on, the schedule and the protocol version (the port has no
    ``backend``; the device's name takes its place)."""
    return {
        "n": int(graph.num_nodes),
        "e": int(graph.num_edges),
        "max_degree": int(graph.max_degree),
        "device": device_name(device),
        "schedule": sched.to_json(),
        "version": VERSION,
    }


def cache_path(cache_dir: str, sig: dict) -> str:
    """The cache file of one signature (``zlib.crc32`` keys: stable across
    processes, unlike ``hash``)."""
    sched_key = zlib.crc32(sig["schedule"].encode())
    dev_key = zlib.crc32(sig["device"].encode())
    key = (f"{sig['n']}n-{sig['e']}e-{sig['max_degree']}d-"
           f"{dev_key:08x}-{sched_key:08x}-v{sig['version']}")
    return os.path.join(cache_dir, f"costmodel-torch-{key}.json")


def _calibration_masks(n: int, degrees: np.ndarray):
    """Deterministic frontier masks spanning the (count, degree_sum)
    plane: a node-id prefix and an evenly strided selection per density."""
    masks = []
    for rho in DENSITIES:
        k = max(1, int(round(rho * n)))
        prefix = np.zeros(n, bool)
        prefix[:k] = True
        masks.append(prefix)
        if k < n:
            strided = np.zeros(n, bool)
            strided[np.linspace(0, n - 1, k).astype(np.int64)] = True
            masks.append(strided)
    return masks


def _time_call(fn, repeats: int, cuda: bool) -> float:
    """Min-of-``repeats`` seconds of ``fn``: CUDA events around each call
    on the card, ``perf_counter`` on the CPU."""
    best = float("inf")
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def measure(graph: CSRGraph, *, device="cuda",
            sched: Schedule = DEFAULT_SCHEDULE, repeats: int = 3):
    """Time one dense step of BS, WD and HP on ``graph`` from each
    calibration mask (after a warm-up call).  Returns ``(rows, times)``:
    design rows ``[1, degree_sum, count]`` and per-kernel seconds."""
    from repro_torch.core import fused, operators
    from repro_torch.kernels import fused as fused_kernel

    dev = resolve_device(device)
    graph = graph.to(dev)
    op = operators.shortest_path
    degrees = graph.degrees.cpu().numpy()
    resolved = sched.resolved(degrees)
    dist0 = np.full(graph.num_nodes, np.iinfo(np.int32).max, np.int32)
    dist0[: max(1, graph.num_nodes // 64)] = 0   # mixed settled/unsettled
    dist0 = torch.from_numpy(dist0).to(dev)

    if dev.type == "cuda":
        def step(kernel):
            return lambda d, m: fused_kernel.fixed_point(
                kernel, graph, None, d, m, op=op, sched=resolved,
                max_iterations=1)
        steps = {k: step(k) for k in KERNELS}
    else:
        steps = {
            "BS": lambda d, m: fused._bs_step(graph, d, m, op=op),
            "WD": lambda d, m: fused._wd_step(graph, d, m, op=op),
            "HP": lambda d, m: fused._hp_step(graph, d, m, sched=resolved,
                                              op=op),
        }

    rows, times = [], []
    for mask_np in _calibration_masks(graph.num_nodes, degrees):
        mask = torch.from_numpy(mask_np).to(dev)
        count = int(mask_np.sum())
        degree_sum = int(degrees[mask_np].sum())
        col = []
        for name in KERNELS:
            fn = steps[name]
            fn(dist0, mask)                       # warm-up
            col.append(_time_call(lambda: fn(dist0, mask), repeats,
                                  dev.type == "cuda"))
        rows.append(_features(degree_sum, count))
        times.append(col)
    return np.asarray(rows), np.asarray(times)


def fit(rows: np.ndarray, times: np.ndarray,
        calibrated_on: Optional[dict] = None) -> CostModel:
    """Ridge least squares per kernel, keeping the normal equations so
    :meth:`CostModel.observe` continues the same fit online."""
    xtx = np.tile(np.eye(3) * RIDGE, (len(KERNELS), 1, 1))
    xty = np.zeros((len(KERNELS), 3), np.float64)
    for row, col in zip(rows, times):
        outer = np.outer(row, row)
        for k in range(len(KERNELS)):
            xtx[k] += outer
            xty[k] += row * float(col[k])
    coeffs = np.stack([np.linalg.solve(xtx[k], xty[k])
                       for k in range(len(KERNELS))])
    return CostModel(coeffs=coeffs, xtx=xtx, xty=xty,
                     calibrated_on=calibrated_on)


def calibrate(graph: CSRGraph, *, device="cuda",
              sched: Schedule = DEFAULT_SCHEDULE,
              cache_dir: Optional[str] = None, force: bool = False,
              repeats: int = 3):
    """The calibrated :class:`CostModel` of ``graph`` on ``device``.
    Returns ``(model, cache_hit)``: with ``cache_dir`` set, an earlier
    calibration of the same :func:`graph_signature` loads instead of
    timing again; ``force=True`` times anew and overwrites."""
    sig = graph_signature(graph, device, sched)
    path = cache_path(cache_dir, sig) if cache_dir else None
    if path and not force and os.path.exists(path):
        try:
            model = CostModel.load(path)
            if model.calibrated_on == sig:
                return model, True
        except (ValueError, OSError, KeyError):
            pass                      # stale or corrupt cache: time anew
    rows, times = measure(graph, device=device, sched=sched,
                          repeats=repeats)
    model = fit(rows, times, calibrated_on=sig)
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        model.save(path)
    return model, False


# ---------------------------------------------------------------------------
# block feasibility on the card
# ---------------------------------------------------------------------------

#: the H100's limits the shapes are held to (NVIDIA's data sheet)
SMEM_PER_SM = 228 * 1024
SMEM_PER_BLOCK = 227 * 1024
REGISTERS_PER_SM = 65536
#: the port's block shapes, by kernel (``relax_lanes.cuh``, ``relax.cu``,
#: ``fused.cu``, ``flash_attention.cu``, ``ssd_chunk.cu``): B1's tile of
#: lanes and slice of slots, B2's tile, B1's batch contract's tile of
#: (lane, quad) items, B3's tile of items and staged prefix slice, B4's
#: rows and keys a tile, B5's 64-row strips
BLOCK_SHAPES = {
    "relax_lanes": dict(lanes=512),
    "wd_relax_lanes": dict(lanes=1024, slots=2048),
    "wd_relax_union": dict(items=512, slots=2048),
    "find_offsets": dict(items=2048, slots=4096),
    "fused_fixed_point": dict(grid="cooperative"),
    "fused_delta": dict(grid="cooperative"),
    "flash_attention": dict(rows=64, keys=64),
    "flash_attention_bwd_dkdv": dict(rows=64, keys=64),
    "flash_attention_bwd_dq": dict(rows=64, keys=64),
    "ssd_chunk_dual": dict(strip=64),
    "ssd_chunk_dual_bwd": dict(strip=64),
}
#: the C entry point reporting each graph kernel and its ``which``
_ATTR_KERNELS = {"relax_lanes": ("repro_relax_block_attrs", 0),
                 "wd_relax_lanes": ("repro_relax_block_attrs", 1),
                 "wd_relax_union": ("repro_relax_block_attrs", 2),
                 "find_offsets": ("repro_relax_block_attrs", 3),
                 "fused_fixed_point": ("repro_fused_block_attrs", 0),
                 "fused_delta": ("repro_fused_block_attrs", 1)}
#: B5's shape in the report: mamba2_780m's prefill of 2048 tokens
#: (BN, c, H, P, N)
SSD_REPORT_SHAPE = (8, 256, 48, 64, 128)


def attr_calls() -> dict:
    """Report row name -> (kernel, C entry point, its leading arguments,
    the row's shape): the six graph kernels, B4's kernel and its two
    backward kernels for each dtype and (q/k, v) head-dim pair they take,
    and B5's kernel and its backward kernel for each dtype at
    :data:`SSD_REPORT_SHAPE`."""
    from repro_torch.kernels._build import DTYPE_CODES
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    calls = {name: (name, fn, (which,), {})
             for name, (fn, which) in _ATTR_KERNELS.items()}
    for dtype, code in sorted(DTYPE_CODES.items(), key=lambda kv: kv[1]):
        dname = str(dtype).rsplit(".", 1)[-1]
        for hd, hd_v in HEAD_DIMS:
            name = (f"flash_attention {dname} hd{hd}" if hd == hd_v else
                    f"flash_attention {dname} hd{hd}/{hd_v}")
            shape = dict(dtype=dname, hd=hd, hd_v=hd_v)
            calls[name] = ("flash_attention", "repro_flash_block_attrs",
                           (code, hd, hd_v), shape)
            for which, part in enumerate(("dkdv", "dq")):
                calls[f"{name} bwd {part}"] = (
                    f"flash_attention_bwd_{part}",
                    "repro_flash_bwd_block_attrs", (code, hd, hd_v, which),
                    shape)
        shape = dict(dtype=dname, **dict(zip("BN c H P N".split(),
                                             SSD_REPORT_SHAPE)))
        calls[f"ssd_chunk_dual {dname}"] = (
            "ssd_chunk_dual", "repro_ssd_block_attrs",
            (code, *SSD_REPORT_SHAPE), shape)
        calls[f"ssd_chunk_dual_bwd {dname}"] = (
            "ssd_chunk_dual_bwd", "repro_ssd_bwd_block_attrs",
            (code, *SSD_REPORT_SHAPE[3:]), shape)
    return calls


def block_feasibility(device="cuda") -> dict:
    """Each of the port's kernels (:func:`attr_calls`) as the card reports
    it: threads a block, static shared memory, the dynamic shared memory
    its launcher requests, registers a thread, local (spill) bytes a
    thread, blocks resident per SM, and whether it is feasible by
    arithmetic against the H100's limits (shared memory per block and per
    SM, registers per SM).  Needs a card."""
    from repro_torch.kernels import _build
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("block_feasibility reads the card's kernel "
                         "attributes; pass a CUDA device")
    out = {}
    lib = _build.lib()
    for name, (kernel, fn, args, shape) in attr_calls().items():
        vals = (ctypes.c_int * _build.ATTR_CELLS)()
        with torch.cuda.device(dev):
            _build.check(fn, getattr(lib, fn)(*args, vals))
        threads, static, regs, local, per_sm, sms, dynamic = list(vals)
        smem = static + dynamic
        by_regs = REGISTERS_PER_SM // max(regs * threads, 1)
        by_smem = SMEM_PER_SM // smem if smem else by_regs
        feasible = (smem <= SMEM_PER_BLOCK and regs * threads
                    <= REGISTERS_PER_SM and min(by_regs, by_smem) >= 1
                    and per_sm >= 1)
        out[name] = dict(BLOCK_SHAPES[kernel], **shape, kernel=kernel,
                         threads=threads, static_smem_bytes=static,
                         dynamic_smem_bytes=dynamic, registers=regs,
                         local_bytes=local, blocks_per_sm=per_sm,
                         blocks_by_registers=by_regs,
                         blocks_by_smem=by_smem, sms=sms,
                         feasible=bool(feasible))
    return out


# ---------------------------------------------------------------------------
# command line: calibrate and report the cache's state
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="calibrate AD's cost model and report the cache state")
    ap.add_argument("--cache", required=True, help="calibration cache dir")
    ap.add_argument("--graph", default="rmat", choices=("rmat", "road"))
    ap.add_argument("--scale", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.data import rmat_graph, road_grid_graph
    if args.graph == "rmat":
        g = rmat_graph(scale=args.scale, edge_factor=6, weighted=True,
                       seed=7, device="cpu")
    else:
        g = road_grid_graph(side=1 << max(1, args.scale // 2),
                            weighted=True, seed=7, device="cpu")
    model, hit = calibrate(g, device=args.device, cache_dir=args.cache,
                           force=args.force, repeats=args.repeats)
    print(f"cache: {'hit' if hit else 'miss'}")
    for name, (a, b, c) in zip(KERNELS, model.coeffs):
        print(f"{name}: a={a:.3e} b={b:.3e} c={c:.3e}")
    if resolve_device(args.device).type == "cuda":
        for name, row in block_feasibility(args.device).items():
            print(f"{name}: {json.dumps(row)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
