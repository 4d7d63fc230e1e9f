"""The dry run of the port: count each (arch × shape × mesh) cell's step
without allocating it (the counterpart of :mod:`repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_0_6b \\
        --shape train_4k --mesh single

The reference lowers and compiles each cell for 512 placeholder devices
and reads XLA's cost and memory analyses.  The port has no HLO: it traces
the global step once over meta tensors (:func:`count_step`; the layers
are a Python loop, so no depth correction is needed):

* FLOPs: the products, by ``torch.utils.flop_counter.FlopCounterMode``'s
  formulas (its ``flop_registry``, read in the one dispatch mode that
  also counts bytes: nesting ``FlopCounterMode`` itself costs a second
  Python dispatch an op, and the count is the same, which
  ``tests/test_torch_dryrun.py`` holds), plus B4's and B5's closed forms
  (forward and backward), which their meta branches add to a
  ``kernels.cost.count_kernels`` counter;
* bytes: every dispatched op's input and output bytes (views and empty
  allocations move none), an eager upper bound on XLA's fused ``bytes
  accessed``, plus the kernels' closed-form bytes in place of their ops;
* both divided by the mesh's chips;
* collective bytes: ``roofline.analysis.collective_bytes_of_plan``;
* ``bytes_per_device``: the resident state's shards (each leaf's
  ``launch.mesh.shard_shape`` on the mesh: the parameters; to train, AdamW's
  ``m`` and ``v`` in ``opt_state_dtype`` and the gradients; to serve, the
  cache) plus the trace's peak live activation bytes (each op's outputs
  added as they are made, removed when freed; the gradients excluded)
  divided by the data-parallel ways.

The record's schema differs from the reference's in these keys only:

* ``trace_s`` (the meta trace's seconds) in place of ``compile_s``, and
  no ``lower_s``;
* ``memory_analysis`` states the port's formula with its terms, not
  XLA's ``memory_analysis()``;
* ``collective_detail`` also holds ``link_bw``, and the collective term
  divides by it;
* ``kernels``: the B4/B5 meta calls of the step by kernel name (calls,
  bytes, FLOPs), and ``activation_peak_bytes``, the trace's peak;
* no ``--save-hlo`` (there is no HLO).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCHITECTURES, get_config, normalize
from repro_torch.kernels.cost import count_kernels
from repro_torch.launch.mesh import (data_axes, make_production_mesh,
                                     mesh_chip_count, shard_shape)
from repro_torch.launch.shapes import SHAPES, skip_reason
from repro_torch.launch.steps import build_step
from repro_torch.models.params import leaves
from repro_torch.roofline.analysis import (collective_bytes_of_plan,
                                           model_flops_for, roofline_terms)

#: ops that allocate without moving a byte (the meta branches' outputs)
_ALLOCATIONS = {torch.ops.aten.empty.memory_format,
                torch.ops.aten.empty_strided.default,
                torch.ops.aten.new_empty.default,
                torch.ops.aten.new_empty_strided.default,
                torch.ops.aten.empty_like.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """FLOPs (``FlopCounterMode``'s formulas) and bytes (inputs read,
    outputs written) of every dispatched op, and the lifetime of every
    storage the ops make, in op order (a storage an op is given, such as
    a parameter updated in place, was not made by it)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self._born = WeakIdKeyDictionary()   # storage -> interval index
        self.intervals = []                  # [born, died, nbytes]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if func.is_view:          # no byte moved, no storage made
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if func not in _ALLOCATIONS:
            self.bytes += sum(_nbytes(t) for t in ins)
            self.bytes += sum(_nbytes(t) for t in outs)
        given = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            # an in-place or out= op writes a storage it was given
            if id(st) in given or st in self._born:
                continue
            self._born[st] = len(self.intervals)
            self.intervals.append([self.ops, None, st.nbytes()])
            weakref.finalize(st, self._free, len(self.intervals) - 1)
        return out

    def _free(self, i: int) -> None:
        self.intervals[i][1] = self.ops

    def peak_live(self, keep=()) -> int:
        """The largest total of storages alive at once, leaving out those
        of the tensors ``keep`` (the step's gradients)."""
        skip = {self._born[t.untyped_storage()] for t in keep
                if t.untyped_storage() in self._born}
        events = []
        for i, (born, died, nb) in enumerate(self.intervals):
            if i in skip:
                continue
            events.append((born, nb))
            events.append((self.ops + 1 if died is None else died, -nb))
        live = peak = 0
        for _, delta in sorted(events, key=lambda e: (e[0], e[1])):
            live += delta
            peak = max(peak, live)
        return peak


def count_step(built) -> dict:
    """Trace ``built.fn(*built.args)`` once over meta tensors: the global
    step's FLOPs and bytes (kernels included), the kernels' meta calls
    and the peak live activation bytes."""
    t0 = time.perf_counter()
    with count_kernels() as kernels, StepCounter() as ops:
        out = built.fn(*built.args)
    keep = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    return {
        "trace_s": round(time.perf_counter() - t0, 2),
        "flops": ops.flops + kernels.total_flops,
        "bytes": ops.bytes + kernels.total_bytes,
        "activation_peak_bytes": ops.peak_live(keep),
        "ops": ops.ops,
        "kernels": {name: {"calls": kernels.calls[name],
                           "bytes": kernels.bytes[name],
                           "flops": kernels.flops[name]}
                    for name in sorted(kernels.calls)},
    }


def state_bytes(specs: dict, mesh) -> dict:
    """Per-device bytes of each named spec tree (every leaf's
    ``shard_shape`` on ``mesh``)."""
    out = {}
    for name, tree in specs.items():
        total = 0
        for _, s in leaves(tree):
            n = s.torch_dtype.itemsize
            for dim in shard_shape(s, mesh):
                n *= dim
            total += n
        out[name] = total
    return out


def count_cell(cfg, shape, mesh, *, traces: dict | None = None) -> dict:
    """The fields of an ``ok`` record of ``cfg`` at ``shape`` on ``mesh``
    (a ``launch.mesh.ProductionMesh``): the step's counts a device, its
    collectives, resident bytes and roofline.

    ``traces`` (a dict the caller owns) keeps each (cfg, shape) trace for
    another mesh, which divides the same global counts."""
    chips = mesh_chip_count(mesh)
    built = build_step(cfg, shape, mesh)
    key = (cfg, shape)
    if traces is not None and key in traces:
        counted = traces[key]
    else:
        counted = count_step(built)
        if traces is not None:
            traces[key] = counted
    flops = counted["flops"] / chips
    bytes_accessed = counted["bytes"] / chips
    coll = collective_bytes_of_plan(cfg, shape, mesh)

    dp = mesh.size(data_axes(mesh))
    dp = dp if shape.global_batch % dp == 0 else 1
    state = state_bytes(built.specs, mesh)
    act = counted["activation_peak_bytes"] / dp
    bytes_per_device = sum(state.values()) + act
    mem_text = ("bytes_per_device = " + " + ".join(
        f"{k} {v}" for k, v in state.items())
        + f" (per-device shards) + activation peak "
          f"{counted['activation_peak_bytes']} / {dp} data ways")

    n_active = cfg.active_params()
    mf = model_flops_for(cfg, shape.kind, shape.seq_len, shape.global_batch,
                         n_active)
    report = roofline_terms(
        arch=cfg.name, shape=shape.name, mesh_name=mesh.name, chips=chips,
        per_device_flops=flops, per_device_bytes=bytes_accessed,
        per_device_collective_bytes=coll["total"], model_flops=mf,
        bytes_per_device=bytes_per_device, collective_detail=coll)
    return dict(
        chips=chips,
        trace_s=counted["trace_s"],
        per_device_flops=flops,
        per_device_bytes=bytes_accessed,
        collective_bytes_per_device=coll["total"],
        collective_detail=coll,
        bytes_per_device=bytes_per_device,
        memory_analysis=mem_text,
        model_flops=mf,
        active_params=n_active,
        kernels=counted["kernels"],
        activation_peak_bytes=counted["activation_peak_bytes"],
        roofline={
            "compute_s": report.compute_s,
            "memory_s": report.memory_s,
            "collective_s": report.collective_s,
            "dominant": report.dominant,
            "useful_ratio": report.useful_ratio,
        },
    )


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str = "experiments/dryrun_torch",
             config_overrides: dict | None = None,
             traces: dict | None = None) -> dict:
    """Count one (arch × shape × mesh) cell (:func:`count_cell`); write
    and return its record."""
    cfg = get_config(arch)
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh.name,
           "kind": shape.kind}
    reason = skip_reason(cfg, shape)
    if reason:
        rec.update(status="skipped", reason=reason)
    else:
        rec.update(status="ok", **count_cell(cfg, shape, mesh,
                                             traces=traces))
    suffix = "_opt" if config_overrides and not reason else ""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{normalize(arch)}__{shape_name}__"
                                    f"{mesh.name}{suffix}.json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="dry run over meta tensors")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig overrides")
    args = ap.parse_args(argv)

    archs = ARCHITECTURES if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    overrides = json.loads(args.override) if args.override else None

    failures = 0
    for arch in archs:
        for shape in shapes:
            traces = {}
            for mp in meshes:
                tag = f"{arch} × {shape} × {'2x16x16' if mp else '16x16'}"
                try:
                    rec = run_cell(arch, shape, multi_pod=mp, out_dir=args.out,
                                   config_overrides=overrides, traces=traces)
                except Exception:
                    failures += 1
                    print(f"[FAIL] {tag}\n{traceback.format_exc()}")
                    continue
                if rec["status"] == "skipped":
                    print(f"[skip] {tag}: {rec['reason']}")
                else:
                    r = rec["roofline"]
                    print(f"[ ok ] {tag}: trace={rec['trace_s']}s "
                          f"flops/dev={rec['per_device_flops']:.3e} "
                          f"coll/dev={rec['collective_bytes_per_device']:.3e}B "
                          f"dominant={r['dominant']} "
                          f"useful={r['useful_ratio']:.2f} "
                          f"mem/dev={_gb(rec['bytes_per_device'])}",
                          flush=True)
    print(f"\ndry-run complete; failures={failures}")
    return 1 if failures else 0


def _gb(x):
    if x is None:
        return "n/a"
    return f"{x/2**30:.2f}GiB"


if __name__ == "__main__":
    raise SystemExit(main())
