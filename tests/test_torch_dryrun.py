"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``).

* **FLOPs against the reference.**  The smoke train cells (2 x 64) of
  qwen3_0_6b, mamba2_780m and granite_moe_3b_a800m: the port's count
  (products by ``FlopCounterMode``'s formulas plus B4's/B5's closed
  forms) over the reference's depth-corrected compile count on one host
  device (``repro/launch/dryrun.py``'s method) lies in ``FLOP_BAND``.  The
  port counts below the reference for two reasons: XLA's ``flops`` also
  counts every elementwise op (one a element) where ``FlopCounterMode``
  counts products only, and the reference's XLA attention multiplies the
  whole S x S logits where B4's closed form counts the causal
  ``S(S+1)/2`` pairs it computes.  Measured 0.82-0.86; the band's floor,
  0.75, leaves room for the elementwise share of a config (mamba2's gated
  norm and conv) and catches a lost product (a layer's matmul is more
  than a quarter of its FLOPs); its ceiling, 1.0, catches a double count.
* **The count is ``FlopCounterMode``'s.**  ``count_step``'s products
  equal ``FlopCounterMode``'s own total on the same step.
* **Kernel calls.**  A step's B4/B5 meta calls are those the card
  launches: with ``remat`` a forward a layer twice, a backward once.
* **``run_cell``.**  Its record has the reference's keys but for the
  stated differences, and it skips exactly the cells ``skip_reason``
  skips.
* **The CLIs.**  ``launch.train --production`` without ``--dry-run``
  raises; ``launch.dryrun`` exits 0 and writes its records.
* **Devices.**  ``"meta"`` is admitted only where an abstract model is
  built; ``device="cuda"`` without a card still raises.
"""

import dataclasses
import json

import jax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as ref_get_config
from repro.launch.mesh import make_host_mesh
from repro.launch.shapes import ShapeSpec as RefShapeSpec
from repro.launch.steps import build_step as ref_build_step
from repro.models.model import LanguageModel as RefLM
from repro.moe.sharded import use_mesh

from repro_torch.configs import get_config
from repro_torch.core.graph import resolve_device
from repro_torch.launch import dryrun
from repro_torch.launch import train as train_launcher
from repro_torch.launch.mesh import ProductionMesh, data_group
from repro_torch.launch.shapes import SHAPES, ShapeSpec, skip_reason
from repro_torch.launch.steps import build_step, build_train_step
from repro_torch.models.model import LanguageModel
from repro_torch.kernels.cost import count_kernels

ONE_CARD = ProductionMesh((1, 1), ("data", "model"))
SMOKE_CELL = (2, 64)
FLOP_BAND = (0.75, 1.0)
#: the reference's record keys (``repro/launch/dryrun.py`` ``run_cell``)
REF_KEYS = {"arch", "shape", "mesh", "kind", "status", "chips", "lower_s",
            "compile_s", "per_device_flops", "per_device_bytes",
            "collective_bytes_per_device", "collective_detail",
            "bytes_per_device", "memory_analysis", "model_flops",
            "active_params", "roofline"}
#: the port's stated differences (``launch/dryrun.py``'s docstring)
PORT_KEYS = (REF_KEYS - {"lower_s", "compile_s"}) | {
    "trace_s", "kernels", "activation_peak_bytes"}


def _ref_compiled_flops(cfg, shape, mesh) -> float:
    built = ref_build_step(cfg, shape, mesh)
    compiled = jax.jit(built.fn, in_shardings=built.in_shardings,
                       out_shardings=built.out_shardings,
                       donate_argnums=built.donate_argnums).lower(
        *built.args_abstract).compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    return float(cost.get("flops", 0.0))


def _ref_count(arch: str) -> float:
    """The reference's FLOPs of the smoke train cell: its compile count,
    corrected for the layer scan (counted once by XLA) by compiling one
    and two periods unrolled and extrapolating to the full depth."""
    cfg = ref_get_config(arch).smoke()
    B, S = SMOKE_CELL
    shape = RefShapeSpec("smoke", S, B, "train")
    mesh = make_host_mesh()
    with mesh, use_mesh(mesh):
        model = RefLM(cfg)
        flops = _ref_compiled_flops(cfg, shape, mesh)
        if model.n_repeats > 1:
            base = model.prefix_len + model.period
            opts = dict(scan_impl="unroll", attn_block_q=2048,
                        attn_block_k=2048)
            f1 = _ref_compiled_flops(dataclasses.replace(
                cfg, num_layers=base, **opts), shape, mesh)
            f2 = _ref_compiled_flops(dataclasses.replace(
                cfg, num_layers=base + model.period, **opts), shape, mesh)
            flops = f1 + (f2 - f1) * (model.n_repeats - 1)
    return flops


def _smoke_step(arch: str):
    B, S = SMOKE_CELL
    return build_step(get_config(arch).smoke(),
                      ShapeSpec("smoke", S, B, "train"), ONE_CARD)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "mamba2_780m",
                                  "granite_moe_3b_a800m"])
def test_smoke_flops_against_the_reference(arch):
    got = dryrun.count_step(_smoke_step(arch))["flops"]
    want = _ref_count(arch)
    ratio = got / want
    print(f"{arch}: port {got:.4e} / reference {want:.4e} = {ratio:.4f}")
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1]


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "mamba2_780m",
                                  "deepseek_v3_671b"])
def test_count_is_flop_counter_modes(arch):
    """The products of ``count_step`` are ``FlopCounterMode``'s own total
    on the same step (the kernels' closed forms added to both)."""
    counted = dryrun.count_step(_smoke_step(arch))
    built = _smoke_step(arch)
    with count_kernels() as kernels, \
            FlopCounterMode(display=False) as mode:
        built.fn(*built.args)
    assert counted["flops"] == mode.get_total_flops() + kernels.total_flops
    assert counted["kernels"] == {
        k: {"calls": kernels.calls[k], "bytes": kernels.bytes[k],
            "flops": kernels.flops[k]} for k in sorted(kernels.calls)}


@pytest.mark.parametrize("arch,calls", [
    ("qwen3_0_6b", {"flash_attention": 8, "flash_attention_bwd": 4}),
    ("mamba2_780m", {"ssd_chunk_dual": 8, "ssd_chunk_dual_bwd": 4}),
    # 8 layers (jamba's attn_every): 1 attention, 7 Mamba-2
    ("jamba_1_5_large_398b", {"flash_attention": 2, "flash_attention_bwd": 1,
                              "ssd_chunk_dual": 14,
                              "ssd_chunk_dual_bwd": 7}),
])
def test_kernel_calls_of_a_step(arch, calls):
    """With ``remat`` each layer runs its kernel forward twice (the
    forward and its recompute) and backward once, as the card does."""
    assert get_config(arch).smoke().remat
    got = dryrun.count_step(_smoke_step(arch))["kernels"]
    assert {k: v["calls"] for k, v in got.items()} == calls


@pytest.mark.parametrize("returned", [False, True])
def test_the_op_counter_on_a_hand_worked_step(returned):
    """A 4 MiB input: ``y = x * 2`` reads and writes 4 MiB and makes a
    4 MiB storage; ``x.add_(1)`` reads and writes 4 MiB in place and makes
    none; a view moves nothing.  The step's returned tensors (a train
    step's gradients) are left out of the live peak."""
    from repro_torch.launch.steps import BuiltStep
    mib4 = 4 << 20

    def fn(x):
        y = x * 2
        x.add_(1)
        return y.view(-1, 2) if returned else None
    counted = dryrun.count_step(BuiltStep(
        fn, (torch.empty(1 << 20, device="meta"),), ONE_CARD, {}))
    assert counted["bytes"] == 4 * mib4
    assert counted["activation_peak_bytes"] == (0 if returned else mib4)
    assert counted["flops"] == 0 and counted["kernels"] == {}


def test_counts_are_positive_and_the_gradients_are_state():
    counted = dryrun.count_step(_smoke_step("qwen3_0_6b"))
    assert counted["flops"] > 0 and counted["bytes"] > 0
    assert 0 < counted["activation_peak_bytes"] < counted["bytes"]


def _smoke_overrides(arch: str) -> dict:
    cfg = get_config(arch)
    smoke = cfg.smoke()
    return {f.name: getattr(smoke, f.name) for f in dataclasses.fields(cfg)
            if getattr(smoke, f.name) != getattr(cfg, f.name)}


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
def test_run_cell_writes_the_record(tmp_path, shape_name):
    """At smoke width and the production shape (meta tensors: the shape
    costs nothing), on both meshes."""
    overrides = _smoke_overrides("qwen3_0_6b")
    traces = {}
    recs = [dryrun.run_cell("qwen3_0_6b", shape_name, multi_pod=mp,
                            out_dir=str(tmp_path), traces=traces,
                            config_overrides=overrides)
            for mp in (False, True)]
    assert len(traces) == 1        # one trace serves both meshes
    for rec, mesh, chips in zip(recs, ("16x16", "2x16x16"), (256, 512)):
        assert set(rec) == PORT_KEYS
        assert (rec["status"], rec["mesh"], rec["chips"]) == ("ok", mesh,
                                                              chips)
        path = tmp_path / f"qwen3_0_6b__{shape_name}__{mesh}_opt.json"
        assert json.loads(path.read_text()) == json.loads(json.dumps(
            rec, default=str))
        assert rec["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
        assert rec["bytes_per_device"] > 0
        assert "activation peak" in rec["memory_analysis"]
    assert recs[0]["per_device_flops"] == 2 * recs[1]["per_device_flops"]


def test_run_cell_skips_long_context_for_full_attention(tmp_path):
    for arch, skipped in (("qwen3_0_6b", True), ("mamba2_780m", False)):
        assert bool(skip_reason(get_config(arch), SHAPES["long_500k"])) \
            == skipped
    rec = dryrun.run_cell("qwen3_0_6b", "long_500k", multi_pod=False,
                          out_dir=str(tmp_path))
    assert rec["status"] == "skipped" and "long_500k" in rec["reason"]
    assert json.loads((tmp_path / "qwen3_0_6b__long_500k__16x16.json")
                      .read_text()) == rec
    rec = dryrun.run_cell("mamba2_780m", "long_500k", multi_pod=True,
                          out_dir=str(tmp_path),
                          config_overrides=_smoke_overrides("mamba2_780m"))
    assert rec["status"] == "ok"
    assert rec["kernels"] == {}   # a decode step runs no B5


def test_dryrun_cli(tmp_path, capsys):
    args = ["--arch", "mamba2_780m", "--shape", "prefill_32k", "--mesh",
            "single", "--out", str(tmp_path), "--override",
            json.dumps(_smoke_overrides("mamba2_780m"))]
    assert dryrun.main(args) == 0
    out = capsys.readouterr().out
    assert "[ ok ] mamba2_780m × prefill_32k × 16x16" in out
    assert "failures=0" in out
    assert len(list(tmp_path.glob("*.json"))) == 1


def test_train_production_needs_the_dry_run(capsys):
    """``--production`` alone raises; with ``--dry-run`` it prints the
    production cell's counts, and ``--dry-run`` alone the host step's
    (``--batch`` x ``--seq`` on one card), as the reference's launcher
    does."""
    args = ["--arch", "qwen3_0_6b", "--smoke"]
    with pytest.raises(NotImplementedError, match="--dry-run"):
        train_launcher.main(args + ["--production"])
    flops = {}
    for name, extra in (
            ("16x16", ["--production", "--shape", "decode_32k"]),
            ("2x16x16", ["--production", "--shape", "decode_32k",
                         "--multi-pod"]),
            ("host", ["--seq", "32", "--batch", "2"])):
        assert train_launcher.main(args + ["--dry-run", *extra]) == 0
        out = capsys.readouterr().out
        assert "bytes_per_device" in out
        flops[name] = float(out.split("'flops': ")[1].split(",")[0])
    # 512 chips halve the 256 chips' per-device count of one global step
    assert flops["16x16"] == 2 * flops["2x16x16"] > 0
    assert flops["host"] > 0


def test_meta_is_admitted_only_for_an_abstract_model():
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        resolve_device("meta")
    assert resolve_device("meta", allow_meta=True).type == "meta"
    cfg = get_config("qwen3_0_6b").smoke()
    assert LanguageModel(cfg, device="meta").device.type == "meta"
    with pytest.raises(ValueError):
        data_group("meta")


def test_cuda_without_a_card_still_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("qwen3_0_6b").smoke()
    for make in (lambda: resolve_device("cuda"),
                 lambda: resolve_device("cuda", allow_meta=True),
                 lambda: LanguageModel(cfg, device="cuda"),
                 lambda: data_group("cuda"),
                 lambda: build_train_step(cfg, ShapeSpec("s", 8, 2,
                                                         "train"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
