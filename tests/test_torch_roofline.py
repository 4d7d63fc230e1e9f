"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``), and the B4/B5 meta branches that feed it.

Exact: ``model_flops_for``, ``active_params``, ``param_count`` and
``param_bytes`` of every config at every production shape; every
parameter leaf's per-device shard shape on both production meshes (the
reference's ``NamedSharding(AbstractMesh, adapt_pspec(pspec))``, which
holds the port's ``ParamSpec.pspec`` at every spec site to the
reference's); ``report.py``'s tables on the same records.  Hand-worked:
the three roofline terms at the H100 data sheet's figures, and the
collective plan of a dense and of an MoE config.  The meta branches: the
outputs' shapes and dtypes of each kernel's plain version on small CPU
inputs, exactly the closed-form FLOPs, no plain version run and no launch
counted.
"""

import dataclasses

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCHITECTURES as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.launch.mesh import adapt_pspec as ref_adapt_pspec
from repro.launch.shapes import SHAPES as REF_SHAPES
from repro.models.model import LanguageModel as RefLM
from repro.models.params import ParamSpec as RefSpec
from repro.models.params import param_bytes as ref_param_bytes
from repro.models.params import param_count as ref_param_count
from repro.roofline import analysis as ref_analysis
from repro.roofline import report as ref_report

from repro_torch.configs import ARCHITECTURES, all_configs, get_config
from repro_torch.kernels import cost
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.kernels._build import LAUNCHES
from repro_torch.launch.mesh import (ProductionMesh, make_production_mesh,
                                     shard_shape)
from repro_torch.launch.shapes import SHAPES, ShapeSpec
from repro_torch.launch.steps import make_optimizer
from repro_torch.models.model import LanguageModel, model_param_specs
from repro_torch.models.params import leaves, param_bytes, param_count
from repro_torch.roofline import analysis, report

MESHES = (False, True)


def test_the_registries_agree():
    assert ARCHITECTURES == REF_ARCHS
    assert list(all_configs()) == ARCHITECTURES
    assert list(SHAPES) == list(REF_SHAPES)


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_counts_equal_the_reference(arch, shape_name):
    """``model_flops_for`` and the parameter counts and bytes, exactly."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    shape = SHAPES[shape_name]
    ref_specs = RefLM(ref_cfg).param_specs()
    specs = model_param_specs(cfg)
    assert cfg.active_params() == ref_cfg.active_params()
    assert param_count(specs) == ref_param_count(ref_specs)
    assert param_bytes(specs) == ref_param_bytes(ref_specs)
    args = (shape.kind, shape.seq_len, shape.global_batch)
    assert analysis.model_flops_for(cfg, *args, cfg.active_params()) == \
        ref_analysis.model_flops_for(ref_cfg, *args, ref_cfg.active_params())


def _ref_leaves(tree, prefix=""):
    """``(path, ParamSpec)`` of the reference's spec tree, in the port's
    path convention."""
    if isinstance(tree, RefSpec):
        yield prefix[:-1], tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _ref_leaves(tree[k], f"{prefix}{k}.")
    else:
        for i, v in enumerate(tree):
            yield from _ref_leaves(v, f"{prefix}{i}.")


def _ref_shard_shapes(arch: str, multi_pod: bool) -> dict:
    """Each reference leaf's per-device shape under the port's paths: the
    reference stacks its periodic body ``[n_repeats, ...]`` (its specs
    ``P(None, *pspec)``), which the port holds as one leaf a layer."""
    model = RefLM(ref_get_config(arch))
    if multi_pod:
        mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    else:
        mesh = AbstractMesh((16, 16), ("data", "model"))
    out = {}
    for path, s in _ref_leaves(model.param_specs()):
        shp = NamedSharding(mesh, ref_adapt_pspec(s.pspec, mesh)
                            ).shard_shape(s.shape)
        head, *rest = path.split(".")
        if head == "prefix":
            out[".".join(["layers", *rest])] = shp
        elif head == "body":
            j, rest = int(rest[0]), rest[1:]
            for r in range(model.n_repeats):
                layer = model.prefix_len + r * model.period + j
                out[".".join(["layers", str(layer), *rest])] = shp[1:]
        else:
            out[path] = shp
    return out


@pytest.mark.parametrize("multi_pod", MESHES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_shard_shapes_equal_the_reference(arch, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    specs = model_param_specs(get_config(arch))
    got = {path: shard_shape(s, mesh) for path, s in leaves(specs)}
    assert got == _ref_shard_shapes(arch, multi_pod)


def _ref_cache_shard_shapes(arch: str, shape_name: str,
                            multi_pod: bool) -> dict:
    """The reference's decode cache (``cache_specs``, its serve step's
    ``seq_axis``) as per-device shapes under the port's paths: layer
    ``i``'s ``self`` entries by name and its ``cross`` entries as
    ``cross_*``; the reference's ``length`` and ``position`` counters have
    no counterpart."""
    model = RefLM(ref_get_config(arch))
    shape = REF_SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    mesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else AbstractMesh((16, 16), ("data", "model")))
    specs = model.cache_specs(B, S, seq_axis="data" if B % 16 else None)
    out = {}
    for path, s in _ref_leaves(specs):
        head, *rest = path.split(".")
        if head == "position" or rest[-1] == "length":
            continue
        shp = NamedSharding(mesh, ref_adapt_pspec(s.pspec, mesh)
                            ).shard_shape(s.shape)
        part, name = rest[-2], rest[-1]
        key = name if part == "self" else f"cross_{name}"
        if head == "prefix":
            out[f"layers.{rest[0]}.{key}"] = shp
        else:
            for r in range(model.n_repeats):
                layer = model.prefix_len + r * model.period + int(rest[0])
                out[f"layers.{layer}.{key}"] = shp[1:]
    return out


@pytest.mark.parametrize("multi_pod", MESHES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "mamba2_780m",
                                  "llama_3_2_vision_11b",
                                  "jamba_1_5_large_398b",
                                  "granite_moe_3b_a800m"])
def test_cache_shard_shapes_equal_the_reference(arch, shape_name,
                                                multi_pod):
    """The serve step's cache: the batch over ``data`` where 16 divide it,
    one long sequence's attention cache over ``data`` along the sequence
    (MLA, GQA, padded GQA, Mamba-2 and cross-attention caches)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    model = LanguageModel(get_config(arch), device="meta")
    specs = model.cache_specs(B, S, seq_axis="data" if B % 16 else None)
    got = {path: shard_shape(s, mesh) for path, s in leaves(specs)}
    assert got == _ref_cache_shard_shapes(arch, shape_name, multi_pod)


def test_optimizer_state_mirrors_the_parameters():
    """AdamW's moments keep each parameter's shape and partition spec in
    the state's dtype (deepseek: bfloat16 moments)."""
    cfg = get_config("deepseek_v3_671b")
    specs = model_param_specs(cfg)
    state = make_optimizer(cfg).state_specs(specs)
    mesh = make_production_mesh()
    for key in ("m", "v"):
        for (path, p), (path2, m) in zip(leaves(specs), leaves(state[key])):
            assert (path, p.shape, p.pspec) == (path2, m.shape, m.pspec)
            assert m.dtype == "bfloat16"
            assert shard_shape(m, mesh) == shard_shape(p, mesh)
    assert state["step"].shape == ()


def test_shard_shape_refuses_an_indivisible_dimension():
    spec = dataclasses.replace(model_param_specs(
        get_config("qwen3_0_6b"))["embed"], shape=(100, 8))
    with pytest.raises(ValueError, match="divide"):
        shard_shape(spec, make_production_mesh())


def _records() -> list:
    """Reference-format records: both meshes, a skip, and magnitudes that
    take every branch of ``fmt_s``/``fmt_b``."""
    recs = []
    for i, (arch, shape) in enumerate([("qwen3_0_6b", "train_4k"),
                                       ("mamba2_780m", "decode_32k"),
                                       ("deepseek_v3_671b", "prefill_32k")]):
        for mesh in ("16x16", "2x16x16"):
            recs.append({
                "arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
                "compile_s": 1.5 + i, "per_device_flops": 1.2345e13 * 10 ** i,
                "per_device_bytes": 6.5e10 / 10 ** i,
                "collective_bytes_per_device": 3.2e9 * i,
                "bytes_per_device": [512.0, 3 * 2 ** 21, 7.5 * 2 ** 40][i],
                "roofline": {"compute_s": [2.5, 4e-3, 3e-7][i],
                             "memory_s": [1e-3, 0.75, 12.0][i],
                             "collective_s": [0.0, 2e-5, 1.0][i],
                             "dominant": ["compute", "memory", "memory"][i],
                             "useful_ratio": 0.5 + i / 10}})
    recs.append({"arch": "qwen3_0_6b", "shape": "long_500k",
                 "mesh": "16x16", "status": "skipped", "reason": "r"})
    recs.append({"arch": "x", "shape": "y", "mesh": "16x16",
                 "status": "ok", "compile_s": 2.0, "per_device_flops": 1.0,
                 "per_device_bytes": 1.0, "collective_bytes_per_device": 0.0,
                 "roofline": {"compute_s": 1.0, "memory_s": 1.0,
                              "collective_s": 0.0, "dominant": "compute",
                              "useful_ratio": 1.0}})
    return recs


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_report_tables_equal_the_reference(mesh):
    recs = _records()
    assert report.dryrun_table(recs) == ref_report.dryrun_table(recs)
    assert report.roofline_table(recs, mesh) == \
        ref_report.roofline_table(recs, mesh)
    assert report.summarize(recs) == ref_report.summarize(recs)
    for x in (None, 0.5, 3e-4, 2.0, 5e-9):
        assert report.fmt_s(x) == ref_report.fmt_s(x)
    for x in (None, 100.0, 2 ** 20, 3 * 2 ** 30, 2 ** 41):
        assert report.fmt_b(x) == ref_report.fmt_b(x)


def test_report_names_the_ports_count():
    """On the port's records (``trace_s``) the table says trace, not
    compile, and no HLO."""
    recs = [{**r, "trace_s": r.pop("compile_s")} if "compile_s" in r else r
            for r in _records()]
    table = report.dryrun_table(recs)
    assert "| trace | FLOPs/dev | bytes/dev |" in table and "HLO" not in table
    assert "useful (6N·D/FLOPs)" in report.roofline_table(recs)


def test_roofline_terms_at_the_h100_figures():
    """Hand-worked: 256 chips, each with 494.5 TFLOP (0.5 s at 989
    TFLOP/s), 837.5 GB (0.25 s at 3.35 TB/s) and 5 GB of collectives
    (0.1 s across nodes at 50 GB/s, 11.1 ms over NVLink at 450 GB/s)."""
    hw = analysis.HARDWARE
    assert (hw["peak_flops"], hw["hbm_bw"], hw["nvlink_bw"],
            hw["internode_bw"]) == (989e12, 3.35e12, 450e9, 50e9)
    common = dict(arch="a", shape="s", mesh_name="16x16", chips=256,
                  per_device_flops=494.5e12, per_device_bytes=837.5e9,
                  per_device_collective_bytes=5e9, model_flops=6.33e16)
    r = analysis.roofline_terms(**common)
    assert r.compute_s == pytest.approx(0.5, rel=1e-12)
    assert r.memory_s == pytest.approx(0.25, rel=1e-12)
    assert r.collective_s == pytest.approx(0.1, rel=1e-12)
    assert r.dominant == "compute"
    assert r.hlo_flops == 494.5e12 * 256
    assert r.useful_ratio == pytest.approx(6.33e16 / (494.5e12 * 256))
    fast = analysis.roofline_terms(**common, collective_detail={
        "link_bw": hw["nvlink_bw"]})
    assert fast.collective_s == pytest.approx(5e9 / 450e9, rel=1e-12)
    slow = analysis.roofline_terms(**{**common,
                                      "per_device_collective_bytes": 5e10})
    assert slow.dominant == "collective" and slow.collective_s == \
        pytest.approx(1.0)


def test_link_rates_follow_the_node():
    """8 GPUs a node along ``model``: a ``model`` group of 8 stays on
    NVLink; 16 ``model`` ways, or any data axis, cross nodes."""
    hw = analysis.HARDWARE
    assert analysis.link_bw(ProductionMesh((4, 8), ("data", "model")),
                            "model") == hw["nvlink_bw"]
    assert analysis.link_bw(ProductionMesh((2, 4), ("data", "model")),
                            ("data", "model")) == hw["nvlink_bw"]
    mesh = make_production_mesh()
    assert analysis.link_bw(mesh, "model") == hw["internode_bw"]
    assert analysis.link_bw(mesh, "data") == hw["internode_bw"]
    assert make_production_mesh(multi_pod=True).chips == 512


def _tiny(base: str, **changes):
    return dataclasses.replace(get_config(base).smoke(), **changes)


def test_collectives_of_a_dense_train_step():
    """Hand-worked, 2 x 16 mesh, B = 4 x S = 8, bf16, one layer: d 32,
    16 heads of 4, d_ff 16, vocab 32 (16 divide every head, d_ff and
    vocab axis: all over ``model``).  No FSDP: the gradients are
    all-reduced over ``data``, each leaf's ``model`` shard; the mixer's
    ``wo`` and the FFN's ``w_down`` contract a ``model`` axis, so each
    sums its [B/2, S, D] output over ``model`` forward and backward."""
    cfg = _tiny("qwen3_0_6b", num_layers=1, d_model=32, num_heads=16,
                num_kv_heads=16, head_dim=4, d_ff=16, vocab_size=32,
                tie_embeddings=False, qk_norm=True)
    mesh = ProductionMesh((2, 16), ("data", "model"))
    got = analysis.collective_bytes_of_plan(
        cfg, ShapeSpec("t", 8, 4, "train"), mesh)
    grads = [32 * 32 * 2 // 16,                     # embed over vocab
             32 * 4, 32 * 4, 32 * 4,                # final_norm, ln1, ln2
             32 * 32 * 2 // 16,                     # lm_head
             4 * (32 * 16 * 4 * 2 // 16),           # wq wk wv wo
             4 * 4, 4 * 4,                          # q_norm, k_norm
             3 * (32 * 16 * 2 // 16)]               # w_up w_gate w_down
    grad_leaves = 1 + 3 + 1 + 4 + 2 + 3
    tokens = (4 // 2) * 8 * 32 * 2
    assert got["per_type"]["all-reduce"] == sum(grads) + 4 * tokens
    assert got["counts"]["all-reduce"] == grad_leaves + 4
    assert got["per_type"]["all-gather"] == got["per_type"][
        "reduce-scatter"] == got["per_type"]["all-to-all"] == 0
    assert got["total"] == sum(grads) + 4 * tokens
    assert got["link_bw"] == analysis.HARDWARE["internode_bw"]


def test_collectives_of_an_moe_prefill():
    """Hand-worked, 2 x 16 mesh, prefill B = 4 x S = 8, bf16: d 32, 16
    heads, 16 experts of top 2 over ``model`` at capacity factor 1.25, no
    shared expert.  No gradients; the mixer's output is summed over
    ``model`` once; the MoE layer dispatches and combines its [B/2, S, K]
    assignments (times the capacity factor) all to all."""
    cfg = _tiny("granite_moe_3b_a800m", num_layers=1, d_model=32,
                num_heads=16, num_kv_heads=16, head_dim=4, num_experts=16,
                experts_per_token=2, moe_d_ff=8, num_shared_experts=0,
                moe_capacity_factor=1.25, pad_heads=False)
    assert cfg.layer_is_moe(0)
    mesh = ProductionMesh((2, 16), ("data", "model"))
    got = analysis.collective_bytes_of_plan(
        cfg, ShapeSpec("p", 8, 4, "prefill"), mesh)
    tokens = 2 * 8 * 32 * 2
    assignments = 2 * 8 * 2 * 1.25 * 32 * 2
    assert got["per_type"]["all-reduce"] == tokens
    assert got["per_type"]["all-to-all"] == 2 * assignments
    assert got["counts"]["all-to-all"] == 2
    assert got["total"] == tokens + 2 * assignments


def test_one_card_has_no_collective():
    cfg = get_config("qwen3_0_6b")
    got = analysis.collective_bytes_of_plan(
        cfg, ShapeSpec("t", 2048, 4, "train"),
        ProductionMesh((1, 1), ("data", "model")))
    assert got["total"] == 0 and got["link_bw"] == \
        analysis.HARDWARE["nvlink_bw"]


# ---------------------------------------------------------------------------
# the kernels' meta branches
# ---------------------------------------------------------------------------

ATTN_CASES = [  # B, Hq, Hkv, Sq, Sk, hd, hd_v, causal, dtype
    (2, 4, 2, 16, 16, 32, 32, True, torch.bfloat16),
    (1, 6, 2, 12, 20, 64, 64, False, torch.float32),
    (2, 4, 4, 9, 9, 48, 32, True, torch.float32),
    (1, 2, 1, 10, 6, 32, 32, True, torch.float32),   # Sq > Sk, top-left
]


def refuse_plain(monkeypatch):
    """From here on the plain versions raise: a meta call must not reach
    them."""
    def refuse(*args, **kwargs):
        raise AssertionError("a meta call ran a plain version")
    for mod, names in ((fa, ("flash_attention_plain",
                             "flash_attention_bwd_plain")),
                       (sc, ("ssd_chunk_dual_plain",
                             "ssd_chunk_dual_bwd_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)


def _attn_inputs(B, Hq, Hkv, Sq, Sk, hd, hd_v, dtype, device):
    g = torch.Generator().manual_seed(0)
    return tuple(torch.randn(shape, generator=g).to(dtype).to(device)
                 for shape in ((B, Hq, Sq, hd), (B, Hkv, Sk, hd),
                               (B, Hkv, Sk, hd_v)))


def _kept_pairs(Sq, Sk, causal):
    return sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_meta_branch(case, monkeypatch):
    B, Hq, Hkv, Sq, Sk, hd, hd_v, causal, dtype = case
    q, k, v = _attn_inputs(B, Hq, Hkv, Sq, Sk, hd, hd_v, dtype, "cpu")
    want_o, want_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                                return_lse=True)
    dout = torch.ones_like(want_o)
    want_grads = fa.flash_attention_bwd_plain(q, k, v, want_o, want_lse,
                                              dout, causal=causal)
    meta = [t.to("meta") for t in (q, k, v)]
    refuse_plain(monkeypatch)
    before = dict(LAUNCHES)
    with cost.count_kernels() as counter:
        o = fa.flash_attention(*meta, causal=causal)
        qg, kg, vg = (t.clone().requires_grad_() for t in meta)
        o2 = fa.flash_attention(qg, kg, vg, causal=causal)
        grads = torch.autograd.grad(o2, (qg, kg, vg), torch.empty_like(o2))
    assert dict(LAUNCHES) == before
    for got, want in [(o, want_o), (o2, want_o), *zip(grads, want_grads)]:
        assert got.device.type == "meta"
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
    pairs = _kept_pairs(Sq, Sk, causal)
    fwd = 2 * B * Hq * pairs * (hd + hd_v)
    bwd = 2 * B * Hq * pairs * (3 * hd + 2 * hd_v)
    assert counter.calls == {"flash_attention": 2, "flash_attention_bwd": 1}
    assert counter.flops["flash_attention"] == 2 * fwd
    assert counter.flops["flash_attention_bwd"] == bwd
    size = 2 if dtype == torch.bfloat16 else 4
    assert counter.bytes["flash_attention"] == 2 * B * size * (
        Hq * Sq * (hd + hd_v) + Hkv * Sk * (hd + hd_v))
    if not causal or Sq <= Sk:    # the bounds' closed forms themselves
        one = cost.attention_cost(Sq, dtype, causal, (Hq, Hkv, hd, hd_v),
                                  Sk)
        assert counter.flops["flash_attention"] == 2 * B * one[1]
        assert (counter.bytes["flash_attention_bwd"],
                counter.flops["flash_attention_bwd"]) == \
            cost.attention_bwd_cost((Hq, Hkv, hd, hd_v), B, Sq, Sk,
                                    causal, dtype)


def test_flash_attention_backward_meta_branch(monkeypatch):
    refuse_plain(monkeypatch)
    B, Hq, Hkv, Sq, Sk, hd, hd_v = 1, 4, 2, 8, 8, 32, 32
    q, k, v = (t.to("meta") for t in _attn_inputs(
        B, Hq, Hkv, Sq, Sk, hd, hd_v, torch.bfloat16, "cpu"))
    o = torch.empty((B, Hq, Sq, hd_v), dtype=torch.bfloat16, device="meta")
    lse = torch.empty((B, Hq, Sq), device="meta")
    with cost.count_kernels() as counter:
        grads = fa.flash_attention_bwd(q, k, v, o, lse, o, causal=True)
    assert [(g.shape, g.dtype) for g in grads] == \
        [(t.shape, t.dtype) for t in (q, k, v)]
    assert counter.flops["flash_attention_bwd"] == cost.attention_bwd_cost(
        (Hq, Hkv, hd, hd_v), B, Sq, Sk, True, torch.bfloat16)[1]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_chunk_meta_branch(dtype, monkeypatch):
    BN, c, H, P, N = 3, 16, 4, 8, 16
    g = torch.Generator().manual_seed(1)
    xb = (torch.randn(BN, c, H, P, generator=g) * 0.1).to(dtype)
    cum = torch.cumsum(-torch.rand(BN, c, H, generator=g) * 0.1, 1)
    Bm, Cm = (torch.randn(BN, c, N, generator=g).to(dtype) for _ in "BC")
    want_y, want_s = sc.ssd_chunk_dual_plain(xb, cum, Bm, Cm)
    meta = [t.to("meta") for t in (xb, cum, Bm, Cm)]
    refuse_plain(monkeypatch)
    before = dict(LAUNCHES)
    with cost.count_kernels() as counter:
        y, st = sc.ssd_chunk_dual(*meta)
        leaves_ = [t.clone().requires_grad_() for t in meta]
        y2, st2 = sc.ssd_chunk_dual(*leaves_)
        grads = torch.autograd.grad((y2, st2), leaves_,
                                    (torch.empty_like(y2),
                                     torch.empty_like(st2)))
    assert dict(LAUNCHES) == before
    for got, want in ((y, want_y), (st, want_s), (y2, want_y),
                      (st2, want_s)):
        assert (got.device.type, got.shape, got.dtype) == \
            ("meta", want.shape, want.dtype)
    assert [(t.shape, t.dtype) for t in grads] == \
        [(t.shape, t.dtype) for t in (xb, cum, Bm, Cm)]
    fwd = cost.ssd_cost(BN, c, H, P, N, dtype)
    bwd = cost.ssd_bwd_cost(BN, c, H, P, N, dtype)
    assert counter.calls == {"ssd_chunk_dual": 2, "ssd_chunk_dual_bwd": 1}
    assert counter.flops["ssd_chunk_dual"] == 2 * fwd[1]
    assert counter.bytes["ssd_chunk_dual"] == 2 * fwd[0]
    assert (counter.bytes["ssd_chunk_dual_bwd"],
            counter.flops["ssd_chunk_dual_bwd"]) == bwd
    tri = c * (c + 1) // 2
    assert fwd[1] == 2 * BN * (tri * N + H * (tri * P + c * N * P))


def test_ssd_chunk_meta_shapes_equal_the_plain_versions():
    """The backward's outputs against the plain backward's on CPU inputs."""
    BN, c, H, P, N = 2, 8, 3, 4, 8
    g = torch.Generator().manual_seed(2)
    xb = torch.randn(BN, c, H, P, generator=g).to(torch.bfloat16)
    cum = torch.cumsum(-torch.rand(BN, c, H, generator=g), 1)
    Bm, Cm = (torch.randn(BN, c, N, generator=g).to(torch.bfloat16)
              for _ in "BC")
    dy = torch.randn(BN, c, H, P, generator=g)
    ds = torch.randn(BN, H, N, P, generator=g)
    want = sc.ssd_chunk_dual_plain(xb, cum, Bm, Cm)
    want_b = sc.ssd_chunk_dual_bwd_plain(xb, cum, Bm, Cm, dy, ds)
    got = sc.ssd_chunk_dual(*(t.to("meta") for t in (xb, cum, Bm, Cm)))
    got_b = sc.ssd_chunk_dual_bwd(*(t.to("meta") for t in
                                    (xb, cum, Bm, Cm, dy, ds)))
    for a, b in zip((*got, *got_b), (*want, *want_b)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)


def test_meta_calls_outside_a_counter_count_nothing():
    q, k, v = (torch.empty(1, 2, 4, 32, device="meta") for _ in "qkv")
    assert fa.flash_attention(q, k, v).device.type == "meta"
    with cost.count_kernels() as counter:
        pass
    assert counter.total_flops == 0 and not counter.calls
    np.testing.assert_equal(cost.attention_call_cost(
        1, 2, 2, 4, 4, 32, 32, True, torch.float32)[1],
        2 * 2 * 10 * 64)


def test_an_abstract_model_allocates_nothing():
    """``LanguageModel(cfg, device="meta")`` at deepseek's full width:
    every weight a meta tensor, none drawn."""
    model = LanguageModel(get_config("deepseek_v3_671b"), device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == param_count(
        model_param_specs(get_config("deepseek_v3_671b")))


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _literal_bound(nbytes, ops, bf16: bool):
    """A kernel's bound with the data sheet's figures written out as
    literals (HBM3 3.35e12 B/s; 989e12 bf16 and 67e12 f32 FLOP/s)."""
    t_bytes = nbytes / 3.35e12 * 1e3
    t_ops = ops / (989e12 if bf16 else 67e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_chip_smokes_bounds_bit_for_bit(dtype):
    """``chip_smoke.py`` takes its peaks from ``roofline.analysis`` and
    its closed forms from ``kernels.cost``; the bounds it prints at the
    kernel table's shapes equal the literal formula bit for bit."""
    cs = _chip_smoke()
    bf16 = dtype == torch.bfloat16
    cases = [cost.attention_cost(2048, dtype, True, (16, 8, 128)),
             cost.attention_cost(2048, dtype, False, (32, 8, 128), 1601),
             cost.attention_cost(2048, dtype, True, (128, 128, 192, 128)),
             cost.attention_bwd_cost((16, 8, 128, 128), 4, 2048, 2048,
                                     True, dtype),
             cost.ssd_cost(8, 256, 48, 64, 128, dtype),
             cost.ssd_bwd_cost(16, 256, 48, 64, 128, dtype)]
    for nbytes, ops in cases:
        assert cs.bound(nbytes, ops, cs.peak_rate(dtype)) == \
            _literal_bound(nbytes, ops, bf16)
    assert cs.bound(12 * 2 ** 23, 2 ** 23) == _literal_bound(
        12 * 2 ** 23, 2 ** 23, False)
    if bf16:   # PERF.md's kernel table: qwen3's B4 and its backward
        assert [round(cs.bound(*cases[i], cs.peak_rate(dtype))[0], 4)
                for i in (0, 3)] == [0.0174, 0.1738]
