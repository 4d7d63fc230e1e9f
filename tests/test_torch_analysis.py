"""The port's static-analysis passes (``repro_torch.analysis``) on the CPU.

Each fixture of ``tests/test_analysis.py`` that has a counterpart in the
port: every pass flags its known-bad fixture with the right rule id and
line, suppressions work at line and file scope, ``REPRO_CHECK_CONTRACTS``
makes registration a gate, and the live ``src/repro_torch`` tree is
finding-free.  The contract pass is held to ``repro.analysis.contracts``:
for the built-in operators and each broken fixture built in both
packages, the same rules fire with the same first counterexample.
"""

import json
import re
import textwrap

import jax.numpy as jnp
import pytest
import torch

from repro.analysis import contracts as j_contracts
from repro.core import operators as jops
from repro_torch.analysis import PASSES, apply_suppressions, get_pass
from repro_torch.analysis import capabilities as cap_pass
from repro_torch.analysis import contracts, retrace, smem
from repro_torch.analysis import schedules as sched_pass
from repro_torch.analysis.__main__ import default_root
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.findings import Finding, parse_suppressions
from repro_torch.configs import ARCHITECTURES
from repro_torch.core import operators
from repro_torch.core.graph import INF
from repro_torch.core.operators import EdgeOp
from repro_torch.core.strategies import (FRONTIER_INIT, PRIORITY_SCHEDULE,
                                         SHARDABLE, EdgeBased, StrategyBase)

SRC_ROOT = default_root()


def _lint(tmp_path, source: str, name="fixture.py"):
    """Write a dedented snippet and run the retrace pass over it."""
    f = tmp_path / name
    f.write_text(textwrap.dedent(source), encoding="utf-8")
    return f, retrace.check_file(str(f))


def _line_of(source: str, needle: str) -> int:
    for i, line in enumerate(textwrap.dedent(source).splitlines(), 1):
        if needle in line:
            return i
    raise AssertionError(f"{needle!r} not in fixture")


# ---------------------------------------------------------------------------
# retrace pass (RT000–RT004) over torch.compile / torch.jit.script
# ---------------------------------------------------------------------------

RT001_FIXTURE = """\
    import torch
    from functools import partial

    @partial(torch.compile, dynamic=False)
    def kernel(x, n, *, cap):
        if n > 0:
            x = x + 1
        return x
"""


def test_rt001_control_flow_on_a_parameter(tmp_path):
    _, findings = _lint(tmp_path, RT001_FIXTURE)
    assert [f.rule for f in findings] == ["RT001"]
    f = findings[0]
    assert f.line == _line_of(RT001_FIXTURE, "if n > 0")
    assert "'n'" in f.message and "kernel" in f.message
    assert f.severity == "error"


@pytest.mark.parametrize("decorator", [
    "@torch.compile", "@torch.compile(mode='reduce-overhead')",
    "@functools.partial(torch.compile, fullgraph=True)"])
def test_rt001_every_compile_spelling(tmp_path, decorator):
    src = f"""\
        import functools, torch

        {decorator}
        def step(x, steps):
            for _ in range(steps):
                x = x + 1
            return x
    """
    _, findings = _lint(tmp_path, src)
    assert [f.rule for f in findings] == ["RT001"]
    assert findings[0].line == _line_of(src, "for _ in range")


def test_rt001_is_none_branch_is_one_guard(tmp_path):
    _, findings = _lint(tmp_path, """\
        import torch

        @torch.compile
        def kernel(x, wt):
            y = x if wt is None else x * wt
            if wt is not None:
                y = y + 1
            return y
    """)
    assert findings == []


def test_rt001_does_not_apply_to_jit_script(tmp_path):
    # TorchScript compiles control flow into its graph
    _, findings = _lint(tmp_path, """\
        import torch

        @torch.jit.script
        def kernel(x, n: int):
            if n > 0:
                x = x + 1
            return x
    """)
    assert findings == []


def test_rt002_mutable_default(tmp_path):
    src = """\
        import torch

        @torch.compile
        def kernel(x, opts=[1, 2]):
            return x
    """
    _, findings = _lint(tmp_path, src)
    assert [f.rule for f in findings] == ["RT002"]
    assert findings[0].line == _line_of(src, "opts=[1, 2]")


def test_rt003_module_tensor_closure(tmp_path):
    src = """\
        import torch

        TABLE = torch.arange(128)

        @torch.jit.script
        def kernel(x):
            return x + TABLE[0]
    """
    _, findings = _lint(tmp_path, src)
    assert [f.rule for f in findings] == ["RT003"]
    assert findings[0].line == _line_of(src, "x + TABLE")
    assert "TABLE" in findings[0].message


def test_rt004_impure_call_in_compiled_code(tmp_path):
    src = """\
        import time, torch

        @torch.compile
        def kernel(x):
            def inner(y):
                return y + time.time()
            return inner(x)
    """
    _, findings = _lint(tmp_path, src)
    assert [f.rule for f in findings] == ["RT004"]
    assert findings[0].line == _line_of(src, "time.time()")


def test_rt000_syntax_error(tmp_path):
    _, findings = _lint(tmp_path, "def broken(:\n")
    assert [f.rule for f in findings] == ["RT000"]


def test_retrace_ignores_eager_functions(tmp_path):
    _, findings = _lint(tmp_path, """\
        import time

        def host_loop(x, n):
            if n > 0:          # eager: branching is fine
                x = x + 1
            return x, time.time()
    """)
    assert findings == []


# ---------------------------------------------------------------------------
# contracts pass (CT001–CT006), and parity with the reference's
# ---------------------------------------------------------------------------

def _op(**kw):
    base = dict(name="t", combine="min", identity=INF, source_value=0,
                message=lambda v, w: v + w)
    base.update(kw)
    return EdgeOp(**base)


class _LyingT(EdgeOp):
    @property
    def idempotent(self):
        return True


class _LyingJ(jops.EdgeOp):
    @property
    def idempotent(self):
        return True


#: broken operators built in both packages: name -> (port op, reference
#: op, the rule it must break)
BROKEN = {
    "wrong_identity": (_op(identity=7), jops.EdgeOp(
        name="t", combine="min", identity=7, source_value=0,
        message=lambda v, w: v + w), "CT001"),
    "strict_gate": (_op(update=lambda c, cur: c < cur - 1), jops.EdgeOp(
        name="t", combine="min", identity=jops.INF, source_value=0,
        message=lambda v, w: v + w, update=lambda c, cur: c < cur - 1),
        "CT002"),
    "loose_gate": (_op(update=lambda c, cur: c <= cur), jops.EdgeOp(
        name="t", combine="min", identity=jops.INF, source_value=0,
        message=lambda v, w: v + w, update=lambda c, cur: c <= cur),
        "CT003"),
    "lying_idempotent": (
        _LyingT(name="t4", combine="add", identity=0, source_value=1,
                message=lambda v, w: v),
        _LyingJ(name="t4", combine="add", identity=0, source_value=1,
                message=lambda v, w: v), "CT004"),
    "weight_additive_lie": (
        _op(message=lambda v, w: v, weight_additive=True),
        jops.EdgeOp(name="t", combine="min", identity=jops.INF,
                    source_value=0, message=lambda v, w: v,
                    weight_additive=True), "CT005"),
    "max_without_value_min": (
        EdgeOp(name="tmax", combine="max", identity=0, source_value=INF,
               message=lambda v, w: torch.minimum(v, w)),
        jops.EdgeOp(name="tmax", combine="max", identity=0,
                    source_value=jops.INF,
                    message=lambda v, w: jnp.minimum(v, w)), "CT001"),
}


def _by_rule(findings):
    return {f.rule: f.message for f in findings}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_contracts_match_reference_on_broken_operators(name):
    top, jop, rule = BROKEN[name]
    got, want = _by_rule(contracts.check_operator(top)), _by_rule(
        j_contracts.check_operator(jop))
    assert rule in got
    assert sorted(got) == sorted(want)
    for r in got:      # the same first counterexample
        assert (re.findall(r"-?\d+", got[r].split(" — ")[0])
                == re.findall(r"-?\d+", want[r].split(" — ")[0])), r


@pytest.mark.parametrize("name", sorted(operators.OPERATORS))
def test_ct_builtins_are_law_abiding(name):
    """As the reference's built-ins are (tests/test_analysis.py)."""
    assert contracts.check_operator(operators.OPERATORS[name]) == []


def test_ct006_dtype_widening_message():
    findings = contracts.check_operator(_op(message=lambda v, w: v + 0.5))
    assert "CT006" in {f.rule for f in findings}
    ct006 = next(f for f in findings if f.rule == "CT006")
    assert "float32" in ct006.message
    assert ct006.file.endswith("test_torch_analysis.py")


def test_value_min_restricts_domain():
    good = EdgeOp(name="tmax2", combine="max", identity=0, source_value=INF,
                  message=lambda v, w: torch.minimum(v, w), value_min=0)
    assert contracts.check_operator(good) == []


def test_register_time_contract_gate(monkeypatch):
    monkeypatch.setenv("REPRO_CHECK_CONTRACTS", "1")
    bad = EdgeOp(name="t_reject", combine="max", identity=7,
                 source_value=0, message=lambda v, w: v)
    with pytest.raises(ValueError, match="CT001"):
        operators.register_operator(bad)
    assert "t_reject" not in operators.OPERATORS
    good = _op(name="t_accept")
    try:
        operators.register_operator(good)
        assert "t_accept" in operators.OPERATORS
    finally:
        operators.OPERATORS.pop("t_accept", None)


def test_register_knob_off_by_default(monkeypatch):
    monkeypatch.delenv("REPRO_CHECK_CONTRACTS", raising=False)
    bad = EdgeOp(name="t_unchecked", combine="max", identity=7,
                 source_value=0, message=lambda v, w: v)
    try:
        operators.register_operator(bad)   # no gate without the knob
        assert "t_unchecked" in operators.OPERATORS
    finally:
        operators.OPERATORS.pop("t_unchecked", None)


# ---------------------------------------------------------------------------
# capabilities pass (CP001–CP003)
# ---------------------------------------------------------------------------

def test_cp001_shardable_without_a_sharded_step():
    # no fused kernel, so no sharded step can exist
    class Phantom(StrategyBase):
        name = "phantom"
        capabilities = frozenset({SHARDABLE, FRONTIER_INIT})

        def iterate(self, state, dist, updated_mask, count, **kw):
            return dist, updated_mask, None

    findings = cap_pass.check_strategy("phantom", Phantom)
    assert [f.rule for f in findings] == ["CP001"]
    assert "SHARDABLE" in findings[0].message
    assert findings[0].file.endswith("test_torch_analysis.py")


def test_cp001_priority_schedule_on_an_edge_worklist():
    class EdgeDelta(EdgeBased):
        capabilities = frozenset({PRIORITY_SCHEDULE})

    findings = cap_pass.check_strategy("edge_delta", EdgeDelta)
    assert [f.rule for f in findings] == ["CP001"]
    assert "PRIORITY_SCHEDULE" in findings[0].message


def test_cp001_frontier_init_without_iterate():
    class NoIterate(StrategyBase):
        name = "noiterate"
        capabilities = frozenset({FRONTIER_INIT})

    findings = cap_pass.check_strategy("noiterate", NoIterate)
    assert [f.rule for f in findings] == ["CP001"]
    assert "FRONTIER_INIT" in findings[0].message


def test_cp003_unknown_flag():
    class Unknown(StrategyBase):
        name = "unknown"
        capabilities = frozenset({"warp_speed"})

    findings = cap_pass.check_strategy("unknown", Unknown)
    assert [f.rule for f in findings] == ["CP003"]
    assert "warp_speed" in findings[0].message


def test_cp002_undeclared_gate(tmp_path):
    f = tmp_path / "gate.py"
    f.write_text(textwrap.dedent("""\
        def gate(strategy):
            if "warp_speed" in strategy.capabilities:
                return True
            return PALLAS_BACKEND not in strategy_capabilities("WD")
    """), encoding="utf-8")
    findings = cap_pass.check_file(f)
    assert [(x.rule, x.line) for x in findings] == [("CP002", 2),
                                                    ("CP002", 4)]
    assert "PALLAS_BACKEND" in findings[1].message


def test_cp002_known_constant_gates_are_clean(tmp_path):
    f = tmp_path / "gate.py"
    f.write_text(textwrap.dedent("""\
        from repro_torch.core.strategies import SHARDABLE

        def gate(strategy, flag):
            return (SHARDABLE in strategy.capabilities
                    and flag in strategy.capabilities)
    """), encoding="utf-8")
    assert cap_pass.check_file(f) == []


def test_cp_registry_is_clean():
    assert cap_pass.check_registry() == []


# ---------------------------------------------------------------------------
# smem pass (SM001–SM002)
# ---------------------------------------------------------------------------

def test_smem_suite_shapes_fit():
    assert smem.run([]) == []


def test_smem_covers_the_moe_and_mixer_configs():
    shapes = {(arch, kernel, dtype): arg
              for arch, kernel, dtype, arg in smem.lm_shapes()}
    assert shapes[("granite_moe_3b_a800m", "flash_attention",
                   "bfloat16")] == (64, 64)
    assert shapes[("jamba_1_5_large_398b", "ssd_chunk_dual",
                   "bfloat16")] == (8, 256, 256, 64, 16)
    assert shapes[("mamba2_780m", "ssd_chunk_dual",
                   "float32")] == (8, 256, 48, 64, 128)
    # MLA's prefill: q/k head dim nope + rope, v head dim v
    assert shapes[("deepseek_v3_671b", "flash_attention",
                   "float32")] == (192, 128)
    assert shapes[("llama_3_2_vision_11b", "flash_attention",
                   "bfloat16")] == (128, 128)
    assert {arch for arch, *_ in shapes} == set(ARCHITECTURES)


def test_smem_model_of_each_kernel():
    """The footprints, worked by hand from the sources: B1's WdSmem (4
    tables of 2,048 slots and two bounds), B3's staged slice, B4's tiles
    ((64 + 4·64) rows of hd + 8 bf16 in two stages; f32 two 64-row tiles
    of hd + 4 and the P tile), B5's bf16 layout at mamba2_780m's shape."""
    assert smem.footprint("relax_lanes").smem == 0
    assert smem.footprint("wd_relax_lanes").static_smem == 32776
    assert smem.footprint("wd_relax_union").static_smem == 32776
    assert smem.footprint("find_offsets").static_smem == 16392
    assert smem.footprint("fused_fixed_point").min_blocks == 3
    assert smem.footprint("fused_delta").min_blocks == 2
    b4 = smem.footprint("flash_attention", dtype="bfloat16", hd=64)
    assert (b4.threads, b4.static_smem, b4.dynamic_smem) == (128, 0, 46080)
    f4 = smem.footprint("flash_attention", dtype="float32", hd=128)
    assert (f4.threads, f4.dynamic_smem) == (256, (2 * 64 * 132 + 64 * 68)
                                             * 4)
    # MLA's 192/128: Q and two K stages of 192 + 8, two V stages of 128 +
    # 8 (bf16, two blocks a SM); f32 Q and K of 192 + 4 and P, 115 KB,
    # where two blocks do not fit an SM and the launch bound asks one
    m4 = smem.footprint("flash_attention", dtype="bfloat16", hd=192,
                        hd_v=128)
    assert (m4.dynamic_smem, m4.min_blocks) == (
        ((64 + 2 * 64) * 200 + 2 * 64 * 136) * 2, 2)
    m4 = smem.footprint("flash_attention", dtype="float32", hd=192,
                        hd_v=128)
    assert (m4.dynamic_smem, m4.min_blocks) == (
        (2 * 64 * 196 + 64 * 68) * 4, 1)
    b5 = smem.footprint("ssd_chunk_dual", dtype="bfloat16",
                        shape=(8, 256, 48, 64, 128))
    hg = smem.ssd_heads_per_block(8, 256, 48, 128)
    assert (b5.threads, b5.dynamic_smem) == (
        128, 64 * 264 * 4 + hg * 256 * 4 + 2 * 64 * 136 * 2)


@pytest.mark.parametrize("hd,hd_v", [(32, 32), (64, 64), (128, 128),
                                     (48, 32), (192, 128)])
def test_smem_model_of_the_bf16_backward_kernels(hd, hd_v):
    """B4's bf16 backward blocks, worked by hand from the sources: four
    warps; dK/dV stages its 64 keys' K and V rows and two stages of QT
    query rows of Q and dO (bf16 rows padded by 8) and of lse and D (f32),
    QT 64, or 32 at q/k head dim 192; dQ two stages of 64 K and V rows
    and its 64 packed rows of dO.
    Every instance fits two blocks a SM.  The float32 blocks keep their
    256 threads, f32 tiles and one block a SM."""
    qt = 32 if hd > 128 else 64
    row = (hd + 8) + (hd_v + 8)
    kv = smem.footprint("flash_attention_bwd_dkdv", dtype="bfloat16", hd=hd,
                        hd_v=hd_v)
    assert (kv.threads, kv.static_smem, kv.dynamic_smem, kv.min_blocks) == (
        128, 0, (64 + 2 * qt) * row * 2 + 2 * 2 * qt * 4, 2)
    dq = smem.footprint("flash_attention_bwd_dq", dtype="bfloat16", hd=hd,
                        hd_v=hd_v)
    assert (dq.threads, dq.static_smem, dq.dynamic_smem, dq.min_blocks) == (
        128, 0, (2 * 64 * row + 64 * (hd_v + 8)) * 2, 2)
    for kernel, tiles in (("flash_attention_bwd_dkdv", 2),
                          ("flash_attention_bwd_dq", 1)):
        f32 = smem.footprint(kernel, dtype="float32", hd=hd, hd_v=hd_v)
        assert (f32.threads, f32.dynamic_smem, f32.min_blocks) == (
            256, (2 * 64 * (hd + 4) + 2 * 64 * (hd_v + 4) + tiles * 64 * 68
                  + 2 * 64) * 4, 1)
    if (hd, hd_v) == (128, 128):
        assert (kv.dynamic_smem, dq.dynamic_smem) == (105472, 87040)


def test_sm001_block_over_budget():
    fp = smem.footprint("flash_attention", dtype="bfloat16", hd=128)
    findings = smem.check_footprint(fp, shape_name="tiny",
                                    smem_per_block=64 << 10)
    assert [f.rule for f in findings] == ["SM001"]
    assert "tiny" in findings[0].message
    assert findings[0].file.endswith("flash_attention.cu")
    assert findings[0].line > 0
    # two 87 KB blocks a SM do not fit a 160 KB SM
    findings = smem.check_footprint(fp, smem_per_sm=160 << 10)
    assert [f.rule for f in findings] == ["SM001"]
    assert "launch bound" in findings[0].message


def test_sm002_misaligned_block_size(tmp_path):
    for name in ("relax_lanes.cuh", "relax.cu", "fused.cu",
                 "flash_attention.cu", "ssd_chunk.cu"):
        text = (smem.CSRC / name).read_text(encoding="utf-8")
        if name == "flash_attention.cu":
            assert "constexpr int TC_KEYS = 64;" in text
            text = text.replace("constexpr int TC_KEYS = 64;",
                                "constexpr int TC_KEYS = 48;")
        (tmp_path / name).write_text(text, encoding="utf-8")
    findings = smem.check_alignment(tmp_path)
    assert [f.rule for f in findings] == ["SM002"]
    assert "TC_KEYS=48" in findings[0].message
    assert findings[0].file.endswith("flash_attention.cu")
    assert findings[0].line == smem.constants("flash")["TC_KEYS"][2]
    assert smem.check_alignment() == []


# ---------------------------------------------------------------------------
# schedules pass (SC001–SC003)
# ---------------------------------------------------------------------------

def test_sc002_typo_field_flagged_with_line():
    src = textwrap.dedent("""\
        def lower(sched):
            cap = sched.min_bucket
            return sched.dleta          # typo'd delta
    """)
    findings, fields_read = sched_pass.scan_file("fixture.py", text=src)
    assert [f.rule for f in findings] == ["SC002"]
    assert findings[0].line == 3
    assert "dleta" in findings[0].message
    assert fields_read == {"min_bucket"}


def test_sc002_allows_methods_and_module_access():
    src = textwrap.dedent("""\
        from repro_torch.core import schedule

        def lower(work_schedule, degrees):
            base = schedule.DEFAULT_SCHEDULE
            resolved = work_schedule.resolved(degrees)
            return resolved.to_json(), work_schedule.tile
    """)
    findings, _ = sched_pass.scan_file("fixture.py", text=src)
    assert findings == []


def test_sc001_dead_field_detection_skips_carried_fields():
    from repro_torch.core.schedule import CARRIED_FIELDS, SCHEDULE_FIELDS
    partial = set(SCHEDULE_FIELDS) - {"delta"} - set(CARRIED_FIELDS)
    findings = sched_pass.check_dead_fields(partial)
    assert [f.rule for f in findings] == ["SC001"]
    assert "'delta'" in findings[0].message
    assert not any(f"'{c}'" in findings[0].message for c in CARRIED_FIELDS)
    assert sched_pass.check_dead_fields(partial | {"delta"}) == []


def test_sc003_schedule_round_trips():
    """The registry's default schedules survive to_json/from_json and
    to_dict/from_dict; a schedule that does not is reported."""
    import dataclasses
    from repro_torch.core.schedule import SCHEDULE_DEFAULTS, Schedule
    assert sched_pass.check_roundtrips() == []
    sched = Schedule(mdt=7, delta=3, imbalance_threshold=2.5)
    assert Schedule.from_json(sched.to_json()) == sched
    assert Schedule.from_dict(sched.to_dict()) == sched

    @dataclasses.dataclass(frozen=True)
    class Lossy(Schedule):
        def to_json(self):
            return Schedule(mdt=1).to_json()

    SCHEDULE_DEFAULTS["WD"] = Lossy()
    try:
        findings = sched_pass.check_roundtrips()
    finally:
        del SCHEDULE_DEFAULTS["WD"]
    assert {f.rule for f in findings} == {"SC003"}
    assert all("'WD'" in f.message for f in findings)
    assert any("to_json/from_json is lossy" in f.message for f in findings)


# ---------------------------------------------------------------------------
# suppressions, reporters, the CLI, the registry
# ---------------------------------------------------------------------------

def test_parse_suppressions_line_and_file():
    sup = parse_suppressions(textwrap.dedent("""\
        # repro: disable=CT001
        x = 1
        y = 2  # repro: disable=RT001,RT003
    """))
    assert sup.file_rules == {"CT001"}
    assert sup.line_rules == {3: frozenset({"RT001", "RT003"})}


def test_line_and_file_suppressions(tmp_path):
    src = RT001_FIXTURE.replace("if n > 0:",
                                "if n > 0:  # repro: disable=RT001")
    _, findings = _lint(tmp_path, src)
    assert [x.rule for x in findings] == ["RT001"]   # the pass reports
    assert apply_suppressions(findings) == ([], 1)
    src = "# repro: disable=RT004\n" + textwrap.dedent(RT001_FIXTURE)
    _, findings = _lint(tmp_path, src, "other.py")
    kept, suppressed = apply_suppressions(findings)
    assert [x.rule for x in kept] == ["RT001"] and suppressed == 0


def test_cli_exit_codes_and_json(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(RT001_FIXTURE), encoding="utf-8")
    out_json = tmp_path / "report.json"
    rc = cli_main([str(bad), "--passes=retrace", "--format=json",
                   "--output", str(out_json)])
    assert rc == 1
    report = json.loads(out_json.read_text(encoding="utf-8"))
    assert report["total"] == 1 and report["counts"] == {"RT001": 1}
    assert report["findings"][0]["rule"] == "RT001"
    assert json.loads(capsys.readouterr().out)["counts"] == report["counts"]
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n", encoding="utf-8")
    assert cli_main([str(clean), "--passes=retrace"]) == 0
    suppressed = tmp_path / "suppressed.py"
    suppressed.write_text("# repro: disable=RT001\n"
                          + textwrap.dedent(RT001_FIXTURE), encoding="utf-8")
    assert cli_main([str(suppressed), "--passes=retrace"]) == 0
    assert cli_main([str(suppressed), "--passes=retrace",
                     "--no-suppress"]) == 1


def test_finding_rejects_bad_severity():
    with pytest.raises(ValueError):
        Finding(rule="X", message="m", file="f", line=1, severity="fatal")


def test_pass_registry_exposes_rules():
    assert list(PASSES) == ["retrace", "contracts", "capabilities", "smem",
                            "schedules"]
    for name in PASSES:
        mod = get_pass(name)
        assert mod.PASS_NAME == name and mod.RULES
    with pytest.raises(KeyError):
        get_pass("vmem")


def test_live_tree_is_finding_free(capsys):
    """``python -m repro_torch.analysis src/repro_torch``: exit 0, no
    finding, nothing suppressed."""
    rc = cli_main([str(SRC_ROOT), "--format=json"])
    report = json.loads(capsys.readouterr().out)
    assert (rc, report["total"], report["suppressed"]) == (0, 0, 0), \
        report["findings"]
    assert report["passes"] == list(PASSES)
