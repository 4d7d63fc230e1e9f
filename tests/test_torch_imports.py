"""Import hygiene of the port: ``repro_torch`` (every subpackage, walked
recursively: core, kernels, models, moe, analysis, configs, runtime,
launch, ...),
``chip_smoke.py`` and the tools that drive the port on the card
(``tools/profile_torch_path.py``, ``tools/compare_lm_kernels.py``,
``tools/compare_relax_kernels.py``, ``tools/compare_fused_runs.py``,
``tools/compare_batch_runs.py``, ``tools/fused_column_profile.py``,
``tools/profile_moe_path.py``, ``tools/compare_train_steps.py``) and
the ranks of the sharded CPU tests (``tests/torch_shard_ranks.py``)
import neither JAX,
``ml_dtypes`` nor the reference package ``repro`` (``repro_torch`` is the
port itself), and every port module imports with JAX unavailable."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")

FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
    ROOT / "tools" / name for name in ("profile_torch_path.py",
                                       "compare_lm_kernels.py",
                                       "compare_relax_kernels.py",
                                       "compare_fused_runs.py",
                                       "compare_batch_runs.py",
                                       "fused_column_profile.py",
                                       "profile_moe_path.py",
                                       "compare_train_steps.py")] + [
    ROOT / "tests" / "torch_shard_ranks.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in _imported_modules(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "for want in ('kernels.relax', 'kernels.flash_attention',\n"
        "             'kernels.ssd_chunk', 'kernels.fused', 'core.fused',\n"
        "             'core.costmodel', 'core.priority', 'core.shard',\n"
        "             'core.dist', 'analysis', 'analysis.__main__',\n"
        "             'analysis.contracts', 'analysis.capabilities',\n"
        "             'analysis.smem', 'analysis.schedules',\n"
        "             'analysis.retrace', 'moe', 'moe.balancing',\n"
        "             'models.moe', 'models.model', 'configs.qwen3_0_6b',\n"
        "             'runtime.serve', 'launch.serve'):\n"
        "    assert 'repro_torch.' + want in names, names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 40


def test_chip_smoke_fails_without_the_repository(tmp_path):
    """Alone in a directory, the script exits non-zero and prints no
    result."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_chip_smoke_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("mangled,name", [
    # the file-unique namespace prefix ends in digits that pass for a
    # length prefix taking in the real name
    ("_ZN49_GLOBAL__N__e75102249_18_flash_attention_cu_c45a2b1816"
     "flash_f32_kernelILi128EEEvPKfS2_S2_Pfiiiiif", "flash_f32_kernel<128>"),
    ("_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_c45a2b1817"
     "flash_bf16_kernelILi64EEEvPK13__nv_bfloat16S3_S3_PS1_iiiiif",
     "flash_bf16_kernel<64>"),
    ("_ZN45_GLOBAL__N__189746bc_12_ssd_chunk_cu_fe19706a15ssd_bf16_kernelEP"
     "K13__nv_bfloat16PKfS2_S2_PfS5_iiiii", "ssd_bf16_kernel"),
    ("_ZN12_GLOBAL__N_121wd_relax_lanes_kernelILi2ELi1EEEvPKiiS2_S2_",
     "wd_relax_lanes_kernel<2,1>"),
    # B4's bf16 backward kernels, as nvcc names them
    ("_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_c45a2b1826"
     "flash_bwd_dkdv_bf16_kernelILi192ELi128EEEvPK13__nv_bfloat16S3_S3_S3_"
     "PKfS5_PS1_S6_iiiiif", "flash_bwd_dkdv_bf16_kernel<192,128>"),
    ("_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_c45a2b1824"
     "flash_bwd_dq_bf16_kernelILi128ELi128EEEvPK13__nv_bfloat16S3_S3_S3_"
     "PKfS5_PS1_iiiiif", "flash_bwd_dq_bf16_kernel<128,128>"),
    ("_Z3foov", None),
])
def test_chip_smoke_reads_kernel_names_from_mangled_symbols(mangled, name):
    """``chip_smoke.py`` keys its registers, spills and SASS counts by the
    kernel names it reads from nvcc's mangled symbols."""
    assert _chip_smoke().kernel_name(mangled) == name


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
def test_chip_smoke_names_the_backward_kernels_of_each_dtype(dtype_name):
    """The registers and spills a ``train_kernel_case`` line carries are
    those of the dK/dV and dQ kernels its dtype launches, keyed as
    ``ptxas_summary`` keys nvcc's ``-Xptxas -v`` lines."""
    cs = _chip_smoke()
    tail = "EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_iiiiif"
    symbols = {
        "bfloat16": ("26flash_bwd_dkdv_bf16_kernelILi64ELi64" + tail,
                     "24flash_bwd_dq_bf16_kernelILi64ELi64" + tail),
        "float32": ("21flash_bwd_dkdv_kernelIfLi64ELi64" + tail,
                    "19flash_bwd_dq_kernelIfLi64ELi64" + tail)}[dtype_name]
    log = "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{sym}'"
        f"\nptxas info    : Function properties for x\n    0 bytes stack "
        f"frame, {8 * i} bytes spill stores, 0 bytes spill loads\nptxas "
        f"info    : Used {200 + i} registers\n"
        for i, sym in enumerate(symbols))
    summary = cs.ptxas_summary([log])
    names = cs.bwd_attn_kernels(dtype_name, 64, 64)
    assert [summary[n] for n in names] == [
        {"registers": 200, "spill_bytes": 0},
        {"registers": 201, "spill_bytes": 8}]
