"""Shared-memory and block-size budget checker (rules SM001–SM002), the
port's counterpart of :mod:`repro.analysis.vmem`.

The reference's Pallas kernels keep whole tables resident in TPU VMEM, so
its pass sums the resident blocks of a graph against a 16 MiB budget.  The
port's CUDA kernels keep no graph-sized table on chip: a block stages a
bounded slice in shared memory (B1 at most ``B1_SLOTS`` slots of the
frontier's prefix, B3 ``B3_SLOTS`` items, B4 a 64-row Q tile and two
stages of K and V tiles, at each (q/k, v) head-dim pair, and its bf16
backward a key tile's K and V beside two stages of query rows (dK/dV) or
two stages of K and V (dQ), B5 64-row strips).  What can overrun is a block's
shared memory, and the launch bounds' promise of blocks resident on an
SM.  This pass evaluates a declarative footprint model of each kernel's
block: threads, static shared memory, and the dynamic shared memory its
launcher requests as a function of the shape, written from the sources
in ``kernels/csrc`` and computed from the constants parsed out of them.
``chip_smoke.py`` holds the model equal to what the card reports for
every kernel (:func:`repro_torch.core.costmodel.block_feasibility`).

* **SM001 — block over budget**: at a reference shape, a block's static
  plus dynamic shared memory exceeds ``SMEM_PER_BLOCK``; or the blocks
  its ``__launch_bounds__`` promise a SM do not fit the SM's shared
  memory (``SMEM_PER_SM``, with the 1 KB each resident block reserves),
  or its threads (``REGISTERS_PER_SM`` / 32 = 2,048 threads an SM).
* **SM002 — misaligned block size**: a block-size constant that is not a
  multiple of the warp width (32), so the last warp of a block (or of a
  tile's pass) runs partly idle.  This is VM002's lane width on Hopper.

Reference shapes: every graph of :data:`repro_torch.data.graphs.GRAPH_SUITE`
for the graph kernels (B1/B2/B3, B1's batch contract, the fused kernels;
their blocks do not grow with the graph, the pass holds them at each graph
all the same), and, for B4 and B5, every configuration at a 2048-token
prefill, in bfloat16 (serving) and float32 (the CPU comparisons).  It runs on the CPU, without a card.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import re
from pathlib import Path
from typing import Optional

from repro_torch.analysis.findings import Finding

PASS_NAME = "smem"
RULES = ("SM001", "SM002")

#: warp width: every block-size constant is a multiple of it
WARP = 32
#: shared memory the runtime reserves a resident block (Hopper)
RESERVED_PER_BLOCK = 1024
#: threads resident on an SM: REGISTERS_PER_SM / 32
THREADS_PER_SM = 2048
#: the prefill length of the reference shapes of B4 and B5
PREFILL = 2048

CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"

#: translation units: the files whose top-level constants a kernel sees
UNITS = {"relax": ("relax_lanes.cuh", "relax.cu"),
         "fused": ("relax_lanes.cuh", "fused.cu"),
         "flash": ("flash_attention.cu",),
         "ssd": ("ssd_chunk.cu",)}

#: block-size constants of each unit (SM002)
BLOCK_CONSTANTS = {
    "relax": ("THREADS", "B1_TILE", "B1_SLOTS", "B2_TILE", "UB_TILE",
              "B3_TILE", "B3_SLOTS"),
    "fused": ("THREADS", "TAIL_MAX"),
    "flash": ("THREADS", "TC_THREADS", "BQ", "BK", "TC_ROWS", "TC_KEYS",
              "TC_BWD_KEYS", "TC_BWD_WIDE"),
    "ssd": ("THREADS", "TC_THREADS", "TILE"),
}

_CONST_RE = re.compile(r"^constexpr int (\w+) = ([^;]+);", re.M)


def _eval(expr: str, env: dict) -> int:
    """A constant expression of ints, names and + - * / (C's integer
    division)."""
    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.Name):
            return env[node.id][0]
        if isinstance(node, ast.BinOp):
            a, b = ev(node.left), ev(node.right)
            if isinstance(node.op, ast.Add):
                return a + b
            if isinstance(node.op, ast.Sub):
                return a - b
            if isinstance(node.op, ast.Mult):
                return a * b
            if isinstance(node.op, (ast.Div, ast.FloorDiv)):
                return a // b
        raise ValueError(f"not a constant expression: {expr!r}")
    return ev(ast.parse(expr.strip(), mode="eval"))


@functools.lru_cache(maxsize=None)
def constants(unit: str, csrc: Path = CSRC) -> dict:
    """``name -> (value, file, line)`` of the top-level ``constexpr int``
    constants of one translation unit, in include order."""
    env: dict = {}
    for name in UNITS[unit]:
        path = csrc / name
        text = path.read_text(encoding="utf-8")
        for m in _CONST_RE.finditer(text):
            line = text.count("\n", 0, m.start()) + 1
            env[m.group(1)] = (_eval(m.group(2), env), str(path), line)
    return env


@dataclasses.dataclass(frozen=True)
class Footprint:
    """One kernel's block at one shape."""
    kernel: str
    threads: int
    static_smem: int
    dynamic_smem: int
    #: blocks a SM its ``__launch_bounds__`` promise
    min_blocks: int
    file: str
    line: int

    @property
    def smem(self) -> int:
        return self.static_smem + self.dynamic_smem


def _c(unit: str) -> dict:
    return {k: v[0] for k, v in constants(unit).items()}


def _wd_smem(c: dict) -> int:
    """``WdSmem`` (relax_lanes.cuh:195): prefix, exclusive, start and src
    of ``B1_SLOTS`` slots, and two bounds."""
    return 4 * 4 * c["B1_SLOTS"] + 2 * 4


def _fused_static(c: dict, delta: bool) -> int:
    """The fused kernels' static shared memory: ``WdSmem`` (fused.cu:1151,
    :1878), and the ``__shared__`` arrays of the device functions each one
    reaches: ``block_reduce3``'s 3 x WARPS (fused.cu:449) and
    ``block_scan2``'s 2 x WARPS words (:477); the BSP kernel's
    ``frontier_compact`` histogram (32 words, :588); the delta kernel's
    ``list_compact`` histogram (:1426) and the 32 bins of ``epoch_stage``,
    ``ns_widen`` and ``filter_stage`` (:1545, :1645, :1714), and its tally
    of 4 long longs (:1919)."""
    words = 3 * c["WARPS"] + 2 * c["WARPS"] + 32
    if delta:
        words += 3 * 32 + 2 * 4
    return _wd_smem(c) + 4 * words


def _flash(dtype: str, hd: int, hd_v: int) -> tuple:
    """(threads, dynamic bytes, blocks a SM its launch bound asks) of B4's
    kernel at q/k head dim ``hd`` and v head dim ``hd_v``: f32
    ``smem_bytes`` (flash_attention.cu), bf16 ``tc_smem_bytes``, as its
    launchers ``launch_f32`` and ``launch_bf16`` request them, and
    ``min_blocks``: two where two blocks fit an SM, else one."""
    c = _c("flash")
    if dtype == "float32":
        threads = c["THREADS"]
        dyn = (c["BQ"] * (hd + 4) + c["BK"] * (max(hd, hd_v) + 4)
               + c["BQ"] * c["LDP"]) * 4
    else:
        threads = c["TC_THREADS"]
        dyn = ((c["TC_ROWS"] + 2 * c["TC_KEYS"]) * (hd + 8)
               + 2 * c["TC_KEYS"] * (hd_v + 8)) * 2
    fits_two = 2 * (dyn + c["SMEM_RESERVED"]) <= c["SMEM_PER_SM"]
    return threads, dyn, 2 if fits_two else 1


def _flash_bwd(kernel: str, dtype: str, hd: int, hd_v: int) -> tuple:
    """(threads, dynamic bytes, blocks a SM) of B4's backward kernels in
    flash_attention.cu.  float32 (CUDA cores, f32 tiles, launch bound one
    block): ``bwd_dkdv_smem_bytes`` (K, Q, V, dO, P^T and dS^T tiles, lse
    and D) and ``bwd_dq_smem_bytes`` (Q, K, dO, V, dS, lse and D).
    bfloat16 (tensor cores, four warps, bf16 rows padded by 8): dK/dV's
    ``tc_bwd_dkdv_smem_bytes`` (the key tile's K and V, two stages of
    ``tc_bwd_span`` query rows of Q and dO, two of lse and D, f32) and
    dQ's ``tc_bwd_dq_smem_bytes`` (two stages of K and V, and the block's
    ``TC_ROWS`` rows of dO); ``min_blocks`` as the forward's."""
    c = _c("flash")
    if dtype == "float32":
        tiles = 2 if kernel == "flash_attention_bwd_dkdv" else 1
        dyn = (2 * c["BK"] * (hd + 4) + 2 * c["BK"] * (hd_v + 4)
               + tiles * c["BQ"] * c["LDP"] + 2 * c["BQ"]) * 4
        return c["THREADS"], dyn, 1
    keys = c["TC_BWD_KEYS"]
    row = (hd + 8) + (hd_v + 8)              # a K and a V row, bf16
    if kernel == "flash_attention_bwd_dkdv":
        span = c["TC_BWD_WIDE"] if hd > 128 else keys
        dyn = (keys + 2 * span) * row * 2 + 2 * 2 * span * 4
    else:
        dyn = (2 * keys * row + c["TC_ROWS"] * (hd_v + 8)) * 2
    fits_two = 2 * (dyn + c["SMEM_RESERVED"]) <= c["SMEM_PER_SM"]
    return c["TC_THREADS"], dyn, 2 if fits_two else 1


def _ssd_bwd(P: int, N: int) -> int:
    """Dynamic bytes of B5's backward kernel (``bwd_smem_floats``,
    ssd_chunk.cu): the B and C tiles (N wide), the x̄ and dy tiles (P
    wide), dstate [N, P], the M tile, 16 rows of column partials and
    three 64-entry vectors."""
    c = _c("ssd")
    tile = c["TILE"]
    ldn = ((N + 3) & ~3) + 4
    ldp = ((P + 3) & ~3) + 4
    return (2 * tile * ldn + 2 * tile * ldp + N * ldp + tile * c["LDM"]
            + 16 * tile + 3 * tile) * 4


def ssd_heads_per_block(BN: int, c_len: int, H: int, N: int) -> int:
    """``heads_per_block`` (ssd_chunk.cu:534): heads a bf16 block takes."""
    c = _c("ssd")
    tile = c["TILE"]
    per_group = BN * ((c_len + tile - 1) // tile + (N + tile - 1) // tile)
    hg = 1
    while (hg < c["MAX_HG"] and hg < H
           and per_group * ((H + 2 * hg - 1) // (2 * hg))
           >= c["TARGET_BLOCKS"]):
        hg *= 2
    return hg


def _ssd(dtype: str, BN: int, c_len: int, H: int, P: int, N: int) -> tuple:
    """(threads, dynamic bytes) of B5's kernel: f32 ``smem_floats``
    (ssd_chunk.cu:83), bf16 ``TcLayout::bytes`` (:290), as its launchers
    request them (:521, :548)."""
    c = _c("ssd")
    tile = c["TILE"]
    if dtype == "float32":
        ldn = ((N + 3) & ~3) + 4
        floats = 2 * tile * ldn + tile * P + tile * c["LDM"] + 2 * tile
        return c["THREADS"], floats * 4
    cw = (c_len + 63) & ~63
    ldw = cw + 8
    ldn = ((N + 15) & ~15) + 8
    ldx = ((P + 15) & ~15) + 8
    u = 2 * tile * max(ldn, ldx)
    hg = ssd_heads_per_block(BN, c_len, H, N)
    return c["TC_THREADS"], tile * ldw * 4 + hg * cw * 4 + u * 2


#: graph kernel -> (unit, static bytes, launch bound's blocks a SM); B1
#: and the union kernel stage one ``WdSmem`` (relax.cu:167, :241), B3
#: ``B3_SLOTS`` words and two bounds (relax.cu:365-366)
_GRAPH_KERNELS = {
    "relax_lanes": ("relax", lambda c: 0, lambda c: 1),
    "wd_relax_lanes": ("relax", _wd_smem, lambda c: 1),
    "wd_relax_union": ("relax", _wd_smem, lambda c: 1),
    "find_offsets": ("relax", lambda c: 4 * c["B3_SLOTS"] + 2 * 4,
                     lambda c: 1),
    "fused_fixed_point": ("fused", lambda c: _fused_static(c, False),
                          lambda c: c["MIN_BLOCKS"]),
    "fused_delta": ("fused", lambda c: _fused_static(c, True),
                    lambda c: c["DELTA_MIN_BLOCKS"]),
}
GRAPH_KERNELS = tuple(_GRAPH_KERNELS)


def footprint(kernel: str, *, dtype: Optional[str] = None,
              hd: Optional[int] = None, hd_v: Optional[int] = None,
              shape: Optional[tuple] = None) -> Footprint:
    """The model of one kernel's block.  B4 (``flash_attention`` and its
    backward kernels ``flash_attention_bwd_dkdv``/``_dq``) takes
    ``dtype``, ``hd`` and ``hd_v`` (default ``hd``); B5
    (``ssd_chunk_dual``, ``ssd_chunk_dual_bwd``) ``dtype`` and ``shape`` =
    (BN, c, H, P, N); the graph kernels nothing."""
    if kernel in _GRAPH_KERNELS:
        unit, static, min_blocks = _GRAPH_KERNELS[kernel]
        env = constants(unit)
        c = {k: v[0] for k, v in env.items()}
        _, file, line = env["THREADS"]
        return Footprint(kernel, c["THREADS"], static(c), 0, min_blocks(c),
                         file, line)
    hd_v = hd if hd_v is None else hd_v
    if kernel == "flash_attention":
        threads, dyn, min_blocks = _flash(dtype, hd, hd_v)
        unit = "flash"
    elif kernel in ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq"):
        threads, dyn, min_blocks = _flash_bwd(kernel, dtype, hd, hd_v)
        unit = "flash"
    elif kernel == "ssd_chunk_dual":
        threads, dyn = _ssd(dtype, *shape)
        min_blocks = 2
        unit = "ssd"
    elif kernel == "ssd_chunk_dual_bwd":
        threads, dyn, min_blocks = _c("ssd")["THREADS"], _ssd_bwd(
            *shape[3:]), 1
        unit = "ssd"
    else:
        raise KeyError(f"no footprint model of kernel {kernel!r}")
    _, file, line = constants(unit)["THREADS"]
    return Footprint(kernel, threads, 0, dyn, min_blocks, file, line)


def row_footprint(row: dict) -> Footprint:
    """The model of a row of ``costmodel.block_feasibility``: its kernel
    at the row's dtype and head dims or shape."""
    kernel = row["kernel"]
    if kernel.startswith("flash_attention"):
        return footprint(kernel, dtype=row["dtype"], hd=row["hd"],
                         hd_v=row["hd_v"])
    if kernel.startswith("ssd_chunk_dual"):
        return footprint(kernel, dtype=row["dtype"], shape=tuple(
            row[key] for key in ("BN", "c", "H", "P", "N")))
    return footprint(kernel)


# ---------------------------------------------------------------------------
# reference shapes
# ---------------------------------------------------------------------------

def graph_shapes() -> dict:
    """``name -> (n, e)`` upper bounds of the benchmark suite graphs (the
    reference's :func:`repro.analysis.vmem.reference_shapes`)."""
    from repro_torch.data.graphs import GRAPH_SUITE
    shapes = {}
    for name, spec in GRAPH_SUITE.items():
        if spec["kind"] == "road":
            n = int(spec["side"]) ** 2
            e = 4 * n
        else:
            n = 1 << int(spec["scale"])
            e = n * int(spec["edge_factor"])
        shapes[name] = (n, e)
    return shapes


#: B4's kernels (the forward and the two of its backward pass) and B5's
ATTENTION_KERNELS = ("flash_attention", "flash_attention_bwd_dkdv",
                     "flash_attention_bwd_dq")
SSD_KERNELS = ("ssd_chunk_dual", "ssd_chunk_dual_bwd")


def lm_shapes() -> list:
    """``(config, kernel, dtype, (hd, hd_v) or shape)`` of B4's and B5's
    kernels (forward and backward) for every configuration, at a 2048-token
    prefill: B4 at each attention
    config's q/k and v head dims (MLA's prefill 192/128; a vision config's
    cross-attention shares its self-attention's head dim)."""
    from repro_torch.configs import ARCHITECTURES, get_config
    out = []
    for arch in ARCHITECTURES:
        cfg = get_config(arch)
        kinds = {cfg.layer_kind(i) for i in range(cfg.num_layers)}
        for dtype in ("bfloat16", "float32"):
            if "attn" in kinds:
                hd = cfg.resolved_head_dim
                hd_v = cfg.v_head_dim if cfg.attention == "mla" else hd
                for kernel in ATTENTION_KERNELS:
                    out.append((arch, kernel, dtype, (hd, hd_v)))
            if "mamba" in kinds:
                c_len = min(cfg.ssm_chunk, PREFILL)
                for kernel in SSD_KERNELS:
                    out.append((arch, kernel, dtype, (
                        -(-PREFILL // c_len), c_len, cfg.ssm_heads,
                        cfg.ssm_head_dim, cfg.ssm_state)))
    return out


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def check_footprint(fp: Footprint, *, shape_name: str = "custom",
                    smem_per_block: Optional[int] = None,
                    smem_per_sm: Optional[int] = None) -> list:
    """SM001 for one block; empty when it fits."""
    from repro_torch.core import costmodel
    per_block = (costmodel.SMEM_PER_BLOCK if smem_per_block is None
                 else smem_per_block)
    per_sm = costmodel.SMEM_PER_SM if smem_per_sm is None else smem_per_sm
    problems = []
    if fp.smem > per_block:
        problems.append(
            f"{fp.smem} bytes of shared memory a block (static "
            f"{fp.static_smem}, dynamic {fp.dynamic_smem}) — over the "
            f"{per_block}-byte limit by {fp.smem - per_block}")
    resident = fp.min_blocks * (fp.smem + RESERVED_PER_BLOCK)
    if resident > per_sm:
        problems.append(
            f"its launch bound's {fp.min_blocks} blocks a SM need "
            f"{resident} bytes of the SM's {per_sm}")
    if fp.min_blocks * fp.threads > THREADS_PER_SM:
        problems.append(
            f"its launch bound's {fp.min_blocks} blocks of {fp.threads} "
            f"threads exceed the {THREADS_PER_SM} threads "
            f"(REGISTERS_PER_SM / 32) an SM holds")
    if not problems:
        return []
    return [Finding(
        rule="SM001",
        message=(f"kernel {fp.kernel!r} at shape {shape_name!r}: "
                 + "; ".join(problems)),
        file=fp.file, line=fp.line,
        hint=("shrink the staged tile (or the stages of its ring), or "
              "lower the __launch_bounds__ minimum of blocks a SM"))]


def check_alignment(csrc: Path = CSRC) -> list:
    """SM002 over every unit's block-size constants."""
    findings = []
    seen = set()
    for unit, names in BLOCK_CONSTANTS.items():
        env = constants(unit, csrc)
        for name in names:
            val, file, line = env[name]
            if (file, name) in seen:
                continue
            seen.add((file, name))
            if val % WARP:
                findings.append(Finding(
                    rule="SM002", file=file, line=line,
                    message=(f"block-size constant {name}={val} is not a "
                             f"multiple of the warp width ({WARP}) — the "
                             f"last warp of every block or tile pass runs "
                             f"partly idle"),
                    hint=f"make {name} a multiple of {WARP}"))
    return findings


def run(paths) -> list:
    """The full pass: every kernel at every reference shape, plus the
    alignment check.  ``paths`` is unused (the model is imported, not
    parsed) but accepted for pass-framework uniformity."""
    del paths
    findings = check_alignment()
    for shape_name in sorted(graph_shapes()):
        for kernel in GRAPH_KERNELS:
            findings.extend(check_footprint(footprint(kernel),
                                            shape_name=shape_name))
    for arch, kernel, dtype, arg in lm_shapes():
        fp = (footprint(kernel, dtype=dtype, hd=arg[0], hd_v=arg[1])
              if kernel in ATTENTION_KERNELS
              else footprint(kernel, dtype=dtype, shape=arg))
        findings.extend(check_footprint(fp, shape_name=f"{arch} {dtype}"))
    return findings
