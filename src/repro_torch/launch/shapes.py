"""Assigned input shapes × step kinds, and the skip rules (the
counterpart of :mod:`repro.launch.shapes`).

=============  ========  ============  ============================
shape          seq_len   global_batch  lowers
=============  ========  ============  ============================
train_4k       4,096     256           train_step
prefill_32k    32,768    32            prefill_step (fwd + cache write)
decode_32k     32,768    128           serve_step (1 token, 32k cache)
long_500k      524,288   1             serve_step — sub-quadratic archs
                                       only (SSM / hybrid); pure
                                       full-attention archs skip
=============  ========  ============  ============================
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

#: archs whose sequence mixing is sub-quadratic end-to-end (SSM/hybrid) —
#: the only ones that run long_500k (DESIGN.md §5; MLA and GQA are still
#: full attention, so every other arch skips it).
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return (f"{cfg.name} is pure full-attention ({cfg.family}); "
                "long_500k requires sub-quadratic sequence mixing "
                "(skip noted in DESIGN.md §5)")
    return None


def cells(arch_names, shapes=None):
    """All (arch, shape) cells in assignment order."""
    from repro_torch.configs import get_config
    out = []
    for a in arch_names:
        cfg = get_config(a)
        for s in (shapes or SHAPES):
            out.append((a, cfg, SHAPES[s]))
    return out
