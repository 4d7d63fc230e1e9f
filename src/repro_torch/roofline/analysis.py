"""Three-term roofline of a step on H100s (the counterpart of
:mod:`repro.roofline.analysis`).

    compute term    = FLOPs       / (chips × peak_FLOP/s)
    memory term     = bytes       / (chips × HBM_bw)
    collective term = coll_bytes  / (chips × link_bw)

The port has no HLO.  :mod:`repro_torch.launch.dryrun` counts a step
traced over meta tensors: products by ``FlopCounterMode``, every
dispatched op's input and output bytes, and B4 and B5 (forward and
backward) by the closed forms of :mod:`repro_torch.kernels.cost`, which
their meta branches add to its counter.  Collective bytes come from
the plan that the parameters' partition specs imply
(:func:`collective_bytes_of_plan`), with the reference's result-buffer
convention (per device, the size of each collective's result).

The figures of :data:`HARDWARE` are the NVIDIA H100 SXM data sheet's
peaks at the full 700 W power limit, dense (no sparsity): none is a
measurement.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.launch.mesh import adapt_pspec, data_axes
from repro_torch.models.model import model_param_specs
from repro_torch.models.params import DTYPES, leaves

#: one H100 SXM, data-sheet peaks (700 W), not measurements
HARDWARE = {
    "peak_flops": 989e12,       # dense bf16 tensor-core FLOP/s
    "peak_flops_f32": 67e12,    # float32 FLOP/s outside the tensor cores
    "hbm_bw": 3.35e12,          # HBM3 bytes/s
    "nvlink_bw": 450e9,         # NVLink bytes/s a direction, within a node of 8
    "internode_bw": 50e9,       # bytes/s a GPU across nodes (400 Gb/s NDR)
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


# ---------------------------------------------------------------------------
# collectives: the plan the partition specs imply
# ---------------------------------------------------------------------------

def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def link_bw(mesh, axes) -> float:
    """The slowest link a collective over ``axes`` of ``mesh`` crosses,
    bytes/s: NVLink within a node, else the inter-node rate
    (:meth:`repro_torch.launch.mesh.ProductionMesh.crosses_nodes`)."""
    return (HARDWARE["internode_bw"] if mesh.crosses_nodes(axes)
            else HARDWARE["nvlink_bw"])


def collective_bytes_of_plan(cfg, shape, mesh) -> dict:
    """Per-device collective result bytes of one step of ``cfg`` at
    ``shape`` on ``mesh`` (a ``launch.mesh.ProductionMesh``): the dict of
    the reference's ``collective_bytes_from_hlo`` (``per_type``,
    ``counts``, ``total``) plus ``link_bw``, the slowest link the plan's
    collectives cross (bytes/s; the NVLink rate where there is none).

    With ``dp`` the data ways (``pod`` x ``data``), ``tp`` the ``model``
    ways, ``B_l = B / dp`` the local batch (``B`` where ``dp`` does not
    divide it), ``T`` the tokens a sequence (``S``; 1 to decode), ``a``
    the activations' bytes an element and ``passes`` 2 to train (forward
    and backward) else 1; for a parameter leaf of ``n`` bytes, ``m`` its
    ``model`` ways and ``s`` all its ways (its adapted ``pspec``):

    * all-gather: a leaf sharded over data axes (FSDP) is gathered over
      them before each pass, its result ``passes · n / (s / g)`` with
      ``g`` the gathered ways;
    * reduce-scatter (train): the gradient of an FSDP leaf over those
      axes, ``n / s``;
    * all-reduce (train): the gradient over the data axes a leaf is
      replicated on (all of them for a leaf that is not FSDP; ``pod``
      for experts on the ``data`` x ``model`` grid, which is no FSDP),
      ``n / s``;
    * all-reduce over ``model``: each sublayer whose output projection
      contracts a ``model``-sharded axis (the mixer's ``wo``, the FFN's
      and the shared experts' ``w_down``, the experts' ``w_down`` over
      their inner dim, the cross-attention's ``wo``) sums its output,
      ``B_l · T · D · a`` a pass, where ``tp > 1``;
    * all-to-all: an MoE layer whose experts lie over ``model`` (or the
      ``data`` x ``model`` grid) dispatches its assignments and combines
      them, ``2 · passes · B_l · T · K · cf · D · a``.

    Not counted: the softmax and cross-entropy statistics over a
    vocabulary sharded over ``model``, a sequence-sharded cache's partial
    attention outputs, and the embedding's lookup."""
    per_type = {c: 0 for c in _COLLECTIVES}
    counts = {c: 0 for c in _COLLECTIVES}
    crossed = set()

    def add(kind: str, nbytes: float, axes: tuple) -> None:
        if nbytes <= 0 or mesh.size(axes) <= 1:
            return
        per_type[kind] += int(nbytes)
        counts[kind] += 1
        crossed.add(axes)

    d_axes = _axes(data_axes(mesh))
    dp, tp = mesh.size(d_axes), mesh.size("model")
    train = shape.kind == "train"
    passes = 2 if train else 1
    B = shape.global_batch
    B_l = B // dp if B % dp == 0 else B
    T = 1 if shape.kind == "decode" else shape.seq_len
    act = DTYPES[cfg.dtype].itemsize
    tokens = B_l * T * cfg.d_model * act

    specs = model_param_specs(cfg)
    for _, spec in leaves(specs):
        pspec = adapt_pspec(spec.pspec, mesh)
        names = {a for e in pspec for a in _axes(e)}
        n = spec.torch_dtype.itemsize
        for dim in spec.shape:
            n *= dim
        expert_grid = ("data", "model") in pspec
        gathered = tuple(a for a in d_axes
                         if a in names and not expert_grid)
        replicated = tuple(a for a in d_axes if a not in names)
        s = mesh.size(tuple(names))
        for _ in range(passes):
            add("all-gather", n * mesh.size(gathered) / s, gathered)
        if train:
            add("reduce-scatter", n / s, gathered)
            add("all-reduce", n / s, replicated)

    if tp > 1:
        for block in specs["layers"]:
            for key in ("mixer", "cross", "ffn"):
                if key in block and _model_contracted(block[key], mesh):
                    for _ in range(passes):
                        add("all-reduce", tokens, ("model",))
            moe = block.get("moe")
            if moe is None:
                continue
            ep = "model" in _axes(adapt_pspec(
                moe["experts"]["w_down"].pspec, mesh)[0])
            if ep:
                assign = (B_l * T * cfg.experts_per_token
                          * cfg.moe_capacity_factor * cfg.d_model * act)
                grid = ("data", "model") if cfg.serve_ep else ("model",)
                for _ in range(2 * passes):
                    add("all-to-all", assign, grid)
            elif _model_contracted(moe["experts"], mesh):
                for _ in range(passes):
                    add("all-reduce", tokens, ("model",))
            if "shared" in moe and _model_contracted(moe["shared"], mesh):
                for _ in range(passes):
                    add("all-reduce", tokens, ("model",))
    link = min((link_bw(mesh, a) for a in crossed),
               default=HARDWARE["nvlink_bw"])
    return {"per_type": per_type, "counts": counts,
            "total": sum(per_type.values()), "link_bw": link}


def _model_contracted(sub: dict, mesh) -> bool:
    """Whether a sublayer's output projection (``wo`` or ``w_down``)
    contracts an axis sharded over ``model``: all axes but its last."""
    w = sub.get("wo") or sub.get("w_down")
    if w is None:
        return False
    pspec = adapt_pspec(w.pspec, mesh)[:len(w.shape) - 1]
    return any("model" in _axes(e) for e in pspec)


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # global (per-device × chips)
    hlo_bytes: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    bytes_per_device: Optional[float] = None
    collective_detail: Optional[dict] = None

    def table_row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} | "
                f"{self.compute_s*1e3:.2f} | {self.memory_s*1e3:.2f} | "
                f"{self.collective_s*1e3:.2f} | {self.dominant} | "
                f"{self.useful_ratio:.2f} |")


def roofline_terms(*, arch: str, shape: str, mesh_name: str, chips: int,
                   per_device_flops: float, per_device_bytes: float,
                   per_device_collective_bytes: float, model_flops: float,
                   bytes_per_device: Optional[float] = None,
                   collective_detail: Optional[dict] = None
                   ) -> RooflineReport:
    """The reference's three terms at :data:`HARDWARE`'s rates; the
    collective term divides by ``collective_detail["link_bw"]``, the
    slowest link the plan's collectives cross (no detail: the inter-node
    rate)."""
    hw = HARDWARE
    link = (collective_detail or {}).get("link_bw", hw["internode_bw"])
    g_flops = per_device_flops * chips
    g_bytes = per_device_bytes * chips
    g_coll = per_device_collective_bytes * chips
    compute_s = g_flops / (chips * hw["peak_flops"])
    memory_s = g_bytes / (chips * hw["hbm_bw"])
    coll_s = g_coll / (chips * link)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=g_flops, hlo_bytes=g_bytes, collective_bytes=g_coll,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        dominant=dominant, model_flops=model_flops,
        useful_ratio=(model_flops / g_flops) if g_flops else 0.0,
        bytes_per_device=bytes_per_device,
        collective_detail=collective_detail,
    )


def model_flops_for(cfg, shape_kind: str, seq_len: int, global_batch: int,
                    active_params: int) -> float:
    """6·N_active·D for training, 2·N_active·D forward-only."""
    if shape_kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * active_params * tokens
    if shape_kind == "prefill":
        tokens = seq_len * global_batch
        return 2.0 * active_params * tokens
    # decode: one token per sequence
    return 2.0 * active_params * global_batch
