"""The data-parallel group of a training run, and the production mesh
that the dry run counts a step over (the counterpart of
:mod:`repro.launch.mesh`).

Without an initialised ``torch.distributed`` the group is this process on
one device; with one, it is one rank a device (each rank sets its card
with ``torch.cuda.set_device`` first).

:func:`make_production_mesh` is a plain :class:`ProductionMesh` (shape,
axis names, chips): no device and no process group, since no 256-rank
world exists to run it.  It keeps the reference's axes and sizes, 16 x 16
``("data", "model")`` and 2 x 16 x 16 ``("pod", "data", "model")``, so the
dry run's records line up cell for cell with the reference's.  On H100s
the devices are numbered with ``model`` fastest, and a node holds
:data:`GPUS_PER_NODE` consecutive devices: the 8 GPUs of a node lie inside
one ``model`` group, joined by NVLink.  A collective whose group spans
more than 8 consecutive devices (any ``model`` axis wider than 8, and
every ``data`` or ``pod`` axis of more than one way) crosses nodes
(:meth:`ProductionMesh.crosses_nodes`), and the roofline charges it at
the inter-node rate (:func:`repro_torch.roofline.analysis.link_bw`).
:func:`shard_shape` is a parameter's per-device shape on such a mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as tdist

from repro_torch.core.graph import resolve_device
from repro_torch.models.params import ParamSpec, map_tree


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """This process's place in the data-parallel group: its device, its
    rank and the group's size (its chips: one a rank), and the process
    group (None: one process)."""
    device: torch.device
    rank: int = 0
    size: int = 1
    process_group: Optional[object] = None


def data_group(device="cuda") -> DataGroup:
    """The data-parallel group on ``device`` (``"cuda"``: this rank's
    current card); a CUDA request without a card raises."""
    dev = resolve_device(device)
    if not (tdist.is_available() and tdist.is_initialized()):
        return DataGroup(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return DataGroup(dev, tdist.get_rank(), tdist.get_world_size(),
                     tdist.group.WORLD)


#: GPUs of one node, joined all to all by NVLink
GPUS_PER_NODE = 8


@dataclasses.dataclass(frozen=True)
class ProductionMesh:
    """A named device grid without devices: ``shape[i]`` devices along
    ``axis_names[i]``, device ids row-major (the last axis fastest)."""
    shape: tuple
    axis_names: tuple

    @property
    def name(self) -> str:
        return "x".join(str(n) for n in self.shape)

    @property
    def chips(self) -> int:
        return math.prod(self.shape)

    def size(self, axes) -> int:
        """Devices along ``axes`` (a name, a tuple of names or None)."""
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.shape[self.axis_names.index(a)] for a in axes)

    def crosses_nodes(self, axes) -> bool:
        """Whether a collective over ``axes`` leaves a node: whether the
        group of device 0 spans more than its first
        :data:`GPUS_PER_NODE` devices."""
        if isinstance(axes, str):
            axes = (axes,)
        stride, span = 1, 1
        for name, n in reversed(list(zip(self.axis_names, self.shape))):
            if name in axes:
                span += (n - 1) * stride
            stride *= n
        return span > GPUS_PER_NODE


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """16 x 16 = 256 GPUs a pod; 2 pods = 512 GPUs when ``multi_pod``."""
    if multi_pod:
        return ProductionMesh((2, 16, 16), ("pod", "data", "model"))
    return ProductionMesh((16, 16), ("data", "model"))


def mesh_chip_count(mesh: ProductionMesh) -> int:
    return mesh.chips


def data_axes(mesh: ProductionMesh):
    """The (composed) batch/FSDP axes of this mesh."""
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def adapt_pspec(pspec: tuple, mesh: ProductionMesh) -> tuple:
    """Rewrite the logical ``"data"`` entries of a partition spec (a tuple
    of None, axis names or tuples of them) to the mesh's composed data
    axes (multi-pod: ``"data"`` -> ``("pod", "data")``)."""
    if "pod" not in mesh.axis_names:
        return tuple(pspec)

    def conv(entry):
        if entry == ("data", "model"):
            return entry          # the EP grid marker stays within a pod
        if entry == "data":
            return ("pod", "data")
        if isinstance(entry, tuple):
            return tuple(x for e in entry for x in
                         (("pod", "data") if e == "data" else (e,)))
        return entry
    return tuple(conv(e) for e in pspec)


def adapt_pspec_tree(tree, mesh: ProductionMesh):
    """:func:`adapt_pspec` on every ``pspec`` of a spec tree."""
    return map_tree(lambda _, s: dataclasses.replace(
        s, pspec=adapt_pspec(s.pspec, mesh)), tree)


def shard_shape(spec: ParamSpec, mesh: ProductionMesh) -> tuple:
    """A leaf's per-device shape on ``mesh``: each dimension divided by
    the devices along the axes its adapted ``pspec`` entry names; an
    indivisible dimension raises, as ``NamedSharding`` does."""
    pspec = adapt_pspec(spec.pspec, mesh)
    if len(pspec) > len(spec.shape):
        raise ValueError(f"pspec {pspec} has more entries than shape "
                         f"{spec.shape}")
    out = []
    for i, dim in enumerate(spec.shape):
        ways = mesh.size(pspec[i] if i < len(pspec) else None)
        if dim % ways:
            raise ValueError(f"dimension {i} of {spec.shape} does not "
                             f"divide over {pspec[i]} ({ways} ways)")
        out.append(dim // ways)
    return tuple(out)
