"""The data-parallel group of a training run (the part of
:mod:`repro.launch.mesh` that ``launch/train.py`` needs).

Without an initialised ``torch.distributed`` the group is this process on
one device; with one, it is one rank a device (each rank sets its card
with ``torch.cuda.set_device`` first).  The reference's production TPU
mesh (16 x 16 chips a pod, two pods) and its PartitionSpec rewriting are
ROADMAP A15 item 5.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as tdist

from repro_torch.core.graph import resolve_device


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


def make_production_mesh():
    """The reference's production mesh is not ported."""
    raise NotImplementedError(
        "the production mesh (16 x 16 chips a pod, one or two pods) and "
        "the dry run are not ported to repro_torch (ROADMAP A15 item 5)")
