"""Step-atomic, restart-safe checkpoints of a tree of tensors (the
counterpart of :mod:`repro.checkpoint.store`).

* **Atomic commit**: a step is written to ``step_<n>.tmp/`` and
  ``os.replace``'d to ``step_<n>/``; a crash mid-write never corrupts the
  latest restorable step (:func:`latest_step` skips ``.tmp``).
* **Async writer**: :class:`AsyncCheckpointer` copies the tensors to the
  host (the snapshot), then serialises, commits and garbage-collects on a
  background thread while training goes on.
* **Restore onto a device**: :func:`restore_checkpoint` rebuilds the
  template's structure with each leaf in the template leaf's dtype, on a
  given device (default: the template leaf's).

A tree is nested dicts and lists of tensors (leaf paths as
:func:`repro_torch.models.params.leaves` names them).  Arrays go into one
``arrays.npz``; a bfloat16 leaf is stored as its int16 bits and its dtype
recorded in ``meta.json`` (numpy has no bfloat16 without ``ml_dtypes``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.params import leaves, map_tree


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host tensor as (numpy array, dtype name); bf16 as int16 bits."""
    name = str(t.dtype).rsplit(".", 1)[-1]
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), name
    return t.numpy(), name


def _snapshot(tree: Any) -> Any:
    """The tree with every tensor copied to the host."""
    return map_tree(lambda _, t: t.detach().to("cpu", copy=True), tree)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Blocking save; returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, dtypes = {}, {}
    for path, t in leaves(_snapshot(tree)):
        arrays[path], dtypes[path] = _to_numpy(t)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "extra": extra or {}, "dtypes": dtypes}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic commit
    return final


def _steps(directory: str) -> list:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> Optional[int]:
    """The latest committed step under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int, template: Any,
                       device=None) -> tuple[Any, dict]:
    """``(tree, meta)``: the step's arrays in the structure of
    ``template``, each leaf in the template leaf's dtype, on ``device``
    (default: the template leaf's device)."""
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        def load(key, leaf):
            arr = torch.from_numpy(np.array(data[key]))
            if meta["dtypes"][key] == "bfloat16":
                arr = arr.view(torch.bfloat16)
            return arr.to(device=leaf.device if device is None else device,
                          dtype=leaf.dtype)
        return map_tree(load, template), meta


def assign(target: Any, tree: Any) -> None:
    """Copy every tensor of ``tree`` into the same path of ``target`` in
    place (a restored state into the live one a train step updates)."""
    values = dict(leaves(tree))
    with torch.no_grad():
        for path, t in leaves(target):
            t.copy_(values[path])


class AsyncCheckpointer:
    """Snapshot to the host, then serialise on a background thread; keeps
    the ``keep`` latest steps."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_committed: Optional[int] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()                              # one in flight at a time
        host_tree = _snapshot(tree)

        def work():
            save_checkpoint(self.directory, step, host_tree, extra)
            self.last_committed = step
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)
