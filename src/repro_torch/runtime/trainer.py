"""Fault-tolerant training loop (the counterpart of
:mod:`repro.runtime.trainer`).

* **Checkpoint and restart**: asynchronous step-atomic checkpoints
  (:class:`repro_torch.checkpoint.AsyncCheckpointer`); a step that raises
  restores the latest committed step and goes on, up to ``max_retries``
  failures in a row.
* **Deterministic data**: a batch is a pure function of (seed, step)
  (:class:`repro_torch.data.TokenPipeline`), so a restart replays from the
  checkpointed step.
* **Stragglers**: a step slower than ``straggler_factor`` times the EWMA
  of step times is logged and counted.

The run ends with a checkpoint of its last step, unless the step's own
``checkpoint_every`` save just wrote it (the reference writes it twice).

The state is a tree of tensors that ``train_step(state, batch) ->
(state, metrics)`` updates (the port's step updates the model's
parameters and the optimizer's moments in place); a restore copies the
checkpoint into it in place (:func:`repro_torch.checkpoint.assign`).  A
step's time is taken after ``torch.cuda.synchronize`` where the state
lies on the card (the reference's ``block_until_ready``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint.store import (AsyncCheckpointer, assign,
                                          latest_step, restore_checkpoint)
from repro_torch.models.params import leaves

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    max_retries: int = 3
    straggler_factor: float = 2.0
    ewma_alpha: float = 0.1


@dataclasses.dataclass
class StepRecord:
    step: int
    seconds: float
    metrics: dict
    straggler: bool


class Trainer:
    """Drives ``train_step(state, batch) -> (state, metrics)`` over
    ``pipeline.batch_at(step)``, each batch's arrays moved to ``device``
    (default: the device of the state's first tensor)."""

    def __init__(self, train_step: Callable, init_state: Any, pipeline,
                 config: TrainConfig, device=None):
        self.train_step = train_step
        self.state = init_state
        self.pipeline = pipeline
        self.config = config
        first = next(t for _, t in leaves(init_state))
        self.device = torch.device(device) if device else first.device
        self.step = 0
        self.ckpt = (AsyncCheckpointer(config.checkpoint_dir)
                     if config.checkpoint_dir else None)
        self.history: list[StepRecord] = []
        self._saved: Optional[int] = None     # the step last checkpointed
        self.straggler_count = 0
        self._ewma: Optional[float] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def maybe_restore(self) -> bool:
        """Resume from the latest committed checkpoint, if any."""
        cfg = self.config
        if not cfg.checkpoint_dir:
            return False
        last = latest_step(cfg.checkpoint_dir)
        if last is None:
            return False
        restored, meta = restore_checkpoint(cfg.checkpoint_dir, last,
                                            self.state)
        assign(self.state, restored)
        self.step = meta["step"]
        log.info("restored checkpoint at step %d", self.step)
        return True

    def run(self) -> list[StepRecord]:
        cfg = self.config
        retries = 0
        while self.step < cfg.total_steps:
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.pipeline.batch_at(self.step).items()}
            t0 = time.perf_counter()
            try:
                new_state, metrics = self.train_step(self.state, batch)
                self._sync()
            except Exception as exc:                     # noqa: BLE001
                retries += 1
                log.warning("step %d failed (%s); retry %d/%d",
                            self.step, exc, retries, cfg.max_retries)
                if retries > cfg.max_retries:
                    raise
                if self.ckpt is not None:
                    self.ckpt.wait()
                self.maybe_restore()     # without a checkpoint: retry as is
                continue
            retries = 0
            self.state = new_state
            dt = time.perf_counter() - t0
            straggle = (self._ewma is not None
                        and dt > cfg.straggler_factor * self._ewma)
            if straggle:
                self.straggler_count += 1
                log.warning("straggler step %d: %.3fs vs ewma %.3fs",
                            self.step, dt, self._ewma)
            self._ewma = (dt if self._ewma is None else
                          (1 - cfg.ewma_alpha) * self._ewma
                          + cfg.ewma_alpha * dt)
            host_metrics = {k: float(v) for k, v in metrics.items()}
            self.history.append(StepRecord(self.step, dt, host_metrics,
                                           straggle))
            self.step += 1
            if cfg.checkpoint_dir and self.step % cfg.checkpoint_every == 0:
                self._save()
            if self.step % cfg.log_every == 0:
                log.info("step %d loss=%.4f %.3fs/step", self.step,
                         host_metrics.get("loss", float("nan")), dt)
        if self.ckpt is not None:
            if self._saved != self.step:
                self._save()
            self.ckpt.wait()
        return self.history

    def _save(self) -> None:
        self.ckpt.save(self.step, self.state,
                       {"pipeline_seed": self.pipeline.seed})
        self._saved = self.step
