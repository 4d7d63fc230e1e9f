"""Step builders of the port (the counterpart of
:mod:`repro.launch.steps`): the train step over a data-parallel group,
and thin prefill/serve steps over a model's ``forward``/``decode_step``.

The reference returns jittable functions of explicit parameter trees with
their shardings; the port's model holds its weights, so the train step
holds the model and updates its parameters and the optimizer's moments in
place.  Its state is ``{"params": {path: parameter}, "opt": AdamW state}``
(a tree of tensors, so :class:`repro_torch.runtime.trainer.Trainer`
checkpoints and restores it).

:func:`build_step` is the dry run's: the step of a production shape over
an abstract (meta) model, its abstract arguments, the mesh, and the spec
trees whose per-device shards make the step's resident state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as tdist

from repro_torch.launch.mesh import DataGroup
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LanguageModel
from repro_torch.models.model import model_param_specs
from repro_torch.models.params import abstract_params, leaves
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import warmup_cosine


def make_optimizer(cfg: ModelConfig) -> AdamW:
    return AdamW(learning_rate=warmup_cosine(3e-4, 2000, 100000),
                 state_dtype=cfg.opt_state_dtype)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """``name -> (shape, dtype)`` of a training batch of this arch."""
    B, S = shape.global_batch, shape.seq_len
    tok = ((B, S, cfg.num_codebooks) if cfg.family == "audio" else (B, S))
    specs = {"tokens": (tok, torch.int32), "labels": (tok, torch.int32)}
    if cfg.family == "vlm":
        specs["vision_embeds"] = ((B, cfg.num_image_tokens, cfg.d_model),
                                  getattr(torch, cfg.dtype))
    return specs


class TrainStep:
    """``train_step(state, batch) -> (state, metrics)`` of one config: the
    loss's gradients (over ``cfg.microbatches`` slices of the batch,
    summed in float32 and divided by their number), averaged over the
    data-parallel group, then one AdamW update in place."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec,
                 group: Optional[DataGroup], device, seed: int,
                 optimizer: Optional[AdamW] = None):
        self.cfg, self.shape, self.group = cfg, shape, group
        self.model = LanguageModel(cfg, seed=seed, device=device)
        self.model.requires_grad_(True)
        self.opt = optimizer or make_optimizer(cfg)

    def init_state(self) -> dict:
        params = dict(leaves(self.model.param_tree()))
        return {"params": params, "opt": self.opt.init(params)}

    def _grads(self, params: dict, batch: dict):
        names = list(params)
        total, metrics = self.model.loss(batch)
        grads = torch.autograd.grad(total, [params[k] for k in names],
                                    allow_unused=True)
        return {k: torch.zeros_like(params[k]) if g is None else g
                for k, g in zip(names, grads)}, metrics

    def gradients(self, state: dict, batch: dict):
        """``(grads, metrics)`` of ``batch``: the loss's gradients by
        parameter path (the group's mean) and the loss's metrics."""
        params = state["params"]
        mb = max(self.cfg.microbatches, 1)
        if mb == 1:
            grads, metrics = self._grads(params, batch)
        else:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            metrics = {}
            for i in range(mb):
                micro = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                         for k, v in batch.items()}
                g, m = self._grads(params, micro)
                for k in grads:
                    grads[k] += g[k].float()
                for k, v in m.items():
                    metrics[k] = metrics.get(k, 0.0) + v.float() / mb
            grads = {k: g / mb for k, g in grads.items()}
        group = self.group
        if group is not None and group.process_group is not None:
            # the mean over the group, in float32
            grads = {k: g.float() for k, g in grads.items()}
            for g in grads.values():
                tdist.all_reduce(g, group=group.process_group)
                g /= group.size
            for k, v in metrics.items():
                v = v.float().clone()
                tdist.all_reduce(v, group=group.process_group)
                metrics[k] = v / group.size
        return grads, dict(metrics)

    def __call__(self, state: dict, batch: dict):
        grads, metrics = self.gradients(state, batch)
        metrics.update(self.opt.update(grads, state["opt"],
                                       state["params"]))
        return state, metrics


def build_train_step(cfg: ModelConfig, shape: ShapeSpec,
                     group: Optional[DataGroup] = None, *, device="cuda",
                     seed: int = 0,
                     optimizer: Optional[AdamW] = None) -> TrainStep:
    """The train step of ``cfg`` at ``shape``, its model's weights drawn
    from ``seed`` on ``device`` (the group's device when a group is
    given), with ``optimizer`` (default :func:`make_optimizer`'s);
    ``step.init_state()`` gives the state it updates."""
    if group is not None:
        device = group.device
    return TrainStep(cfg, shape, group, device, seed, optimizer)


def build_prefill_step(model: LanguageModel):
    """``prefill_step(batch, cache) -> (greedy next token [B,1], cache)``
    through ``model.forward``."""
    def prefill_step(batch: dict, cache: dict):
        logits, cache = model.forward(
            batch["tokens"], cache=cache,
            vision_embeds=batch.get("vision_embeds"))
        return logits[:, -1:].argmax(-1), cache
    return prefill_step


def build_serve_step(model: LanguageModel):
    """``serve_step(cache, tokens, position) -> (greedy token, cache)``:
    one decode step through ``model.decode_step``."""
    def serve_step(cache: dict, tokens: torch.Tensor, position):
        logits, cache = model.decode_step(cache, tokens, position)
        return logits.argmax(-1), cache
    return serve_step


@dataclasses.dataclass
class BuiltStep:
    """A production step over an abstract model: ``fn(*args)`` runs it on
    meta tensors; ``specs`` names the spec trees (``params``, ``opt``,
    ``grads``, ``cache``) whose per-device shards are its resident state.
    A train step's ``fn`` returns the gradients it applied, so the dry run
    tells them from the activations."""
    fn: Callable
    args: tuple
    mesh: Any
    specs: dict


def _abstract_batch(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    return {k: torch.empty(shp, dtype=dt, device="meta")
            for k, (shp, dt) in batch_specs(cfg, shape).items()}


def build_step(cfg: ModelConfig, shape: ShapeSpec, mesh) -> BuiltStep:
    """The step of ``cfg`` at ``shape`` over an abstract (meta) model:

    * train: :class:`TrainStep` (gradients, then AdamW in place) on the
      batch of :func:`batch_specs`;
    * prefill: :func:`build_prefill_step` into an abstract cache of the
      prompt's length;
    * decode: :func:`build_serve_step`, one token a sequence at the last
      position of an abstract ``seq_len`` cache (one long sequence's cache
      sharded over ``data`` along the sequence, as the reference's)."""
    pspecs = model_param_specs(cfg)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        step = TrainStep(cfg, shape, None, "meta", 0)
        state = step.init_state()

        def train_step(state, batch):
            grads, _ = step.gradients(state, batch)
            step.opt.update(grads, state["opt"], state["params"])
            return grads
        return BuiltStep(train_step, (state, _abstract_batch(cfg, shape)),
                         mesh, {"params": pspecs,
                                "opt": step.opt.state_specs(pspecs),
                                "grads": pspecs})
    model = LanguageModel(cfg, device="meta")
    if shape.kind == "prefill":
        batch = _abstract_batch(cfg, shape)
        batch.pop("labels")
        cspecs = model.cache_specs(B, S)
        return BuiltStep(build_prefill_step(model),
                         (batch, abstract_params(cspecs)), mesh,
                         {"params": pspecs, "cache": cspecs})
    cspecs = model.cache_specs(B, S,
                               seq_axis="data" if B % 16 else None)
    tok = (B, 1, cfg.num_codebooks) if cfg.family == "audio" else (B, 1)
    tokens = torch.empty(tok, dtype=torch.int32, device="meta")
    return BuiltStep(build_serve_step(model),
                     (abstract_params(cspecs), tokens, S - 1), mesh,
                     {"params": pspecs, "cache": cspecs})
