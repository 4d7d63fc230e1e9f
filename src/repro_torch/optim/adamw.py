"""AdamW over a dict of tensors (the counterpart of
:mod:`repro.optim.adamw`), updating the parameters in place.

The state is ``{"m": {path: tensor}, "v": {path: tensor}, "step": 0-d
int32 tensor on the CPU}``; ``state_dtype="bfloat16"`` keeps the moments
in bf16 (the giant configs' ``opt_state_dtype``), else float32.  Every
update is computed in float32 and rounded to each tensor's dtype, as the
reference computes it.  :meth:`AdamW.state_specs` gives the moments'
specs, sharded as their parameters are (the dry run's per-device state).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.models.params import ParamSpec, map_tree


def clip_by_global_norm(grads: dict, max_norm: float):
    """``(grads scaled to a global norm of at most max_norm, the global
    norm)``: the norm over every leaf in float32, each leaf scaled in
    float32 and rounded back to its dtype."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype)
            for k, g in grads.items()}, gnorm


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Union[Callable[[int], float], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: Optional[float] = 1.0
    state_dtype: Optional[str] = None    # None -> float32 moments

    def _sdt(self) -> torch.dtype:
        return getattr(torch, self.state_dtype) if self.state_dtype \
            else torch.float32

    def init(self, params: dict) -> dict:
        """Zero moments beside each parameter (same shape and device)."""
        def zeros():
            return {k: torch.zeros(p.shape, dtype=self._sdt(),
                                   device=p.device)
                    for k, p in params.items()}
        return {"m": zeros(), "v": zeros(),
                "step": torch.zeros((), dtype=torch.int32)}

    def state_specs(self, param_specs):
        """The state's spec tree: ``m`` and ``v`` mirror the parameters'
        shapes and partition specs in the state's dtype, ``step`` is a
        replicated int32 scalar (the reference's ``state_specs``)."""
        sdt = self.state_dtype or "float32"

        def mom(_, s: ParamSpec) -> ParamSpec:
            return ParamSpec(s.shape, sdt, "zeros", pspec=s.pspec)
        return {"m": map_tree(mom, param_specs),
                "v": map_tree(mom, param_specs),
                "step": ParamSpec((), "int32", "zeros")}

    def lr_at(self, step: int) -> float:
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return float(np.float32(self.learning_rate))

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict) -> dict:
        """One step: clip (where ``max_grad_norm``), then AdamW with decay
        on matrices only (``p.ndim >= 2``).  ``params`` and ``state`` are
        updated in place; returns the metrics (``grad_norm``, ``lr``)."""
        state["step"] += 1
        step = int(state["step"])
        metrics = {}
        if self.max_grad_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm)
            metrics["grad_norm"] = gnorm
        lr = self.lr_at(step)
        metrics["lr"] = torch.tensor(lr, dtype=torch.float32)
        f32 = np.float32
        c1 = float(f32(1) - f32(self.b1) ** f32(step))
        c2 = float(f32(1) - f32(self.b2) ** f32(step))
        for k, p in params.items():
            g32 = grads[k].float()
            m, v = state["m"][k], state["v"][k]
            m32 = m.float() * self.b1 + g32 * (1 - self.b1)
            v32 = v.float() * self.b2 + g32 * g32 * (1 - self.b2)
            delta = (m32 / c1) / (torch.sqrt(v32 / c2) + self.eps)
            if self.weight_decay and p.dim() >= 2:   # decay matrices only
                delta = delta + self.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
            m.copy_(m32.to(m.dtype))
            v.copy_(v32.to(v.dtype))
        return metrics
