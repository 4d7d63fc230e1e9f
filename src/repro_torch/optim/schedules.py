"""Learning-rate schedules: pure functions of an int step, in float32 as
the reference evaluates them (:mod:`repro.optim.schedules`)."""

from __future__ import annotations

import numpy as np

_F = np.float32


def _frac(step, warmup_steps: int, total_steps: int):
    return np.clip((_F(step) - _F(warmup_steps))
                   / _F(max(total_steps - warmup_steps, 1)), _F(0), _F(1))


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    """Linear warm-up to ``peak`` over ``warmup_steps``, then a cosine
    down to ``floor`` at ``total_steps``."""
    def schedule(step: int) -> float:
        s = _F(step)
        if s < warmup_steps:
            return float(_F(peak) * s / _F(max(warmup_steps, 1)))
        cos = np.cos(_F(np.pi) * _frac(step, warmup_steps, total_steps))
        return float(_F(floor) + _F(peak - floor) * _F(0.5) * (_F(1) + cos))
    return schedule


def linear(peak: float, warmup_steps: int, total_steps: int):
    """Linear warm-up to ``peak``, then linear decay to 0 at
    ``total_steps``."""
    def schedule(step: int) -> float:
        s = _F(step)
        if s < warmup_steps:
            return float(_F(peak) * s / _F(max(warmup_steps, 1)))
        return float(_F(peak) * (_F(1)
                                 - _frac(step, warmup_steps, total_steps)))
    return schedule
