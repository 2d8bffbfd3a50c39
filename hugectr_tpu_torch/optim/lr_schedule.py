"""Learning-rate scheduler: warmup + polynomial decay
(counterpart of hugectr_tpu/optim/lr_schedule.py).

Computed on the host in float32, as the JAX package computes it in its step.
"""
from __future__ import annotations

import numpy as np


class LearningRateScheduler:
    def __init__(
        self,
        base_lr: float,
        warmup_steps: int = 1,
        decay_start: int = 0,
        decay_steps: int = 1,
        decay_power: float = 2.0,
        end_lr: float = 0.0,
    ):
        self.base_lr = base_lr
        self.warmup_steps = max(warmup_steps, 1)
        self.decay_start = decay_start
        self.decay_steps = max(decay_steps, 1)
        self.decay_power = decay_power
        self.end_lr = end_lr

    def __call__(self, step: int) -> np.float32:
        """lr at (1-based) `step`."""
        f32 = np.float32
        step = f32(step)
        warmup = f32(self.base_lr) * np.minimum(step, f32(self.warmup_steps)) / f32(
            self.warmup_steps
        )
        if self.decay_start > 0 and step >= self.decay_start:
            after = np.clip((step - f32(self.decay_start)) / f32(self.decay_steps), 0, 1)
            return f32(
                f32(self.base_lr - self.end_lr) * np.power(f32(1.0) - after, f32(self.decay_power))
                + f32(self.end_lr)
            )
        return f32(warmup)

    def get_next(self, step: int) -> float:
        """lr at `step` as a float (lr_schedule.py:44)."""
        return float(self(step))
