"""Optimizer hyperparameters (counterpart of hugectr_tpu/optim/params.py)."""
from __future__ import annotations

import dataclasses

from ..core.types import Optimizer_t, Update_t


@dataclasses.dataclass
class OptParams:
    optimizer: Optimizer_t = Optimizer_t.SGD
    lr: float = 0.001
    update_type: Update_t = Update_t.Global
    momentum_factor: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-7
    initial_accu_value: float = 0.0
    beta: float = 0.9
    lambda1: float = 0.0
    lambda2: float = 0.0
    ftrl_beta: float = 0.0
    scaler: float = 1.0

    def __post_init__(self):
        self.optimizer = Optimizer_t(self.optimizer)
        self.update_type = Update_t(self.update_type)
