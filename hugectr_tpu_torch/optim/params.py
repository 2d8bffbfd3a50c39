"""Optimizer hyperparameters (counterpart of hugectr_tpu/optim/params.py)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

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


def adam_bias_corrections(opt: OptParams, step: int) -> Tuple[float, float]:
    """1 - beta1^t and 1 - beta2^t of the 1-based global step t as float32
    values (sparse_optimizer.py:858-866 and dense.py:150-151: float32,
    since bfloat16 rounds beta2 0.999 to 0.996)."""
    t = np.float32(step)
    one = np.float32(1.0)
    return float(one - np.float32(opt.beta1) ** t), float(one - np.float32(opt.beta2) ** t)
