"""Optimizer hyperparameters (counterpart of hugectr_tpu/optim/params.py)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

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


class StepScalars:
    """What a step reads of the host's 1-based global step, as persistent
    device scalars filled before each step (`fill`), as the model fills its
    learning rate: `step` (int64, Dropout's masks, the JAX package's
    `fold_in(rng, step)`, model.py:801) and Adam's bias corrections
    (`corrections`). A captured step reads them where the JAX package's
    jitted step computes them from its traced step
    (sparse_optimizer.py:858-866, dense.py:150-151), so a replay takes the
    step it runs and not the step it was captured at. The corrections are
    the float32 values `adam_bias_corrections` gives, one pair for each
    (beta1, beta2) asked for; a pair asked for the first time (in an eager
    step, before any capture) is filled at once."""

    def __init__(self, device=None):
        self.device = device
        self.step = torch.zeros((), dtype=torch.int64, device=device)
        self.host = 0
        self._bc: Dict[Tuple[float, float], Tuple[torch.Tensor, torch.Tensor]] = {}

    def fill(self, step: int) -> None:
        """Set every scalar to the values of `step` (fills, no copy from
        the host)."""
        self.host = step
        self.step.fill_(step)
        for (b1, b2), pair in self._bc.items():
            self._fill_pair(b1, b2, pair)

    def _fill_pair(self, b1: float, b2: float, pair) -> None:
        vals = adam_bias_corrections(OptParams(beta1=b1, beta2=b2), self.host)
        for t, v in zip(pair, vals):
            t.fill_(v)

    def tensors(self):
        """The step and every pair of corrections made so far."""
        return [self.step, *(t for pair in self._bc.values() for t in pair)]

    def corrections(self, opt: OptParams) -> Tuple[torch.Tensor, torch.Tensor]:
        """1 - beta1^t and 1 - beta2^t of `opt`'s betas at the filled step,
        0-dim float32 device tensors."""
        key = (float(opt.beta1), float(opt.beta2))
        pair = self._bc.get(key)
        if pair is None:
            pair = tuple(torch.ones((), dtype=torch.float32, device=self.device) for _ in range(2))
            self._fill_pair(*key, pair)
            self._bc[key] = pair
        return pair


def bias_corrections(opt: OptParams, step) -> Tuple:
    """Adam's (1 - beta1^t, 1 - beta2^t) for `step`: a `StepScalars`' device
    scalars, the float32 values of an int step (the callers that pass the
    host's step: tests, tools), or a pair of corrections as it is."""
    if isinstance(step, StepScalars):
        return step.corrections(opt)
    if isinstance(step, tuple):
        return step
    return adam_bias_corrections(opt, step)
