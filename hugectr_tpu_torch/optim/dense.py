"""Dense-network optimizer (counterpart of hugectr_tpu/optim/dense.py
`DenseOptimizer` :22): element-wise AdaGrad, in place on the parameters.

RowWiseAdaGrad is an embedding-row optimizer; dense parameters take
element-wise AdaGrad for it, as in the JAX package. The other dense
optimizers raise until a later slice ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..core.types import Optimizer_t
from .params import OptParams

ParamTree = Dict[str, Dict[str, torch.Tensor]]


class DenseOptimizer:
    def __init__(self, opt: OptParams):
        if opt.optimizer == Optimizer_t.RowWiseAdaGrad:
            opt = dataclasses.replace(opt, optimizer=Optimizer_t.AdaGrad)
        if opt.optimizer != Optimizer_t.AdaGrad:
            raise NotImplementedError(
                f"dense optimizer {opt.optimizer.value} is not ported yet (ROADMAP Queue 1 item 5)"
            )
        self.opt = opt

    def init(self, params: ParamTree) -> Dict[str, ParamTree]:
        return {
            "accum": {
                layer: {
                    k: torch.full_like(p, self.opt.initial_accu_value, dtype=torch.float32)
                    for k, p in ps.items()
                }
                for layer, ps in params.items()
            }
        }

    @torch.no_grad()
    def update(self, params: ParamTree, state: Dict[str, ParamTree], lr: torch.Tensor) -> None:
        """accum += g^2; p -= lr * g / (sqrt(accum) + eps), from each
        parameter's `.grad` (dense.py:99-114)."""
        eps = self.opt.epsilon
        for layer, ps in params.items():
            for k, p in ps.items():
                if p.grad is None:
                    continue
                g = p.grad.float()
                acc = state["accum"][layer][k]
                acc.add_(g * g)
                p.sub_((lr * g / (torch.sqrt(acc) + eps)).to(p.dtype))
