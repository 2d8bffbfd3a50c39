"""Dense-network optimizers (counterpart of hugectr_tpu/optim/dense.py
`DenseOptimizer` :22): SGD, MomentumSGD, Nesterov, AdaGrad, RMSProp, Adam
and FTRL, in place on the parameters from each parameter's `.grad`.

The state is a tree {"m" | "v" | "accum" | "z" | "n": {layer: {param:
float32 tensor}}}, the JAX package's layout. RowWiseAdaGrad is an
embedding-row optimizer; dense parameters take element-wise AdaGrad for
it, as in the JAX package. The math runs in float32 (the parameters are
float32), by `sparse_optimizer.update_math`: the JAX package writes the
same formulas twice, for rows and for parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..core.types import Optimizer_t
from ..embedding.sparse_optimizer import update_math
from .params import OptParams

ParamTree = Dict[str, Dict[str, torch.Tensor]]

STATE_KEYS = {
    Optimizer_t.SGD: (),
    Optimizer_t.MomentumSGD: ("m",),
    Optimizer_t.Nesterov: ("m",),
    Optimizer_t.AdaGrad: ("accum",),
    Optimizer_t.RMSProp: ("v",),
    Optimizer_t.Adam: ("m", "v"),
    Optimizer_t.FTRL: ("z", "n"),
}


class DenseOptimizer:
    def __init__(self, opt: OptParams):
        if opt.optimizer == Optimizer_t.RowWiseAdaGrad:
            opt = dataclasses.replace(opt, optimizer=Optimizer_t.AdaGrad)
        if opt.optimizer not in STATE_KEYS:
            raise ValueError(f"unsupported dense optimizer {opt.optimizer}")
        self.opt = opt

    def init(self, params: ParamTree) -> Dict[str, ParamTree]:
        """Zero state, AdaGrad's accumulators at `initial_accu_value`
        (dense.py:34-54)."""
        fill = self.opt.initial_accu_value if self.opt.optimizer == Optimizer_t.AdaGrad else 0.0
        return {
            key: {
                layer: {k: torch.full_like(p, fill, dtype=torch.float32) for k, p in ps.items()}
                for layer, ps in params.items()
            }
            for key in STATE_KEYS[self.opt.optimizer]
        }

    @torch.no_grad()
    def update(
        self, params: ParamTree, state: Dict[str, ParamTree], lr: torch.Tensor, step=1
    ) -> None:
        """One step of every parameter with a gradient (dense.py:56-181), by
        the element-wise rules the sparse optimizers use; `step` gives
        Adam's bias corrections: the model's `StepScalars` (device scalars
        of the 1-based global step) or an int step."""
        keys = STATE_KEYS[self.opt.optimizer]
        for layer, ps in params.items():
            for k, p in ps.items():
                if p.grad is None:
                    continue
                st = {key: state[key][layer][k] for key in keys}
                op, val, new = update_math(self.opt, p, st, p.grad.float(), lr, step)
                p.copy_((p + val if op == "add" else val).to(p.dtype))
                for key, v in new.items():
                    st[key].copy_(v)
