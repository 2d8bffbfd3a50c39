"""Loss layers (counterparts of hugectr_tpu/layers/losses.py `_bce_apply`
:23, `_ce_apply` :39-46 and `_mce_apply` :49-60), per-sample losses in
float32. BinaryCrossEntropyLoss: the bottom is a logit and the loss
log(1 + e^l) - l*y in the logaddexp form, whose gradient is exactly
sigmoid(l) - y everywhere. CrossEntropyLoss: softmax cross-entropy of
[B, C] logits against one-hot [B, C] labels. MultiCrossEntropyLoss: the
logaddexp BCE of each target, times `target_weight_vec` where given,
averaged over the targets.

`regularizer_term` is the L1 or L2 term a loss layer with
`use_regularizer` adds (losses.py:63-81): lambda / B times the sum of
|w| (L1), or lambda / (2 B) times the sum of w^2 (L2), over every dense
parameter (biases and BatchNorm's gamma and beta too), in float32, with B
the global batch.
"""
from __future__ import annotations

from typing import Iterable

import torch

from ..core.config import DenseLayer
from ..core.types import Regularizer_t
from .base import Layer, register


@register("BinaryCrossEntropyLoss")
class BinaryCrossEntropyLoss(Layer):
    def __init__(self, cfg: DenseLayer, in_shapes, gen, device):
        super().__init__()
        self.out_shapes = [in_shapes[0]]

    def forward(self, ins, compute_dtype):
        logits, labels = ins[0].float(), ins[1].float()
        logits = logits.reshape(labels.shape)
        return [torch.logaddexp(torch.zeros_like(logits), logits) - logits * labels]


@register("CrossEntropyLoss")
class CrossEntropyLoss(BinaryCrossEntropyLoss):
    def forward(self, ins, compute_dtype):
        logits, labels = ins[0].float(), ins[1].float()
        return [-(labels * torch.log_softmax(logits, dim=-1)).sum(dim=-1, keepdim=True)]


@register("MultiCrossEntropyLoss")
class MultiCrossEntropyLoss(BinaryCrossEntropyLoss):
    def __init__(self, cfg: DenseLayer, in_shapes, gen, device):
        super().__init__(cfg, in_shapes, gen, device)
        self.weights = (torch.as_tensor(cfg.target_weight_vec, dtype=torch.float32, device=device)
                        if cfg.target_weight_vec else None)

    def forward(self, ins, compute_dtype):
        logits, labels = ins[0].float(), ins[1].float()
        loss = torch.logaddexp(torch.zeros_like(logits), logits) - logits * labels
        if self.weights is not None:
            loss = loss * self.weights
        return [loss.mean(dim=-1, keepdim=True)]


def regularizer_term(reg_type, lam: float, batch_size: int, weights: Iterable[torch.Tensor]) -> torch.Tensor:
    """The regularizer's value over `weights`, a float32 scalar (a Python 0.0
    when lambda is 0 or the type is NonE)."""
    reg_type = Regularizer_t(reg_type)
    if lam == 0.0 or reg_type == Regularizer_t.NonE:
        return 0.0
    if reg_type == Regularizer_t.L1:
        # |w| whose derivative at 0 is 1, as jnp.abs's is (torch.abs's is 0):
        # the zero-initialised biases move under L1 from the first step
        return lam / batch_size * sum(torch.where(w >= 0, w, -w).float().sum() for w in weights)
    return lam / (2.0 * batch_size) * sum(w.float().square().sum() for w in weights)
