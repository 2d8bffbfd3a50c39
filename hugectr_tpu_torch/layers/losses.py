"""Loss layers (counterparts of hugectr_tpu/layers/losses.py `_bce_apply`
:23, `_ce_apply` :39-46 and `_mce_apply` :49-60), per-sample losses in
float32. BinaryCrossEntropyLoss: the bottom is a logit and the loss
log(1 + e^l) - l*y in the logaddexp form, whose gradient is exactly
sigmoid(l) - y everywhere. CrossEntropyLoss: softmax cross-entropy of
[B, C] logits against one-hot [B, C] labels. MultiCrossEntropyLoss: the
logaddexp BCE of each target, times `target_weight_vec` where given,
averaged over the targets.
"""
from __future__ import annotations

import torch

from ..core.config import DenseLayer
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
