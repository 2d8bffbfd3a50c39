"""Sigmoid binary cross-entropy (counterpart of hugectr_tpu/layers/losses.py
`_bce_apply` :23). The loss bottom is a logit; the per-sample loss is
log(1 + e^l) - l*y in the logaddexp form, whose gradient is exactly
sigmoid(l) - y everywhere.
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
