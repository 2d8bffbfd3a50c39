"""Concat (counterpart of hugectr_tpu/layers/core_layers.py `_concat_apply`
:183)."""
from __future__ import annotations

import torch

from ..core.config import DenseLayer
from .base import Layer, register


@register("Concat")
class Concat(Layer):
    def __init__(self, cfg: DenseLayer, in_shapes, gen, device):
        super().__init__()
        self.axis = cfg.axis
        out = list(in_shapes[0])
        out[self.axis] = sum(s[self.axis] for s in in_shapes)
        self.out_shapes = [tuple(out)]

    def forward(self, ins, compute_dtype):
        return [torch.cat(ins, dim=self.axis)]
