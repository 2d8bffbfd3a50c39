"""Concat and Reshape (counterparts of hugectr_tpu/layers/core_layers.py
`_concat_apply` :183 and `_reshape_apply` :101-144)."""
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


@register("Reshape")
class Reshape(Layer):
    """One of four forms (core_layers.py:101-144): `shape` (one -1 takes
    the rest), `selected` (slots `selected_slots` of [B, slots, E], then
    flattened per sample), `time_step` ([N, time_step, leading]) or
    `leading_dim` ([N, leading], default the per-sample size)."""

    def __init__(self, cfg: DenseLayer, in_shapes, gen, device):
        super().__init__()
        self.cfg = cfg
        s = in_shapes[0]
        batch = s[0]
        total = batch
        for d in s[1:]:
            total *= d
        self.leading = cfg.leading_dim or total // batch
        if cfg.shape:
            known = 1
            for d in cfg.shape:
                if d != -1:
                    known *= d
            if -1 not in cfg.shape and known != total:
                raise ValueError(f"Reshape: shape {cfg.shape} incompatible with {s}")
            out = tuple(total // known if d == -1 else d for d in cfg.shape)
        elif cfg.selected:
            out = (batch, len(cfg.selected_slots) * s[2])
            self.register_buffer("slots", torch.as_tensor(cfg.selected_slots, dtype=torch.int64,
                                                          device=device), persistent=False)
        elif cfg.time_step:
            out = (total // (self.leading * cfg.time_step), cfg.time_step, self.leading)
        else:
            out = (total // self.leading, self.leading)
        self.out_shapes = [out]

    def forward(self, ins, compute_dtype):
        x, cfg = ins[0], self.cfg
        if cfg.shape:
            return [x.reshape(cfg.shape)]
        if cfg.selected:
            return [x[:, self.slots, :].reshape(x.shape[0], -1)]
        if cfg.time_step:
            return [x.reshape(-1, cfg.time_step, self.leading)]
        return [x.reshape(-1, self.leading)]
