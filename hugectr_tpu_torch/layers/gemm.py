"""Fused MLP (counterpart of hugectr_tpu/layers/gemm.py `_mlp_apply` :95).

GEMMs stay `torch.addmm` / `torch.matmul`, as the JAX package leaves them to
XLA; with TF32 off they run in full fp32.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.config import DenseLayer
from ..core.types import Activation_t
from .base import Layer, feature_size, make_initializer, register


def _act(kind: Activation_t, x: torch.Tensor) -> torch.Tensor:
    if kind == Activation_t.Relu:
        return torch.relu(x)
    if kind == Activation_t.Sigmoid:
        return torch.sigmoid(x)
    if kind == Activation_t.Tanh:
        return torch.tanh(x)
    if kind == Activation_t.NonE:
        return x
    raise NotImplementedError(f"activation {kind.value} is not ported yet")


def dense(x: torch.Tensor, w: torch.Tensor, b, dtype: torch.dtype) -> torch.Tensor:
    """x @ w (+ b), accumulated in fp32 (gemm.py:34)."""
    if b is None:
        return torch.matmul(x.to(dtype), w.to(dtype)).float()
    return torch.addmm(b.float(), x.to(dtype), w.to(dtype)).float()


@register("MLP")
class MLP(Layer):
    def __init__(self, cfg: DenseLayer, in_shapes, gen: torch.Generator, device):
        super().__init__()
        n = len(cfg.num_outputs)
        acts = cfg.activations or [cfg.act_type] * n
        biases = cfg.biases or [cfg.use_bias] * n
        self.specs = list(zip(cfg.num_outputs, acts, biases))
        fan_in = sum(feature_size(s) for s in in_shapes)
        for i, (fan_out, _act_i, use_b) in enumerate(self.specs):
            w = make_initializer(cfg.weight_init_type, fan_in, fan_out)(gen, (fan_in, fan_out), device)
            self.register_parameter(f"weight_{i}", nn.Parameter(w))
            if use_b:
                b = make_initializer(cfg.bias_init_type, fan_in, fan_out, is_bias=True)(
                    gen, (fan_out,), device
                )
                self.register_parameter(f"bias_{i}", nn.Parameter(b))
            fan_in = fan_out
        self.out_shapes = [(in_shapes[0][0], cfg.num_outputs[-1])]

    def forward(self, ins, compute_dtype):
        xs = [x.reshape(x.shape[0], -1) for x in ins]
        x = xs[0] if len(xs) == 1 else torch.cat(xs, dim=1)
        for i, (_n, act_i, use_b) in enumerate(self.specs):
            b = getattr(self, f"bias_{i}") if use_b else None
            x = _act(act_i, dense(x, getattr(self, f"weight_{i}"), b, compute_dtype))
            x = x.to(compute_dtype)
        return [x]
