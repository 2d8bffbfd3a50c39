"""Fused MLP (counterpart of hugectr_tpu/layers/gemm.py `_mlp_apply` :95).

Each product takes its inputs and weights in the compute dtype and sums in
float32 into a float32 result (`preferred_element_type=f32`, gemm.py:34);
the bias is added in float32 and the layer's output is cast back to the
compute dtype. In float32 the GEMMs are `torch.addmm` / `torch.matmul` with
TF32 off. Under mixed precision (bf16) they run on the card's tensor cores
with float32 output (`torch.mm(..., out_dtype=torch.float32)`); on the CPU
the bf16 operands are widened to float32 first, which computes the same
sums. Parameters stay float32: autograd takes their gradients through the
casts.
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


def _mm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """a @ b of bf16-valued operands, float32 sums, `out_dtype` result."""
    if a.is_cuda:
        return torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16), out_dtype=out_dtype)
    return torch.mm(a.float(), b.float()).to(out_dtype)


class _MatmulF32(torch.autograd.Function):
    """[M, K] @ [K, N] of bf16 operands with a float32 result; the
    gradients take the operands' dtype (the JAX transpose rule of a dot with
    preferred_element_type)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm(a, b, torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = _mm(g, b.t(), a.dtype) if ctx.needs_input_grad[0] else None
        gb = _mm(a.t(), g, b.dtype) if ctx.needs_input_grad[1] else None
        return ga, gb


def dense(x: torch.Tensor, w: torch.Tensor, b, dtype: torch.dtype) -> torch.Tensor:
    """x @ w (+ b) in float32 from operands in `dtype` (gemm.py:34)."""
    if dtype == torch.float32:
        if b is None:
            return torch.matmul(x.float(), w)
        return torch.addmm(b, x.float(), w)
    y = _MatmulF32.apply(x.to(dtype), w.to(dtype))
    return y if b is None else y + b.float()


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
