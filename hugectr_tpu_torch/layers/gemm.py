"""InnerProduct, the fused MLP, FusedInnerProduct, MatrixMultiply and GRU
(counterparts of hugectr_tpu/layers/gemm.py `_ip_apply` :44-70,
`_mlp_apply` :95 and the layers below). The MLP's activations are ReLU,
Sigmoid, Tanh, ELU (alpha 1) and GELU (its tanh approximation, the
default of `jax.nn.gelu`), taken in float32.

Each product takes its inputs and weights in the compute dtype and sums in
float32 into a float32 result (`preferred_element_type=f32`, gemm.py:34);
the bias is added in float32 and the layer's output is cast back to the
compute dtype. In float32 the GEMMs are `torch.addmm` / `torch.matmul` with
TF32 off. Under mixed precision (bf16) they run on the card's tensor cores
with float32 output (`torch.mm(..., out_dtype=torch.float32)`); on the CPU
the bf16 operands are widened to float32 first, which computes the same
sums. Parameters stay float32: autograd takes their gradients through the
casts. InnerProduct takes [B, I] (or any [B, ...], flattened) to [B, O]
and [B, S, I] to [B, S, O], the same product on the [B S, I] rows; it
applies no activation (`act_type` is not read, as in the JAX package).

FusedInnerProduct (gemm.py:112-121) is InnerProduct then ReLU.
MatrixMultiply (gemm.py:125-153) takes [M, K] x [K, N], [B, M, K] x
[B, K, N] (`transpose_b`: [B, N, K]) or [B, M] x [M, G, H] to [B, G, H]:
operands in the compute dtype, float32 sums, the compute dtype out. GRU
(gemm.py:157-202) runs [B, S, V] sequences (any [B, S V] or [B S, V]
input) with gates stacked [z, r, n] on the last axis of `w` [V, 3H], `u`
[H, 3H], `bw` and `bu` [3H]: the input projection is one product for the
whole sequence, then a loop of S steps of one product each and the gates'
element-wise ops in float32, the hidden state cast to the compute dtype
after every step, as the JAX package's scan does; the output is the S
hidden states [B, S H]. cuDNN's GRU (`nn.GRU`) is not used: its gates are
ordered [r, z, n] and it rounds in its own way.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import DenseLayer
from ..core.types import Activation_t
from ..core.mesh import data_size
from .base import Layer, feature_size, make_initializer, register


def _act(kind: Activation_t, x: torch.Tensor) -> torch.Tensor:
    if kind == Activation_t.Relu:
        return torch.relu(x)
    if kind == Activation_t.Sigmoid:
        return torch.sigmoid(x)
    if kind == Activation_t.Tanh:
        return torch.tanh(x)
    if kind == Activation_t.Elu:
        return F.elu(x)
    if kind == Activation_t.Gelu:  # jax.nn.gelu's default: the tanh approximation
        return F.gelu(x, approximate="tanh")
    return x


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


@register("InnerProduct")
class InnerProduct(Layer):
    def __init__(self, cfg: DenseLayer, in_shapes, gen: torch.Generator, device):
        super().__init__()
        shape = in_shapes[0]
        fan_in = shape[-1] if len(shape) == 3 else feature_size(shape)
        fan_out = cfg.num_output
        w = make_initializer(cfg.weight_init_type, fan_in, fan_out)(gen, (fan_in, fan_out), device)
        self.weight = nn.Parameter(w)
        self.bias = None
        if cfg.use_bias:
            b = make_initializer(cfg.bias_init_type, fan_in, fan_out, is_bias=True)(gen, (fan_out,), device)
            self.bias = nn.Parameter(b)
        self.out_shapes = [(shape[0], shape[1], fan_out) if len(shape) == 3 else (shape[0], fan_out)]

    def forward(self, ins, compute_dtype):
        x = ins[0]
        lead = x.shape[:2] if x.dim() == 3 else x.shape[:1]
        y = dense(x.reshape(-1, x.shape[-1]) if x.dim() == 3 else x.reshape(x.shape[0], -1),
                  self.weight, self.bias, compute_dtype)
        return [y.reshape(*lead, -1).to(compute_dtype)]


@register("FusedInnerProduct")
class FusedInnerProduct(InnerProduct):
    def forward(self, ins, compute_dtype):
        return [torch.relu(super().forward(ins, compute_dtype)[0])]


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (batched or not) of compute-dtype operands with float32 sums:
    bf16 operands widened to float32 give the same products."""
    return torch.matmul(a.float(), b.float())


@register("MatrixMultiply")
class MatrixMultiply(Layer):
    def __init__(self, cfg: DenseLayer, in_shapes, gen, device):
        super().__init__()
        self.transpose_b = cfg.transpose_b
        a, b = in_shapes
        if len(a) == 2 and len(b) == 2:
            out = (a[0], b[1])
        elif len(a) == 3 and len(b) == 3:
            out = (a[0], a[1], b[2])  # the JAX package's shape, transpose_b or not
        elif len(a) == 2 and len(b) == 3:
            out = (a[0], b[1], b[2])
        else:
            raise ValueError(f"MatrixMultiply: unsupported ranks {a} x {b}")
        self.out_shapes = [out]

    def forward(self, ins, compute_dtype):
        a, b = (x.to(compute_dtype) for x in ins)
        if a.dim() == 3 and self.transpose_b:
            b = b.transpose(1, 2)
        if a.dim() == 2 and b.dim() == 3:  # "bm,mgh->bgh"
            y = _bmm(a, b.reshape(b.shape[0], -1)).reshape(a.shape[0], b.shape[1], b.shape[2])
        else:
            y = _bmm(a, b)
        return [y.to(compute_dtype)]


@register("GRU")
class GRU(Layer):
    def __init__(self, cfg: DenseLayer, in_shapes, gen: torch.Generator, device):
        super().__init__()
        v, h = cfg.vector_size, cfg.num_output
        self.seq, self.v, self.h = cfg.SeqLength, v, h
        w_init = make_initializer(cfg.weight_init_type, v, h)
        u_init = make_initializer(cfg.weight_init_type, h, h)
        b_init = make_initializer(cfg.bias_init_type, v, h, is_bias=True)
        self.w = nn.Parameter(w_init(gen, (v, 3 * h), device))
        self.u = nn.Parameter(u_init(gen, (h, 3 * h), device))
        self.bw = nn.Parameter(b_init(gen, (3 * h,), device))
        self.bu = nn.Parameter(b_init(gen, (3 * h,), device))
        # `batchsize` is the global batch; a rank holds its share
        batch = cfg.batchsize // data_size() if cfg.batchsize else in_shapes[0][0]
        self.out_shapes = [(batch, self.seq * h)]

    def forward(self, ins, compute_dtype):
        x = ins[0].reshape(-1, self.seq, self.v).to(compute_dtype)
        b, h = x.shape[0], self.h
        xw = dense(x.reshape(-1, self.v), self.w, self.bw, compute_dtype)
        xw = xw.reshape(b, self.seq, 3 * h).to(compute_dtype)
        state = torch.zeros((b, h), dtype=compute_dtype, device=x.device)
        outs = []
        for t in range(self.seq):
            hu = dense(state, self.u, self.bu, compute_dtype)
            xz, xr, xn = xw[:, t].float().split(h, dim=1)
            hz, hr, hn = hu.split(h, dim=1)
            z = torch.sigmoid(xz + hz)
            r = torch.sigmoid(xr + hr)
            n = torch.tanh(xn + r * hn)
            state = ((1.0 - z) * n + z * state.float()).to(compute_dtype)
            outs.append(state)
        return [torch.stack(outs, dim=1).reshape(b, -1)]
