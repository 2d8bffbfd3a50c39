"""DLRM Interaction, DCN MultiCross, FmOrder2 and MultiHeadAttention
(counterparts of hugectr_tpu/layers/interaction.py `_interaction_apply`
:20-52, `_mc_apply` :75, `_fm_apply` :102-116 and `_mha_apply` :120-154).

Interaction: [dense; embeddings] as X [B, F+1, E], the pairwise dots X Xᵀ
summed in float32 (a batched `torch.bmm`; the JAX package's einsum runs
outside any Pallas kernel), their strictly lower triangle in
`np.tril_indices` order, then [dense | dots | 0]: width E + F(F+1)/2 + 1.
A second top is an alias of the first (network.py:68).

MultiCross: x_{l+1} = x0 * (x_l W_l + b_l) + x_l, with W_l = U_l V_l for
DCNv2's low-rank projection, or x0 * (x_l . w_l) + b_l + x_l for DCNv1.

FmOrder2: 0.5 ((sum_i v_i)^2 - sum_i v_i^2) over the fields of
[B, fields * k], per latent dim k, in the compute dtype.

MultiHeadAttention over [B, S, D] projections: the heads split D, the
scores q kᵀ are float32 sums scaled by 1/sqrt(D/h), positions whose mask is
<= 0 take -10000 (not -inf: a fully masked row stays a uniform softmax, as
in the JAX package, where `scaled_dot_product_attention` would give NaN),
then softmax and the weighted sum of v. Products of compute-dtype operands
are taken in float32, which holds every bfloat16 product exactly.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.config import DenseLayer
from .base import Layer, make_initializer, register
from .gemm import dense


@register("Interaction")
class Interaction(Layer):
    def __init__(self, cfg: DenseLayer, in_shapes, gen: torch.Generator, device):
        super().__init__()
        (b, e), (_, f, e2) = in_shapes[0], in_shapes[1]
        if e != e2:
            raise ValueError(f"Interaction: dense dim {e} != emb dim {e2}")
        iu, ju = np.tril_indices(f + 1, k=-1)
        # flat positions of the strictly lower triangle in the [F+1, F+1] dots
        self.register_buffer("tri", torch.as_tensor(iu * (f + 1) + ju, dtype=torch.int64, device=device),
                             persistent=False)
        width = e + (f + 1) * f // 2 + 1
        self.out_shapes = [(b, width)] * len(cfg.top_names)

    def forward(self, ins, compute_dtype):
        d, emb = ins
        b = d.shape[0]
        x = torch.cat([d.unsqueeze(1), emb], dim=1).to(compute_dtype).float()
        dots = torch.bmm(x, x.transpose(1, 2)).reshape(b, -1)
        flat = dots.index_select(1, self.tri).to(compute_dtype)
        pad = torch.zeros((b, 1), dtype=compute_dtype, device=d.device)
        out = torch.cat([d.to(compute_dtype), flat, pad], dim=1)
        return [out] * len(self.out_shapes)


@register("MultiCross")
class MultiCross(Layer):
    def __init__(self, cfg: DenseLayer, in_shapes, gen: torch.Generator, device):
        super().__init__()
        n = in_shapes[0][-1]
        self.k = cfg.projection_dim
        self.num_layers = cfg.num_layers
        for i in range(cfg.num_layers):
            if self.k and self.k > 0:
                u = make_initializer(cfg.weight_init_type, n, self.k)(gen, (n, self.k), device)
                v = make_initializer(cfg.weight_init_type, self.k, n)(gen, (self.k, n), device)
                self.register_parameter(f"U_{i}", nn.Parameter(u))
                self.register_parameter(f"V_{i}", nn.Parameter(v))
            else:
                w = make_initializer(cfg.weight_init_type, n, 1)(gen, (n,), device)
                self.register_parameter(f"w_{i}", nn.Parameter(w))
            b = make_initializer(cfg.bias_init_type, n, n, is_bias=True)(gen, (n,), device)
            self.register_parameter(f"b_{i}", nn.Parameter(b))
        self.out_shapes = [in_shapes[0]]

    def forward(self, ins, compute_dtype):
        x0 = ins[0].to(compute_dtype)
        x = x0
        for i in range(self.num_layers):
            b = getattr(self, f"b_{i}")
            if self.k and self.k > 0:
                xv = dense(x, getattr(self, f"U_{i}"), None, compute_dtype).to(compute_dtype)
                wx = dense(xv, getattr(self, f"V_{i}"), b, compute_dtype)
                x = (x0 * wx.to(compute_dtype) + x).to(compute_dtype)
            else:
                xw = torch.matmul(x, getattr(self, f"w_{i}").to(compute_dtype)).float()
                x = (x0 * xw.unsqueeze(1).to(compute_dtype) + b.to(compute_dtype) + x).to(compute_dtype)
        return [x]


@register("FmOrder2")
class FmOrder2(Layer):
    def __init__(self, cfg: DenseLayer, in_shapes, gen, device):
        super().__init__()
        self.k = cfg.out_dim
        self.out_shapes = [(in_shapes[0][0], cfg.out_dim)]

    def forward(self, ins, compute_dtype):
        x = ins[0].to(compute_dtype)
        v = x.reshape(x.shape[0], -1, self.k)
        s = v.sum(dim=1)
        return [0.5 * (s * s - (v * v).sum(dim=1))]


@register("MultiHeadAttention")
class MultiHeadAttention(Layer):
    def __init__(self, cfg: DenseLayer, in_shapes, gen, device):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.out_shapes = [in_shapes[0]]

    def forward(self, ins, compute_dtype):
        q, k, v = (x.to(compute_dtype) for x in ins[:3])
        b, sf, d = q.shape
        st, h = k.shape[1], self.heads
        dk = d // h

        def split(x, s):
            return x.reshape(b, s, h, dk).permute(0, 2, 1, 3).float()  # [B, h, S, dk]

        qh, kh, vh = split(q, sf), split(k, st), split(v, st)
        scores = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / np.sqrt(dk))
        if len(ins) > 3:
            scores = torch.where(ins[3] > 0, scores, -10000.0)
        probs = torch.softmax(scores, dim=-1).to(compute_dtype)
        out = torch.matmul(probs.float(), vh).to(compute_dtype)
        return [out.permute(0, 2, 1, 3).reshape(b, sf, d)]
