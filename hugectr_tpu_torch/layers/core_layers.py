"""Plumbing, activation and normalization layers (counterparts of
hugectr_tpu/layers/core_layers.py): ReLU :31, Sigmoid :32, ELU :33, Cast
:43, Softmax :48-57, MaskedSoftmax :62-70, PReLU_Dice :76-84, Dropout
:88-97, Reshape :101-144, Select :148-158, Slice :162-172, Concat :183,
Add / Sub / ElementwiseMultiply :191-200, ReduceSum / ReduceMean :206-222,
Scale :227-247, Gather :251-260, FusedReshapeConcat :264-278,
FusedReshapeConcatGeneral :281-292, SequenceMask :296-310, BatchNorm
:314-353, LayerNorm :357-373 and WeightMultiply :377-391.

Each keeps the JAX function's dtypes: elementwise layers compute in their
inputs' dtype, LayerNorm's statistics are float32, SequenceMask and
WeightMultiply give the compute dtype.

Over W ranks every layer works on the rank's rows, and four see the
batch as a whole. PReLU_Dice and BatchNorm take their mean and variance
over the global batch, as the JAX mesh does over its sharded batch axis:
each rank all-reduces its sum, then its sum of squared deviations from the
global mean (`core/mesh.py::all_reduce_autograd`, whose backward
all-reduces the gradient, so the backward is global too). Dropout's mask
is a function of the layer's key, the global step and each element's
index in the global batch, so W ranks drop what one device drops.
Gather picks rows of the global batch: each rank puts its rows into a
zero [W n, ...] tensor, all-reduces it and keeps its block of the picked
rows, so rank r holds rows [r K / W, (r + 1) K / W) of the JAX package's
[K, ...] output.

BatchNorm's running statistics are buffers (`running_mean`, zeros, and
`running_var`, ones: the JAX package's `net_state`). In training it
normalises with the batch's float32 mean and population variance and
updates them as running (1 - factor) + batch factor; in eval it
normalises with them. gamma is ones for the Default initializer, else
drawn with fan-in = fan-out = the width; beta is drawn as a bias.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import DenseLayer
from ..core.mesh import all_reduce_autograd, data_rank, data_size
from ..core.types import Initializer_t
from ..ops import dropout
from .base import Layer, make_initializer, register


class _SameShape(Layer):
    """A stateless layer whose output has its first input's shape."""

    def __init__(self, cfg: DenseLayer, in_shapes, gen, device):
        super().__init__()
        self.cfg = cfg
        self.out_shapes = [in_shapes[0]]


@register("ReLU")
class ReLU(_SameShape):
    def forward(self, ins, compute_dtype):
        return [torch.relu(ins[0])]


@register("Softmax")
class Softmax(_SameShape):
    """Softmax over the last axis; a second input is a 0/1 mask and masked
    positions take -10000 first."""

    def forward(self, ins, compute_dtype):
        x = ins[0]
        if len(ins) > 1:
            x = torch.where(ins[1] > 0, x, -10000.0)
        return [torch.softmax(x, dim=-1)]


@register("PReLU_Dice")
class PReLUDice(_SameShape):
    """p = sigmoid((x - E[x]) / sqrt(Var[x] + eps)) over the batch axis,
    out = p x + (1 - p) alpha x. The statistics are summed in float32 and
    taken in the input's dtype, as jnp.mean / jnp.var of it give them."""

    def forward(self, ins, compute_dtype):
        x = ins[0]
        xf = x.float()
        n = x.shape[0] * data_size()
        mean = all_reduce_autograd(xf.sum(dim=0, keepdim=True)) / n
        var = all_reduce_autograd(((xf - mean) ** 2).sum(dim=0, keepdim=True)) / n
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        p = torch.sigmoid((x - mean) * torch.rsqrt(var + self.cfg.eps))
        return [p * x + (1.0 - p) * self.cfg.elu_alpha * x]


@register("Dropout")
class Dropout(_SameShape):
    """Training only: zero with probability `dropout_rate`, scale the rest
    by 1 / (1 - rate); identity in eval. The mask is a function of the
    layer's key (drawn from the model's generator when the layer is built)
    and the global step (`ops/dropout.py`), as the JAX package's is of
    `fold_in(rng, step)`: the step is the model's device scalar once the
    model binds it (`bind_step`), which it fills before each step, so a
    captured step replays with the step it runs; a layer on its own counts
    its training calls. Each rank draws its rows of the global batch's
    mask (the elements' global indices), so W ranks drop what one device
    drops."""

    def __init__(self, cfg: DenseLayer, in_shapes, gen: torch.Generator, device):
        super().__init__(cfg, in_shapes, gen, device)
        seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device))
        self.key = dropout.key_of(seed)
        self.step = torch.zeros((), dtype=torch.int64, device=device)
        self._own_step = True

    def bind_step(self, step: torch.Tensor) -> None:
        """Draw the masks of the global step that `step` (a 0-dim int64 on
        the layer's device) holds."""
        self.step, self._own_step = step, False

    def forward(self, ins, compute_dtype):
        x = ins[0]
        rate = self.cfg.dropout_rate
        if not self.training or rate <= 0.0:
            return [x]
        keep = 1.0 - rate
        if self._own_step:
            self.step.add_(1)
        mask = dropout.dropout_mask(self.key, self.step, x.numel(), data_rank() * x.numel(), keep)
        return [torch.where(mask.view(x.shape), x / keep, x.new_zeros(())).to(x.dtype)]


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


@register("Slice")
class Slice(Layer):
    """Columns [a, b) of the last axis, one top per range."""

    def __init__(self, cfg: DenseLayer, in_shapes, gen, device):
        super().__init__()
        self.ranges = [tuple(r) for r in cfg.ranges]
        s = in_shapes[0]
        self.out_shapes = [s[:-1] + (b - a,) for a, b in self.ranges]

    def forward(self, ins, compute_dtype):
        return [ins[0][..., a:b] for a, b in self.ranges]


@register("Add")
class Add(_SameShape):
    def forward(self, ins, compute_dtype):
        out = ins[0]
        for t in ins[1:]:
            out = out + t
        return [out]


@register("Sub")
class Sub(_SameShape):
    def forward(self, ins, compute_dtype):
        return [ins[0] - ins[1]]


@register("ElementwiseMultiply")
class ElementwiseMultiply(_SameShape):
    def forward(self, ins, compute_dtype):
        return [ins[0] * ins[1]]


class _Reduce(Layer):
    def __init__(self, cfg: DenseLayer, in_shapes, gen, device):
        super().__init__()
        self.axis = cfg.axis
        s = list(in_shapes[0])
        s[self.axis] = 1
        self.out_shapes = [tuple(s)]


@register("ReduceSum")
class ReduceSum(_Reduce):
    def forward(self, ins, compute_dtype):
        return [ins[0].sum(dim=self.axis, keepdim=True)]


@register("ReduceMean")
class ReduceMean(_Reduce):
    def forward(self, ins, compute_dtype):
        return [ins[0].mean(dim=self.axis, keepdim=True)]


@register("Scale")
class Scale(Layer):
    """[B, N] upscaled by `factor`: axis 0 repeats each element f times in
    place ([B, N f]), any other axis repeats each row f times ([B f, N])."""

    def __init__(self, cfg: DenseLayer, in_shapes, gen, device):
        super().__init__()
        b, n = in_shapes[0]
        self.f = int(cfg.factor)
        self.dim = 1 if cfg.axis == 0 else 0
        self.out_shapes = [(b, n * self.f) if self.dim == 1 else (b * self.f, n)]

    def forward(self, ins, compute_dtype):
        return [ins[0].repeat_interleave(self.f, dim=self.dim)]


@register("FusedReshapeConcat")
class FusedReshapeConcat(Layer):
    """Inputs [B, F + 1, E_i] concatenated on the last axis: the first F
    steps as [B F, sum E] (history) and the last one as [B, sum E] (item)."""

    def __init__(self, cfg: DenseLayer, in_shapes, gen, device):
        super().__init__()
        b, f1, _ = in_shapes[0]
        tot = sum(s[2] for s in in_shapes)
        self.out_shapes = [(b * (f1 - 1), tot), (b, tot)]

    def forward(self, ins, compute_dtype):
        x = torch.cat(ins, dim=2)
        return [x[:, :-1, :].reshape(-1, x.shape[2]), x[:, -1, :]]


@register("SequenceMask")
class SequenceMask(Layer):
    """[B, 1, from, to] mask: (i < len_from) & (j < len_to), lengths cut to
    int32 by truncation, in the compute dtype."""

    def __init__(self, cfg: DenseLayer, in_shapes, gen, device):
        super().__init__()
        self.n_from, self.n_to = cfg.max_sequence_len_from, cfg.max_sequence_len_to
        self.out_shapes = [(in_shapes[0][0], 1, self.n_from, self.n_to)]

    def forward(self, ins, compute_dtype):
        len_from = ins[0].reshape(-1).to(torch.int32)
        len_to = ins[1].reshape(-1).to(torch.int32)
        dev = len_from.device
        i = torch.arange(self.n_from, device=dev)[None, :, None]
        j = torch.arange(self.n_to, device=dev)[None, None, :]
        mask = (i < len_from[:, None, None]) & (j < len_to[:, None, None])
        return [mask[:, None, :, :].to(compute_dtype)]


@register("LayerNorm")
class LayerNorm(_SameShape):
    """Normalised over the last axis with float32 statistics, then gamma
    (ones) and beta (zeros); the output takes the input's dtype."""

    def __init__(self, cfg: DenseLayer, in_shapes, gen, device):
        super().__init__(cfg, in_shapes, gen, device)
        n = in_shapes[0][-1]
        self.gamma = nn.Parameter(torch.ones((n,), dtype=torch.float32, device=device))
        self.beta = nn.Parameter(torch.zeros((n,), dtype=torch.float32, device=device))

    def forward(self, ins, compute_dtype):
        x = ins[0]
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.cfg.eps)
        return [(y * self.gamma + self.beta).to(x.dtype)]


@register("WeightMultiply")
class WeightMultiply(Layer):
    """[B, slot] x weight [slot, vec] -> [B, slot vec]: each input element
    times its row of weights, in the compute dtype."""

    def __init__(self, cfg: DenseLayer, in_shapes, gen: torch.Generator, device):
        super().__init__()
        slot, vec = cfg.weight_dims
        w = make_initializer(cfg.weight_init_type, slot, vec)(gen, (slot, vec), device)
        self.weight = nn.Parameter(w)
        self.out_shapes = [(in_shapes[0][0], slot * vec)]

    def forward(self, ins, compute_dtype):
        x = ins[0].to(compute_dtype)
        out = x[:, :, None] * self.weight.to(compute_dtype)[None, :, :]
        return [out.reshape(x.shape[0], -1)]


@register("Sigmoid")
class Sigmoid(_SameShape):
    def forward(self, ins, compute_dtype):
        return [torch.sigmoid(ins[0])]


@register("ELU")
class ELU(_SameShape):
    def forward(self, ins, compute_dtype):
        return [F.elu(ins[0], alpha=self.cfg.elu_alpha)]


@register("Cast")
class Cast(_SameShape):
    """To the compute dtype (bfloat16 under mixed precision, else float32)."""

    def forward(self, ins, compute_dtype):
        return [ins[0].to(compute_dtype)]


@register("MaskedSoftmax")
class MaskedSoftmax(_SameShape):
    """Scaled by `factor` (1 where it is 0) in the input's dtype, -10000
    where the mask (second input) is <= 0, then softmax over the last axis."""

    def forward(self, ins, compute_dtype):
        x, mask = ins
        x = x * torch.tensor(self.cfg.factor or 1.0, dtype=x.dtype, device=x.device)
        x = torch.where(mask > 0, x, x.new_tensor(-10000.0))
        return [torch.softmax(x, dim=-1)]


@register("Select")
class Select(Layer):
    """Entries `index` of axis `dim`, in that order."""

    def __init__(self, cfg: DenseLayer, in_shapes, gen, device):
        super().__init__()
        self.dim = cfg.dim
        self.register_buffer("index", torch.as_tensor(cfg.index, dtype=torch.int64, device=device),
                             persistent=False)
        s = list(in_shapes[0])
        s[cfg.dim] = len(cfg.index)
        self.out_shapes = [tuple(s)]

    def forward(self, ins, compute_dtype):
        return [torch.index_select(ins[0], self.dim, self.index)]


@register("Gather")
class Gather(Layer):
    """Rows `indices` of the global batch; over W ranks each rank keeps its
    block of them (K = len(indices) must split over the ranks)."""

    def __init__(self, cfg: DenseLayer, in_shapes, gen, device):
        super().__init__()
        k, w = len(cfg.indices), data_size()
        if k % w:
            raise ValueError(f"Gather: {k} indices do not split over {w} ranks")
        mine = cfg.indices[data_rank() * (k // w) : (data_rank() + 1) * (k // w)]
        self.register_buffer("indices", torch.as_tensor(mine, dtype=torch.int64, device=device), persistent=False)
        self.out_shapes = [(k // w,) + tuple(in_shapes[0][1:])]

    def forward(self, ins, compute_dtype):
        x = ins[0]
        w = data_size()
        if w > 1:
            n = x.shape[0]
            full = x.new_zeros((w * n, *x.shape[1:]))
            full = full.index_copy(0, torch.arange(data_rank() * n, (data_rank() + 1) * n, device=x.device), x)
            x = all_reduce_autograd(full)
        return [x[self.indices]]


@register("FusedReshapeConcatGeneral")
class FusedReshapeConcatGeneral(Layer):
    """Inputs [B, F, E_i] concatenated on the last axis, as [B F, sum E]."""

    def __init__(self, cfg: DenseLayer, in_shapes, gen, device):
        super().__init__()
        b, f, _ = in_shapes[0]
        self.out_shapes = [(b * f, sum(s[2] for s in in_shapes))]

    def forward(self, ins, compute_dtype):
        x = torch.cat(ins, dim=2)
        return [x.reshape(-1, x.shape[2])]


@register("BatchNorm")
class BatchNorm(_SameShape):
    state_keys = ("running_mean", "running_var")

    def __init__(self, cfg: DenseLayer, in_shapes, gen: torch.Generator, device):
        super().__init__(cfg, in_shapes, gen, device)
        n = in_shapes[0][-1]
        gamma = (torch.ones((n,), dtype=torch.float32, device=device)
                 if Initializer_t(cfg.gamma_init_type) == Initializer_t.Default
                 else make_initializer(cfg.gamma_init_type, n, n)(gen, (n,), device))
        self.gamma = nn.Parameter(gamma)
        self.beta = nn.Parameter(make_initializer(cfg.beta_init_type, n, n, is_bias=True)(gen, (n,), device))
        self.register_buffer("running_mean", torch.zeros((n,), dtype=torch.float32, device=device))
        self.register_buffer("running_var", torch.ones((n,), dtype=torch.float32, device=device))

    def forward(self, ins, compute_dtype):
        x = ins[0]
        xf = x.float()
        f = self.cfg.factor
        if self.training:
            n = x.shape[0] * data_size()
            mean = all_reduce_autograd(xf.sum(dim=0)) / n
            var = all_reduce_autograd(((xf - mean) ** 2).sum(dim=0)) / n
            with torch.no_grad():
                self.running_mean.copy_(self.running_mean * (1 - f) + mean * f)
                self.running_var.copy_(self.running_var * (1 - f) + var * f)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.cfg.eps)
        return [(y * self.gamma + self.beta).to(x.dtype)]
