"""Layer registry and initializers (counterpart of hugectr_tpu/layers/base.py).

Each layer type is an `nn.Module` built from `(cfg, in_shapes, generator,
device)`; it records `out_shapes` and maps a list of input tensors to a list
of outputs. Parameters keep the JAX package's names and layouts (an MLP's
`weight_i` is [fan_in, fan_out]), so state carries across unchanged.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from ..core.types import Initializer_t

Shape = Tuple[int, ...]

LAYER_REGISTRY: Dict[str, type] = {}


def register(layer_type: str) -> Callable[[type], type]:
    """Class decorator: map a `Layer_t` name to its module (base.py:54)."""

    def deco(cls: type) -> type:
        LAYER_REGISTRY[layer_type] = cls
        return cls

    return deco


def make_initializer(kind: Initializer_t, fan_in: int, fan_out: int, is_bias: bool = False):
    """Init schemes of base.py:76: Default is Xavier-uniform weights and
    zero biases. Returns fn(generator, shape, device) -> tensor."""
    kind = Initializer_t(kind)

    def fn(gen: torch.Generator, shape: Shape, device) -> torch.Tensor:
        t = torch.empty(shape, dtype=torch.float32, device=device)
        if kind == Initializer_t.Zero or (kind == Initializer_t.Default and is_bias):
            return t.zero_()
        if kind in (Initializer_t.Default, Initializer_t.XavierUniform):
            limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
            return t.uniform_(-limit, limit, generator=gen)
        if kind == Initializer_t.Uniform:
            limit = float(np.sqrt(1.0 / max(fan_in, 1)))
            return t.uniform_(-limit, limit, generator=gen)
        if kind == Initializer_t.XavierNorm:
            return t.normal_(0.0, float(np.sqrt(2.0 / (fan_in + fan_out))), generator=gen)
        raise ValueError(kind)

    return fn


def feature_size(shape: Shape) -> int:
    """Product of the non-batch dims."""
    n = 1
    for d in shape[1:]:
        n *= d
    return n


class Layer(nn.Module):
    """Base of the dense layers: `out_shapes` and `forward(ins, dtype)`."""

    out_shapes: List[Shape]

    def forward(self, ins: List[torch.Tensor], compute_dtype: torch.dtype) -> List[torch.Tensor]:
        raise NotImplementedError
