"""Dense network over named tensors (counterpart of
hugectr_tpu/layers/network.py: `Network` :41, `forward_with_loss` :188).

Layers run in add order over a dict of named tensors; each is an
`nn.Module` under its JAX layer name (`l{i}_{type}`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..core.config import DenseLayer, LOSS_LAYER_TYPES
from . import core_layers, gemm, interaction, losses  # noqa: F401 (registry)
from .base import LAYER_REGISTRY


@dataclasses.dataclass
class LossSpec:
    layer_name: str
    loss_type: str
    pred_name: str
    label_name: str
    weight: float = 1.0


class Network(nn.Module):
    def __init__(
        self,
        layers: List[DenseLayer],
        input_shapes: Dict[str, Tuple[int, ...]],
        generator: torch.Generator,
        device: torch.device,
        label_weights: Optional[Dict[str, float]] = None,
    ):
        super().__init__()
        self.configs = list(layers)
        self.layer_names: List[str] = []
        self.loss_specs: List[LossSpec] = []
        self.layers = nn.ModuleDict()
        shapes = dict(input_shapes)
        label_weights = label_weights or {}
        for i, cfg in enumerate(self.configs):
            name = f"l{i}_{cfg.layer_type}"
            cls = LAYER_REGISTRY.get(cfg.layer_type)
            if cls is None:
                raise NotImplementedError(f"layer type {cfg.layer_type} is not ported yet")
            if cfg.layer_type in LOSS_LAYER_TYPES and cfg.use_regularizer and cfg.lambda_:
                raise NotImplementedError("loss regularizers are not ported yet")
            for b in cfg.bottom_names:
                if b not in shapes:
                    raise ValueError(f"layer {name}: unknown bottom tensor {b!r}")
            layer = cls(cfg, [shapes[b] for b in cfg.bottom_names], generator, device)
            for t, s in zip(cfg.top_names, layer.out_shapes):
                shapes[t] = s
            self.layers[name] = layer
            self.layer_names.append(name)
            if cfg.layer_type in LOSS_LAYER_TYPES:
                self.loss_specs.append(
                    LossSpec(
                        layer_name=name,
                        loss_type=cfg.layer_type,
                        pred_name=cfg.bottom_names[0],
                        label_name=cfg.bottom_names[1],
                        weight=label_weights.get(cfg.bottom_names[1], 1.0),
                    )
                )
        self.tensor_shapes = shapes

    def param_tree(self) -> Dict[str, Dict[str, nn.Parameter]]:
        """{layer name: {param name: parameter}}, the JAX package's
        `dense_params` layout."""
        return {
            name: dict(layer.named_parameters())
            for name, layer in self.layers.items()
            if any(True for _ in layer.parameters())
        }

    def forward(
        self, tensors: Dict[str, torch.Tensor], compute_dtype: torch.dtype
    ) -> Dict[str, torch.Tensor]:
        tensors = dict(tensors)
        for name, cfg in zip(self.layer_names, self.configs):
            outs = self.layers[name]([tensors[b] for b in cfg.bottom_names], compute_dtype)
            for t, o in zip(cfg.top_names, outs):
                tensors[t] = o
        return tensors

    def predictions(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per loss layer, the sigmoid of its logits in float32, under its
        label's name: the eval predictions (network.py:204)."""
        return {
            spec.label_name: torch.sigmoid(tensors[spec.pred_name].float())
            for spec in self.loss_specs
        }

    def forward_with_loss(
        self, tensors: Dict[str, torch.Tensor], compute_dtype: torch.dtype
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Scalar loss: weighted sum of each loss layer's mean per-sample
        loss (network.py:172-201)."""
        out = self.forward(tensors, compute_dtype)
        total = torch.zeros((), dtype=torch.float32, device=next(iter(out.values())).device)
        for spec in self.loss_specs:
            cfg = self.configs[self.layer_names.index(spec.layer_name)]
            total = total + spec.weight * out[cfg.top_names[0]].float().mean()
        return total, out
