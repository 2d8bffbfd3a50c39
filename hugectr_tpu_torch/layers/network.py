"""Dense network over named tensors (counterpart of
hugectr_tpu/layers/network.py: `Network` :41, `forward_with_loss` :188).

Layers run in add order over a dict of named tensors; each is an
`nn.Module` under its JAX layer name (`l{i}_{type}`). An Interaction's
second top is an alias of its first; an MLP given both reads it once
(network.py:62-99). The module's training mode (`train()` / `eval()`) is
the JAX package's `LayerCtx.training`: Dropout drops only in training,
and BatchNorm updates its running statistics only in training. The loss
adds, once per loss layer that asks for it, the layer's regularizer over
every dense parameter with the global batch `batch_size`
(network.py:171-186). `state_tree` gives the layers' buffers
(BatchNorm's running statistics) in the layout of the JAX package's
`net_state`.

`skip_tops` (the SKIP_DENSE_LAYERS ablation, network.py:139-165, which
the Model sets when it builds its step): a layer all of whose tops are in
it yields zeros of its outputs' shapes (the rank's rows) in the compute
dtype and calls no forward: the JAX package computes and drops, and XLA
removes the work; eager PyTorch would launch it. A skipped layer that
keeps state (BatchNorm) still updates it in training, as the JAX package
keeps its new state, and its output is dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..core.config import DenseLayer, LOSS_LAYER_TYPES, Layer_t
from ..core.mesh import data_size
from . import core_layers, gemm, interaction, losses  # noqa: F401 (registry)
from .base import LAYER_REGISTRY
from .losses import regularizer_term


@dataclasses.dataclass
class LossSpec:
    layer_name: str
    loss_type: str
    pred_name: str
    label_name: str
    weight: float = 1.0
    use_regularizer: bool = False
    regularizer_type: object = None
    lam: float = 0.0


class Network(nn.Module):
    def __init__(
        self,
        layers: List[DenseLayer],
        input_shapes: Dict[str, Tuple[int, ...]],
        generator: torch.Generator,
        device: torch.device,
        label_weights: Optional[Dict[str, float]] = None,
        batch_size: int = 0,
    ):
        super().__init__()
        self.configs = list(layers)
        # the global batch: the rank's rows times the ranks
        self.batch_size = batch_size or next(iter(input_shapes.values()))[0] * data_size()
        self.layer_names: List[str] = []
        self.loss_specs: List[LossSpec] = []
        self.aliases: Dict[str, str] = {}  # alias top -> real top
        self.bottoms: List[List[str]] = []  # each layer's, aliases resolved
        self.layers = nn.ModuleDict()
        shapes = dict(input_shapes)
        label_weights = label_weights or {}
        for i, cfg in enumerate(self.configs):
            name = f"l{i}_{cfg.layer_type}"
            cls = LAYER_REGISTRY.get(cfg.layer_type)
            if cls is None:
                raise NotImplementedError(f"layer type {cfg.layer_type}")
            if cfg.layer_type == Layer_t.Interaction and len(cfg.top_names) > 1:
                self.aliases[cfg.top_names[1]] = cfg.top_names[0]
            bottoms = self._bottoms(cfg)
            for b in bottoms:
                if b not in shapes:
                    raise ValueError(f"layer {name}: unknown bottom tensor {b!r}")
            layer = cls(cfg, [shapes[b] for b in bottoms], generator, device)
            for t, s in zip(cfg.top_names, layer.out_shapes):
                shapes[t] = s
            self.layers[name] = layer
            self.layer_names.append(name)
            self.bottoms.append(bottoms)
            if cfg.layer_type in LOSS_LAYER_TYPES:
                self.loss_specs.append(
                    LossSpec(
                        layer_name=name,
                        loss_type=cfg.layer_type,
                        pred_name=self.aliases.get(cfg.bottom_names[0], cfg.bottom_names[0]),
                        label_name=cfg.bottom_names[1],
                        weight=label_weights.get(cfg.bottom_names[1], 1.0),
                        use_regularizer=cfg.use_regularizer,
                        regularizer_type=cfg.regularizer_type,
                        lam=cfg.lambda_,
                    )
                )
        self.tensor_shapes = shapes
        self.skip_tops: set = set()

    def _bottoms(self, cfg: DenseLayer) -> List[str]:
        """The bottoms with aliases resolved; an MLP reads a repeated
        bottom once (network.py:88)."""
        out: List[str] = []
        for b in (self.aliases.get(b, b) for b in cfg.bottom_names):
            if not (b in out and cfg.layer_type == Layer_t.MLP):
                out.append(b)
        return out

    def param_tree(self) -> Dict[str, Dict[str, nn.Parameter]]:
        """{layer name: {param name: parameter}}, the JAX package's
        `dense_params` layout."""
        return {
            name: dict(layer.named_parameters())
            for name, layer in self.layers.items()
            if any(True for _ in layer.parameters())
        }

    def state_tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{layer name: {buffer name: tensor}} of the layers that keep state
        (BatchNorm), the JAX package's `net_state` layout."""
        return {
            name: {k: getattr(layer, k) for k in layer.state_keys}
            for name, layer in self.layers.items()
            if getattr(layer, "state_keys", ())
        }

    def forward(
        self, tensors: Dict[str, torch.Tensor], compute_dtype: torch.dtype
    ) -> Dict[str, torch.Tensor]:
        tensors = dict(tensors)
        for name, cfg, bottoms in zip(self.layer_names, self.configs, self.bottoms):
            ins = [tensors[b] for b in bottoms]
            if self.skip_tops and all(t in self.skip_tops for t in cfg.top_names):
                outs = self._skipped(self.layers[name], cfg, bottoms, ins, compute_dtype)
            else:
                outs = self.layers[name](ins, compute_dtype)
            for t, o in zip(cfg.top_names, outs):
                tensors[t] = o
        return tensors

    def _skipped(self, layer, cfg: DenseLayer, bottoms, ins, compute_dtype) -> List[torch.Tensor]:
        """A skipped layer's outputs: zeros of its tops' shapes, the leading
        dimension scaled to this batch's rows (an eval batch may differ from
        the train batch the shapes were made for)."""
        if self.training and getattr(layer, "state_keys", ()):
            with torch.no_grad():
                layer(ins, compute_dtype)  # its state update; the output is dropped
        rows, built = ins[0].shape[0], self.tensor_shapes[bottoms[0]][0]
        return [
            torch.zeros((self.tensor_shapes[t][0] * rows // built, *self.tensor_shapes[t][1:]),
                        dtype=compute_dtype, device=ins[0].device)
            for t in cfg.top_names
        ]

    def summary_rows(self) -> List[Tuple[str, str, str, str]]:
        """Per layer: type, bottoms, tops and shapes (network.py:216)."""
        rows = []
        for cfg in self.configs:
            in_s = ",".join(str(self.tensor_shapes.get(b)) for b in cfg.bottom_names)
            out_s = ",".join(str(self.tensor_shapes.get(t)) for t in cfg.top_names)
            rows.append((cfg.layer_type, ";".join(cfg.bottom_names), ";".join(cfg.top_names), f"{in_s} -> {out_s}"))
        return rows

    def predictions(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per loss layer, under its label's name, the eval predictions in
        float32 (network.py:204): the sigmoid of its logits, or for a
        CrossEntropyLoss the softmax's first class."""
        out = {}
        for spec in self.loss_specs:
            logits = tensors[spec.pred_name].float()
            if spec.loss_type == Layer_t.CrossEntropyLoss:
                out[spec.label_name] = torch.softmax(logits, dim=-1)[..., :1]
            else:
                out[spec.label_name] = torch.sigmoid(logits)
        return out

    def forward_with_loss(
        self, tensors: Dict[str, torch.Tensor], compute_dtype: torch.dtype
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Scalar loss: weighted sum of each loss layer's mean per-sample
        loss, plus each asking loss layer's regularizer over every dense
        parameter, in the JAX tree's order (network.py:172-201)."""
        out = self.forward(tensors, compute_dtype)
        total = torch.zeros((), dtype=torch.float32, device=next(iter(out.values())).device)
        for spec in self.loss_specs:
            cfg = self.configs[self.layer_names.index(spec.layer_name)]
            total = total + spec.weight * out[cfg.top_names[0]].float().mean()
            if spec.use_regularizer and spec.lam:
                tree = self.param_tree()
                leaves = [tree[layer][k] for layer in sorted(tree) for k in sorted(tree[layer])]
                total = total + regularizer_term(spec.regularizer_type, spec.lam, self.batch_size, leaves)
        return total, out
