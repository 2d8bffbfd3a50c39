"""User-facing configuration objects (counterpart of hugectr_tpu/core/config.py).

`Solver` keeps the embedding engine settings as fields with the JAX
package's defaults (config.py:24-139). Nothing here reads the environment:
the JAX package exports these fields to HCTR_TPU_* variables around
`compile`; the port hands them to the plan and the collection directly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from .types import Activation_t, DataReaderType_t, Initializer_t, Regularizer_t


@dataclasses.dataclass
class Solver:
    """Global training settings (config.py:24)."""

    seed: int = 0
    lr: float = 0.001
    warmup_steps: int = 1
    decay_start: int = 0
    decay_steps: int = 1
    decay_power: float = 2.0
    end_lr: float = 0.0
    batchsize: int = 2048
    # accepted so that reference scripts fail loudly: not ported yet
    use_mixed_precision: bool = False
    i64_input_key: bool = False
    embedding_vec_dtype: str = "float32"
    # ---- embedding engine settings (JAX: HCTR_TPU_* environment knobs)
    # small static sum/mean tables at or below this vocab take the one-hot
    # engine (plan.py:486 onehot_vocab_threshold); 0 turns it off
    onehot_vocab: int = 8192
    # rowop tables at or above this vocab get a storage group of their own
    # (plan.py:457 split_vocab_threshold); 0 turns it off
    split_vocab: int = 256 * 1024
    # shards of at most this many rows update by the dense sweep
    # (sparse_optimizer.py:176 dense_update_rows); 0 turns it off
    dense_update_rows: int = 262144
    # bigger shards take the dense sweep too when keys >= ratio * rows
    # (sparse_optimizer.py:188 dense_key_ratio); 0 turns it off
    dense_key_ratio: float = 0.3

    @property
    def compute_dtype(self):
        import torch

        return torch.bfloat16 if self.use_mixed_precision else torch.float32


@dataclasses.dataclass
class DataReaderParams:
    """Dataset declaration (config.py:240). This slice reads synthetic
    batches only."""

    data_reader_type: DataReaderType_t = DataReaderType_t.Synthetic
    synthetic_num_batches: int = 64
    synthetic_alpha: float = 0.0

    def __post_init__(self):
        self.data_reader_type = DataReaderType_t(self.data_reader_type)


@dataclasses.dataclass
class DataReaderSparseParam:
    """One sparse input feature (config.py:286)."""

    top_name: str
    nnz_per_slot: Any = 1
    is_fixed_length: bool = True
    slot_num: int = 1

    def per_slot_nnz(self) -> List[int]:
        if isinstance(self.nnz_per_slot, int):
            return [self.nnz_per_slot] * self.slot_num
        if len(self.nnz_per_slot) != self.slot_num:
            raise ValueError(f"{self.top_name}: len(nnz_per_slot) != slot_num")
        return list(self.nnz_per_slot)


@dataclasses.dataclass
class Input:
    """Input layer declaration (config.py:310)."""

    label_dim: Any = 1
    label_name: Any = "label"
    dense_dim: int = 13
    dense_name: str = "dense"
    data_reader_sparse_param_array: List[DataReaderSparseParam] = dataclasses.field(
        default_factory=list
    )
    label_weights: Optional[Dict[str, float]] = None

    def label_dims(self) -> List[int]:
        return self.label_dim if isinstance(self.label_dim, list) else [self.label_dim]

    def label_names(self) -> List[str]:
        return self.label_name if isinstance(self.label_name, list) else [self.label_name]


@dataclasses.dataclass
class DenseLayer:
    """Dense layer declaration (config.py:341), the fields the slice's
    layers read."""

    layer_type: str
    bottom_names: List[str]
    top_names: List[str]
    num_outputs: List[int] = dataclasses.field(default_factory=list)
    use_bias: bool = True
    biases: List[bool] = dataclasses.field(default_factory=list)
    act_type: Activation_t = Activation_t.Relu
    activations: List[Activation_t] = dataclasses.field(default_factory=list)
    weight_init_type: Initializer_t = Initializer_t.Default
    bias_init_type: Initializer_t = Initializer_t.Default
    # MultiCross
    num_layers: int = 0
    projection_dim: int = 0
    # Concat
    axis: int = 1
    # Losses
    use_regularizer: bool = False
    regularizer_type: Regularizer_t = Regularizer_t.L1
    lambda_: float = 0.0

    def __post_init__(self):
        self.act_type = Activation_t(self.act_type)
        self.activations = [Activation_t(a) for a in self.activations]


class Layer_t:
    """`hugectr.Layer_t.*` names (config.py:418). Only the slice's layers
    are built; the others raise NotImplementedError at compile."""

    InnerProduct = "InnerProduct"
    MLP = "MLP"
    MultiCross = "MultiCross"
    Concat = "Concat"
    Interaction = "Interaction"
    BinaryCrossEntropyLoss = "BinaryCrossEntropyLoss"
    CrossEntropyLoss = "CrossEntropyLoss"
    MultiCrossEntropyLoss = "MultiCrossEntropyLoss"


LOSS_LAYER_TYPES = {
    Layer_t.BinaryCrossEntropyLoss,
    Layer_t.CrossEntropyLoss,
    Layer_t.MultiCrossEntropyLoss,
}
