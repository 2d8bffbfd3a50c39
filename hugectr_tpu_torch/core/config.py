"""User-facing configuration objects (counterpart of hugectr_tpu/core/config.py).

`Solver` keeps the embedding engine settings as fields with the JAX
package's defaults (config.py:24-139). Nothing here reads the environment:
the JAX package exports these fields to HCTR_TPU_* variables around
`compile`; the port hands them to the plan and the collection directly.
The environment-only settings of the JAX package (the superhot and warm
tiers, the optimizer state's dtype, the exact-AUC limit) are fields here
too, with the environment's defaults.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from .types import Activation_t, DataReaderType_t, Initializer_t, Metric_t, Regularizer_t


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
    max_eval_batches: int = 100
    batchsize_eval: int = 2048
    batchsize: int = 2048
    # bf16 inputs and weights in the dense network's products, f32 sums
    use_mixed_precision: bool = False
    metrics_spec: Dict[Metric_t, float] = dataclasses.field(
        default_factory=lambda: {Metric_t.AUC: 1.0}
    )
    # accepted so that reference scripts fail loudly: not ported yet
    i64_input_key: bool = False
    # eval cycles a shorter eval set to fill max_eval_batches
    repeat_dataset: bool = True
    # `fit` logs MLPerf-style ":::MLLOG" events (config.py:49)
    perf_logging: bool = False
    # `TrainingCallback`s that `fit` calls (config.py:70-71)
    training_callbacks: List[Any] = dataclasses.field(default_factory=list)
    # "float32" or "bfloat16" embedding tables
    embedding_vec_dtype: str = "float32"
    # "float32" or "bfloat16" sparse optimizer state (JAX:
    # HCTR_TPU_EMB_STATE_DTYPE, collection.py:130)
    embedding_state_dtype: str = "float32"
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
    # the hot/cold split (plan.py:311-352): tables of at least
    # max(4 * hot_rows, 2 * onehot_vocab) rows split at hot_rows (0: off);
    # their first superhot_rows rows join the one-hot group (0: off) and
    # rows [hot_rows, warm_rows) make a warm tier (0: off)
    hot_rows: int = 0
    superhot_rows: int = 0
    warm_rows: int = 0
    # eval buffers of at most this many samples take the exact AUC, larger
    # ones the binned one (metrics.py:118, HCTR_TPU_AUC_EXACT_MAX)
    auc_exact_max: int = 8 * 1024 * 1024
    # model-parallel key k lives on shard (k + crc32(table)) % f; False
    # places it on k % f (plan.py:295, HCTR_TPU_SHARD_ROTATION=0)
    shard_rotation: bool = True

    def __post_init__(self):
        self.metrics_spec = {Metric_t(k): v for k, v in self.metrics_spec.items()}

    @property
    def compute_dtype(self):
        import torch

        return torch.bfloat16 if self.use_mixed_precision else torch.float32

    @staticmethod
    def _dtype(name: str, what: str):
        import torch

        if name in ("float32", "fp32"):
            return torch.float32
        if name in ("bfloat16", "bf16"):
            return torch.bfloat16
        raise ValueError(f"{what} must be float32 or bfloat16, got {name!r}")

    @property
    def emb_dtype(self):
        return self._dtype(self.embedding_vec_dtype, "embedding_vec_dtype")

    @property
    def emb_state_dtype(self):
        return self._dtype(self.embedding_state_dtype, "embedding_state_dtype")


@dataclasses.dataclass
class DataReaderParams:
    """Dataset declaration (config.py:240). This slice reads synthetic
    batches only."""

    data_reader_type: DataReaderType_t = DataReaderType_t.Synthetic
    synthetic_num_batches: int = 64
    synthetic_alpha: float = 0.0
    # labels from the keys' parities, so that eval can see learning
    synthetic_learnable: bool = False

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
    """Dense layer declaration (config.py:341), the fields the port's
    layers read, with the JAX package's defaults."""

    layer_type: str
    bottom_names: List[str]
    top_names: List[str]
    # InnerProduct / MLP
    num_output: int = 1
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
    # FmOrder2
    out_dim: int = 0
    # WeightMultiply
    weight_dims: List[int] = dataclasses.field(default_factory=list)
    # LayerNorm / PReLU_Dice (Scale: the repeat count)
    factor: float = 1.0
    eps: float = 1e-5
    # Dropout
    dropout_rate: float = 0.5
    # PReLU_Dice
    elu_alpha: float = 1.0
    # Reshape
    leading_dim: int = 0
    time_step: int = 0
    selected: bool = False
    selected_slots: List[int] = dataclasses.field(default_factory=list)
    shape: List[int] = dataclasses.field(default_factory=list)
    # Slice
    ranges: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    # Concat / ReduceSum / ReduceMean / Scale
    axis: int = 1
    # MultiHeadAttention
    num_attention_heads: int = 1
    # SequenceMask
    max_sequence_len_from: int = 1
    max_sequence_len_to: int = 1
    # Losses
    use_regularizer: bool = False
    regularizer_type: Regularizer_t = Regularizer_t.L1
    lambda_: float = 0.0
    # MultiCrossEntropyLoss
    target_weight_vec: List[float] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.act_type = Activation_t(self.act_type)
        self.activations = [Activation_t(a) for a in self.activations]


# The JAX package's DenseLayer fields of the layers the port does not build
# (BatchNorm, Select, Gather, GRU, MatrixMultiply) and its no-op
# compute_config, at that package's defaults (config.py:341-420). A graph
# file (`Model.graph_to_json`) carries them so that it has the JAX
# package's layout; a graph that sets one otherwise does not load here.
UNPORTED_LAYER_FIELDS: Dict[str, Any] = dict(
    compute_config={"async_wgrad": False, "fuse_wb": False},
    gamma_init_type=Initializer_t.Default.value, beta_init_type=Initializer_t.Default.value,
    dim=1, index=[], indices=[], batchsize=0, SeqLength=0, vector_size=0, transpose_b=False,
    pos_type=None,
)

# Solver fields of the port that the JAX package keeps in its environment
# (HCTR_TPU_EMB_STATE_DTYPE, _SUPERHOT_ROWS, _WARM_ROWS, _AUC_EXACT_MAX,
# _SHARD_ROTATION); a graph file holds them apart from the solver's
PORT_SOLVER_SETTINGS = ("embedding_state_dtype", "superhot_rows", "warm_rows", "auc_exact_max",
                        "shard_rotation")


class Layer_t:
    """`hugectr.Layer_t.*` names (config.py:418) of the layers the port
    builds; any other type raises NotImplementedError at compile."""

    InnerProduct = "InnerProduct"
    MLP = "MLP"
    Interaction = "Interaction"
    MultiCross = "MultiCross"
    FmOrder2 = "FmOrder2"
    WeightMultiply = "WeightMultiply"
    ElementwiseMultiply = "ElementwiseMultiply"
    LayerNorm = "LayerNorm"
    Concat = "Concat"
    Reshape = "Reshape"
    Slice = "Slice"
    Dropout = "Dropout"
    ReLU = "ReLU"
    ReLUHalf = "ReLU"  # the reference's fp16 ReLU: the same op in the compute dtype
    Softmax = "Softmax"
    PReLU_Dice = "PReLU_Dice"
    Scale = "Scale"
    Sub = "Sub"
    Add = "Add"
    ReduceSum = "ReduceSum"
    ReduceMean = "ReduceMean"
    FusedReshapeConcat = "FusedReshapeConcat"
    MultiHeadAttention = "MultiHeadAttention"
    SequenceMask = "SequenceMask"
    BinaryCrossEntropyLoss = "BinaryCrossEntropyLoss"
    CrossEntropyLoss = "CrossEntropyLoss"
    MultiCrossEntropyLoss = "MultiCrossEntropyLoss"


LOSS_LAYER_TYPES = {
    Layer_t.BinaryCrossEntropyLoss,
    Layer_t.CrossEntropyLoss,
    Layer_t.MultiCrossEntropyLoss,
}
