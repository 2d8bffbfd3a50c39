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

from .types import Activation_t, Check_t, DataReaderType_t, FileSystemType_t, Initializer_t, Metric_t, Regularizer_t


@dataclasses.dataclass
class Solver:
    """Global training settings (config.py:24). `model_name` is a label:
    the ONNX converter names its graph after it."""

    model_name: str = ""
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
    # 64-bit input keys, folded to int32 on the host (`Model._fold_i64_keys`)
    i64_input_key: bool = False
    # eval cycles a shorter eval set to fill max_eval_batches
    repeat_dataset: bool = True
    # a file's last rows that fill no batch are dropped; False pads them
    # into one last batch (the Python Raw, Parquet and Norm readers)
    drop_incomplete_batch: bool = True
    # `fit` logs MLPerf-style ":::MLLOG" events (config.py:49)
    perf_logging: bool = False
    # on a card, the train step and the eval forward run as captured CUDA
    # graphs, replayed each step (config.py:47, True as there: the JAX
    # package runs each step as one jitted program); `Model.step_mode`
    # says whether a configuration captures; False runs them eagerly
    use_cuda_graph: bool = True
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
    # "bfloat16": the dense sweep of AdaGrad and RowWiseAdaGrad sums its
    # gradient rows into a bf16 buffer, rounding after every add
    # (sparse_optimizer.py:206 dense_grad_dtype); other optimizers keep f32
    dense_grad_dtype: str = "float32"
    # > 0: a static table of threshold < vocab <= onehot_scatter_maxv rows
    # whose lookups' total hotness x ratio >= vocab also takes the one-hot
    # engine (plan.py:499-522, HCTR_TPU_ONEHOT_SCATTER_RATIO and _MAXV)
    onehot_scatter_ratio: int = 0
    onehot_scatter_maxv: int = 131072
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
    # ---- the exchanges of model-parallel rowop groups over W > 1 ranks
    # the forward pools only the sorted prefix of the gathered keys that
    # this rank's shard owns (HCTR_TPU_FWD_PARTITION, collection.py:141);
    # False: the masked gather of every gathered key
    fwd_partition: bool = True
    # > 0 cuts the forward's sorted key list at ceil512(K x factor / W) and
    # the backward's at ceil512(K x factor / f) for f shards, dropping the
    # rest (HCTR_TPU_MP_CAPACITY_FACTOR, collection.py:142-144, :904-916,
    # :1884-1891; a JAX Solver field, config.py:90); 0 is exact
    mp_capacity_factor: float = 0.0
    # all-Concat groups at full placement exchange unique rows over
    # all_to_all, in lists of dense_exchange_cap rows per (batch block,
    # owner shard); a cap of 0 or dense_exchange=False leaves it off
    # (HCTR_TPU_DENSE_EXCHANGE and _CAP, collection.py:203-208)
    dense_exchange: bool = True
    dense_exchange_cap: int = 0
    # ---- the unique-row windows and the packed layouts (the JAX Solver's
    # unique_cap_factor, config.py:84-91, and HCTR_TPU_UCAP_HEADROOM,
    # _UCAP_MIN_K, _UCAP_DROP, _PACKED_STATE, _ROWWISE_PACK,
    # collection.py:146-172): "auto" measures each group's caps on the
    # first batch (unique rows, valid keys, dense-exchange lists) times
    # ucap_headroom, which sends a group with a valid cap to the compact
    # forward and counts its measured keys in the key-ratio rule; a factor
    # in (0, 1) windows the update's unique rows at K x factor (lists of at
    # least ucap_min_k keys); the windows are exact, but with ucap_drop the
    # rows past the window lose their gradients; 0 turns them off
    unique_cap_factor: Any = 0.0
    ucap_headroom: float = 1.25
    ucap_min_k: int = 0
    ucap_drop: bool = False
    # AdaGrad groups keep table and accumulators in one [R, 2E] array
    packed_state: bool = False
    # RowWiseAdaGrad groups of more than dense_update_rows rows keep their
    # accumulator as column E of an [R, E + 1] table
    rowwise_pack: bool = False
    # ---- the mesh (config.py:74-75; `ResourceManager.create`): the
    # ("data", "ev") mesh of ev_parallelism e, or the hierarchical ("dcn",
    # "ici") mesh of num_slices slices; exclusive
    ev_parallelism: int = 1
    num_slices: int = 1
    # shared rowop groups bin their tables (first-appearance order) so that
    # no bin holds more than this many rows a shard (plan.py:468,
    # HCTR_TPU_GROUP_ROWS); None or 0 keeps one group
    group_rows: Optional[int] = None

    def __post_init__(self):
        self.metrics_spec = {Metric_t(k): v for k, v in self.metrics_spec.items()}
        if self.mp_capacity_factor is None:  # the JAX Solver's "unset"
            self.mp_capacity_factor = 0.0
        if self.unique_cap_factor is None:
            self.unique_cap_factor = 0.0
        if self.unique_cap_factor != "auto":
            self.unique_cap_factor = float(self.unique_cap_factor)
        if self.mp_capacity_factor < 0 or self.dense_exchange_cap < 0:
            raise ValueError("mp_capacity_factor and dense_exchange_cap must not be negative")

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

    @property
    def grad_dtype(self):
        return self._dtype(self.dense_grad_dtype, "dense_grad_dtype")


@dataclasses.dataclass
class AsyncParam:
    """The RawAsync reader's settings (config.py:180): `num_threads` fill
    threads and `num_batches_per_thread` batches in the native reader's
    ring; `shuffle` shuffles the batch order of the Python `RawReader`
    only; `is_dense_float` (with `multi_hot_reader`) reads labels and dense
    as float32. The AIO settings are accepted and not read."""

    num_threads: int = 1
    num_batches_per_thread: int = 4
    max_num_requests_per_thread: int = 72
    io_depth: int = 4
    io_alignment: int = 512
    shuffle: bool = False
    aligned_type: Any = "auto"
    multi_hot_reader: bool = True
    is_dense_float: bool = True

    def __post_init__(self):
        if not self.multi_hot_reader and self.is_dense_float:
            raise ValueError(
                "multi_hot_reader=False requires is_dense_float=False "
                "(reference AsyncParam constraint)"
            )


@dataclasses.dataclass
class DataSourceParams:
    """A remote filesystem for the sources (config.py:211): `make_uri`
    prefixes a plain path with the backend's scheme."""

    source: Any = "local"
    server: str = "localhost"
    port: int = 9000

    def make_uri(self, path: str) -> str:
        fs = FileSystemType_t(self.source)
        if fs == FileSystemType_t.Local or "://" in path:
            return path
        scheme = {"hdfs": "hdfs", "s3": "s3", "gcs": "gs"}.get(fs.value)
        if scheme is None:
            raise ValueError(
                f"DataSourceParams: unsupported backend {fs!r} — pass a "
                "fully qualified scheme:// path instead"
            )
        if fs == FileSystemType_t.HDFS:
            return f"{scheme}://{self.server}:{self.port}{path}"
        return f"{scheme}://{path.lstrip('/')}"


@dataclasses.dataclass
class DataReaderParams:
    """Dataset declaration (config.py:240): the reader type, the train
    `source` (a list; a str becomes one) and `eval_source`, with
    `data_source_params.make_uri` applied to both. Raw and RawAsync files
    take the native reader; `num_workers` is Parquet's thread count;
    `cache_train_data` / `cache_eval_data` keep that many batches on the
    device and cycle them. `keyset` is accepted and not read."""

    data_reader_type: DataReaderType_t = DataReaderType_t.Parquet
    source: List[str] = dataclasses.field(default_factory=list)
    eval_source: str = ""
    check_type: Check_t = Check_t.Non
    cache_eval_data: int = 0
    cache_train_data: int = 0
    num_samples: int = 0
    eval_num_samples: int = 0
    float_label_dense: bool = False
    # True also turns AsyncParam.shuffle off
    read_file_sequentially: bool = False
    num_workers: int = 4
    # Norm keys carry the slots' offsets; given, the reader subtracts them
    slot_size_array: List[int] = dataclasses.field(default_factory=list)
    keyset: List[str] = dataclasses.field(default_factory=list)
    data_source_params: Optional[DataSourceParams] = None
    async_param: Optional[AsyncParam] = None
    synthetic_num_batches: int = 64
    # labels from the keys' parities, so that eval can see learning
    synthetic_learnable: bool = False
    synthetic_alpha: float = 0.0

    def __post_init__(self):
        self.data_reader_type = DataReaderType_t(self.data_reader_type)
        if isinstance(self.source, str):
            self.source = [self.source]
        if isinstance(self.keyset, str):
            self.keyset = [self.keyset]
        if self.data_source_params is not None:
            mk = self.data_source_params.make_uri
            self.source = [mk(s) for s in self.source]
            if self.eval_source:
                self.eval_source = mk(self.eval_source)


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
class DenseLayerComputeConfig:
    """The reference's wgrad settings (config.py:333); no-ops, as in the
    JAX package."""

    async_wgrad: bool = False
    fuse_wb: bool = False


@dataclasses.dataclass
class DenseLayer:
    """Dense layer declaration (config.py:341): the JAX package's fields in
    its order with its defaults, so that `dataclasses.asdict` of a layer,
    and so a graph file's "dense_layers", is the JAX package's.
    `compute_config` is accepted and not read (a no-op in the JAX package
    too), and two layers that differ only in it compare equal."""

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
    compute_config: DenseLayerComputeConfig = dataclasses.field(
        default_factory=DenseLayerComputeConfig, repr=False, compare=False)
    # init
    weight_init_type: Initializer_t = Initializer_t.Default
    bias_init_type: Initializer_t = Initializer_t.Default
    gamma_init_type: Initializer_t = Initializer_t.Default
    beta_init_type: Initializer_t = Initializer_t.Default
    # MultiCross
    num_layers: int = 0
    projection_dim: int = 0
    # FmOrder2
    out_dim: int = 0
    # WeightMultiply
    weight_dims: List[int] = dataclasses.field(default_factory=list)
    # BatchNorm / LayerNorm / PReLU_Dice (Scale: the repeat count;
    # MaskedSoftmax: the scale)
    factor: float = 1.0
    eps: float = 1e-5
    # Dropout
    dropout_rate: float = 0.5
    # ELU / PReLU_Dice
    elu_alpha: float = 1.0
    # Reshape
    leading_dim: int = 0
    time_step: int = 0
    selected: bool = False
    selected_slots: List[int] = dataclasses.field(default_factory=list)
    shape: List[int] = dataclasses.field(default_factory=list)
    # Select
    dim: int = 1
    index: List[int] = dataclasses.field(default_factory=list)
    # Slice
    ranges: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    # Concat / ReduceSum / ReduceMean / Scale / Softmax
    axis: int = 1
    # Gather
    indices: List[int] = dataclasses.field(default_factory=list)
    # GRU
    batchsize: int = 0
    SeqLength: int = 0
    vector_size: int = 0
    # MultiHeadAttention
    num_attention_heads: int = 1
    # MatrixMultiply
    transpose_b: bool = False
    # SequenceMask
    max_sequence_len_from: int = 1
    max_sequence_len_to: int = 1
    # Losses
    use_regularizer: bool = False
    regularizer_type: Regularizer_t = Regularizer_t.L1
    lambda_: float = 0.0
    target_weight_vec: List[float] = dataclasses.field(default_factory=list)
    # misc (not read, as in the JAX package)
    pos_type: Optional[str] = None

    def __post_init__(self):
        self.act_type = Activation_t(self.act_type)
        self.activations = [Activation_t(a) for a in self.activations]


# Solver fields of the port that the JAX package keeps in its environment
# (HCTR_TPU_EMB_STATE_DTYPE, _SUPERHOT_ROWS, _WARM_ROWS, _AUC_EXACT_MAX,
# _SHARD_ROTATION, _FWD_PARTITION, _DENSE_EXCHANGE, _DENSE_EXCHANGE_CAP,
# _ONEHOT_SCATTER_RATIO, _ONEHOT_SCATTER_MAXV, _DENSE_GRAD_DTYPE,
# _UCAP_HEADROOM, _UCAP_MIN_K, _UCAP_DROP, _PACKED_STATE, _ROWWISE_PACK); a
# graph file holds them apart from the solver's
PORT_SOLVER_SETTINGS = ("embedding_state_dtype", "superhot_rows", "warm_rows", "auc_exact_max",
                        "shard_rotation", "fwd_partition", "dense_exchange", "dense_exchange_cap",
                        "onehot_scatter_ratio", "onehot_scatter_maxv", "dense_grad_dtype",
                        "ucap_headroom", "ucap_min_k", "ucap_drop", "packed_state", "rowwise_pack")


class Layer_t:
    """`hugectr.Layer_t.*` names (config.py:418)."""

    InnerProduct = "InnerProduct"
    FusedInnerProduct = "FusedInnerProduct"
    MLP = "MLP"
    MatrixMultiply = "MatrixMultiply"
    Interaction = "Interaction"
    MultiCross = "MultiCross"
    FmOrder2 = "FmOrder2"
    WeightMultiply = "WeightMultiply"
    ElementwiseMultiply = "ElementwiseMultiply"
    BatchNorm = "BatchNorm"
    LayerNorm = "LayerNorm"
    Concat = "Concat"
    Reshape = "Reshape"
    Select = "Select"
    Slice = "Slice"
    Dropout = "Dropout"
    ELU = "ELU"
    ReLU = "ReLU"
    ReLUHalf = "ReLU"  # the reference's fp16 ReLU: the same op in the compute dtype
    Sigmoid = "Sigmoid"
    Softmax = "Softmax"
    PReLU_Dice = "PReLU_Dice"
    Scale = "Scale"
    Sub = "Sub"
    Add = "Add"
    ReduceSum = "ReduceSum"
    ReduceMean = "ReduceMean"
    Gather = "Gather"
    GRU = "GRU"
    FusedReshapeConcat = "FusedReshapeConcat"
    FusedReshapeConcatGeneral = "FusedReshapeConcatGeneral"
    MultiHeadAttention = "MultiHeadAttention"
    SequenceMask = "SequenceMask"
    MaskedSoftmax = "MaskedSoftmax"
    Cast = "Cast"
    BinaryCrossEntropyLoss = "BinaryCrossEntropyLoss"
    CrossEntropyLoss = "CrossEntropyLoss"
    MultiCrossEntropyLoss = "MultiCrossEntropyLoss"


LOSS_LAYER_TYPES = {
    Layer_t.BinaryCrossEntropyLoss,
    Layer_t.CrossEntropyLoss,
    Layer_t.MultiCrossEntropyLoss,
}
