"""Core enums, the padding sentinel and default dtypes.

Counterpart of hugectr_tpu/core/types.py (the enums the training slice
uses); the jnp dtypes of types.py:291-294 become torch dtypes here.
"""
from __future__ import annotations

import enum

import torch


class Optimizer_t(str, enum.Enum):
    """Optimizer kinds (types.py:14-33)."""

    SGD = "sgd"
    MomentumSGD = "momentum_sgd"
    Nesterov = "nesterov"
    AdaGrad = "adagrad"
    # one accumulator scalar per embedding row (torchrec ROWWISE_ADAGRAD)
    RowWiseAdaGrad = "rowwise_adagrad"
    RMSProp = "rmsprop"
    Adam = "adam"
    FTRL = "ftrl"
    Ftrl = "ftrl"


class Update_t(str, enum.Enum):
    Local = "local"
    Global = "global"
    LazyGlobal = "lazy_global"


class Activation_t(str, enum.Enum):
    Relu = "relu"
    Sigmoid = "sigmoid"
    Tanh = "tanh"
    Elu = "elu"
    Gelu = "gelu"
    NonE = "none"


# reference scripts spell "no activation" as Activation_t.Non
Activation_t.Non = Activation_t.NonE


class Regularizer_t(str, enum.Enum):
    NonE = "none"
    L1 = "l1"
    L2 = "l2"


class Initializer_t(str, enum.Enum):
    Default = "default"
    Uniform = "uniform"
    XavierNorm = "xavier_norm"
    XavierUniform = "xavier_uniform"
    Zero = "zero"


class Combiner_t(str, enum.Enum):
    Sum = "sum"
    Mean = "mean"
    Concat = "concat"


class TablePlacementStrategy(str, enum.Enum):
    DataParallel = "dp"
    ModelParallel = "mp"


class CommunicationStrategy(str, enum.Enum):
    """How the embedding's collectives run (types.py:133)."""

    Uniform = "uniform"
    Hierarchical = "hierarchical"


class Metric_t(str, enum.Enum):
    """Eval metrics (types.py:111)."""

    AUC = "auc"
    AverageLoss = "average_loss"
    HitRate = "hit_rate"
    SMAPE = "smape"
    NDCG = "ndcg"


class DataReaderType_t(str, enum.Enum):
    Norm = "norm"
    Raw = "raw"
    Parquet = "parquet"
    RawAsync = "raw_async"
    Synthetic = "synthetic"


DEFAULT_KEY_DTYPE = torch.int32
DEFAULT_KEY_DTYPE_I64 = torch.int64
DEFAULT_EMB_DTYPE = torch.float32
DEFAULT_COMPUTE_DTYPE = torch.float32

# Sentinel for padded (invalid) key slots in fixed-hotness layouts.
INVALID_KEY = -1
