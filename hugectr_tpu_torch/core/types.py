"""Core enums, the padding sentinel and default dtypes.

Counterpart of hugectr_tpu/core/types.py (the enums the port uses); the
jnp dtypes of types.py:291-294 become torch dtypes here.
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


class Check_t(str, enum.Enum):
    """Norm files' record framing (types.py:97)."""

    Sum = "sum"
    Non = "none"


class PowerLaw_t(str, enum.Enum):
    """Synthetic key distributions (types.py:102)."""

    Long = "long"
    Medium = "medium"
    Short = "short"
    Specific = "specific"


class FileSystemType_t(str, enum.Enum):
    """Filesystem backend of `DataSourceParams` (types.py:192)."""

    Local = "local"
    HDFS = "hdfs"
    S3 = "s3"
    GCS = "gcs"
    Other = "other"


# The reference module's other enums (types.py:140-290), for scripts that
# name them; the port reads none of them.
class CompressionStrategy(str, enum.Enum):
    """`shard(compression_strategy=...)`'s keys (types.py:140)."""

    Reduction = "reduction"
    Unique = "unique"


class Error_t(str, enum.Enum):
    """The error codes of `HugeCTRError` (types.py:157)."""

    Success = "success"
    FileCannotOpen = "file_cannot_open"
    BrokenFile = "broken_file"
    OutOfMemory = "out_of_memory"
    OutOfBound = "out_of_bound"
    WrongInput = "wrong_input"
    IllegalCall = "illegal_call"
    NotInitialized = "not_initialized"
    EndOfFile = "end_of_file"
    UnSupportedFormat = "unsupported_format"
    InvalidEnv = "invalid_env"
    DataCheckError = "data_check_error"
    MpiError = "mpi_error"
    CudaDriverError = "cuda_driver_error"
    CudaRuntimeError = "cuda_runtime_error"
    CublasError = "cublas_error"
    CudnnError = "cudnn_error"
    NcclError = "nccl_error"
    UnspecificError = "unspecific_error"


class HugeCTRError(RuntimeError):
    """A runtime error carrying an `Error_t` (types.py:184)."""

    def __init__(self, error_t: Error_t, msg: str = ""):
        self.error_t = Error_t(error_t)
        super().__init__(f"[{self.error_t.name}] {msg}")


class SourceType_t(str, enum.Enum):
    FileList = "file_list"
    Mmap = "mmap"
    Parquet = "parquet"


class TrainPSType_t(str, enum.Enum):
    Staged = "staged"
    Cached = "cached"


class Alignment_t(str, enum.Enum):
    Auto = "auto"
    Non = "none"


class LrPolicy_t(str, enum.Enum):
    fixed = "fixed"


class FcPosition_t(str, enum.Enum):
    Non = "none"
    Head = "head"
    Body = "body"
    Tail = "tail"
    Isolated = "isolated"


class Distribution_t(str, enum.Enum):
    Uniform = "uniform"
    PowerLaw = "power_law"


class Tensor_t(str, enum.Enum):
    Train = "train"
    Evaluate = "evaluate"


class AllReduceAlgo(str, enum.Enum):
    OneShot = "oneshot"
    NCCL = "nccl"


class DeviceLayout(str, enum.Enum):
    LocalFirst = "local_first"
    NodeFirst = "node_first"


MetricsType = Metric_t


class MetricsRawType(str, enum.Enum):
    Loss = "loss"
    Pred = "pred"
    Label = "label"


DEFAULT_KEY_DTYPE = torch.int32
DEFAULT_KEY_DTYPE_I64 = torch.int64
DEFAULT_EMB_DTYPE = torch.float32
DEFAULT_COMPUTE_DTYPE = torch.float32

# Sentinel for padded (invalid) key slots in fixed-hotness layouts.
INVALID_KEY = -1
