"""hugectr_tpu_torch — the PyTorch / CUDA port of hugectr_tpu for NVIDIA
Hopper.

The JAX package `hugectr_tpu` is the reference; this package imports
nothing of it and no JAX. It keeps the reference-parity API the flagship
uses (`CreateSolver`, `CreateOptimizer`, `Model`, ...). Entry points run on
the card unless the caller passes `device="cpu"`; the one-hot and segmented
scan kernels are hand-written CUDA for sm_90a (`csrc/`), built at first use.
Over several cards each rank is a process: `init_distributed()` (under
torchrun, or `tools/hybrid.py`) and then the same API train hybrid-parallel.
`DataGenerator` writes Raw, Norm and Parquet datasets, which the Model
reads through `DataReaderParams`.
"""
from __future__ import annotations

import dataclasses

from .core.config import (
    AsyncParam,
    DataReaderParams,
    DataReaderSparseParam,
    DataSourceParams,
    DenseLayer,
    DenseLayerComputeConfig,
    Input,
    Layer_t,
    Solver,
)
from .core.logger import get_logger
from .core.mesh import ResourceManager, group_size, init_distributed
from .core.types import (
    Activation_t,
    Alignment_t,
    AllReduceAlgo,
    Check_t,
    Combiner_t,
    CommunicationStrategy,
    CompressionStrategy,
    DataReaderType_t,
    DeviceLayout,
    Distribution_t,
    Error_t,
    FcPosition_t,
    FileSystemType_t,
    HugeCTRError,
    Initializer_t,
    LrPolicy_t,
    Metric_t,
    MetricsRawType,
    MetricsType,
    Optimizer_t,
    PowerLaw_t,
    Regularizer_t,
    SourceType_t,
    TablePlacementStrategy,
    Tensor_t,
    TrainPSType_t,
    Update_t,
)
from .data.generator import DataGenerator, DataGeneratorParams
from .embedding.config import (
    EmbeddingCollectionConfig,
    EmbeddingTableConfig,
    Embedding_t,
    SparseEmbedding,
)
from .model.model import Model, TrainingCallback
from .optim.lr_schedule import LearningRateScheduler
from .optim.params import OptParams

# the reference's pybind name of the optimizer's parameters
OptParamsPy = OptParams


def _filter_kwargs(cls, kwargs, label):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(kwargs) - fields)
    if unknown:
        get_logger().warning(f"{label}: ignoring unknown args {unknown}")
    return {k: v for k, v in kwargs.items() if k in fields}


# The JAX `Solver` fields (hugectr_tpu/core/config.py:24-139) that the port's
# `Solver` lacks and that change nothing the JAX package computes, each with
# its reason: `CreateSolver` accepts them by name and ignores them.
INERT_SOLVER_FIELDS = {
    "lr_policy": "'fixed' is the only policy (config.py:29, types.py LrPolicy_t), never read",
    "vvgpu": "the reference's device list, never read (config.py:39); the ranks are the process group",
    "enable_tf32_compute": "a parity no-op (config.py:41); the port keeps TF32 off to match float32",
    "scaler": "never read (config.py:42)",
    "use_embedding_collection": "never read (config.py:51)",
    "device_layout": "a parity no-op (config.py:53-58)",
    "use_algorithm_search": "a parity no-op (config.py:53-59)",
    "all_reduce_algo": "a parity no-op (config.py:53-60)",
    "grouped_all_reduce": "a parity no-op (config.py:53-61)",
    "num_iterations_statistics": "a parity no-op (config.py:53-62)",
    "gen_loss_summary": "a parity no-op (config.py:53-63)",
    "train_intra_iteration_overlap": "a parity no-op (config.py:53-64)",
    "train_inter_iteration_overlap": "a parity no-op (config.py:53-65)",
    "eval_intra_iteration_overlap": "a parity no-op (config.py:53-66)",
    "eval_inter_iteration_overlap": "a parity no-op (config.py:53-67)",
    "kafka_brockers": "no streaming parameter server (config.py:68)",
    "segsum_mode": "exact either way for float32 tables: tests/test_pallas_segscan.py holds the scan equal to "
                   "segment_sum (config.py:86); the port's sorted route sums in float32 as 'xla' does "
                   "(with bfloat16 tables 'scan' raises)",
}


def check_solver_settings(kwargs) -> None:
    """Raise for a JAX `Solver` setting that the port cannot honour: the
    mesh settings that the JAX `ResourceManager.create` refuses
    (hugectr_tpu/core/mesh.py:70-88; over one rank without a process group
    the Model's `ResourceManager.create` says it), and the one setting
    refused on purpose."""
    w = group_size()
    slices, ev = kwargs.get("num_slices") or 1, kwargs.get("ev_parallelism") or 1
    if slices > 1 and ev > 1:
        raise ValueError("ev_parallelism and num_slices are exclusive")
    for what, f in (("ev_parallelism", ev), ("num_slices", slices)):
        if w > 1 and w % f:
            raise ValueError(f"num_devices={w} not divisible by {what}={f}")
    if kwargs.get("segsum_mode") == "scan" and kwargs.get("embedding_vec_dtype") in ("bfloat16", "bf16"):
        raise NotImplementedError(
            "segsum_mode='scan' with bfloat16 tables: the JAX package's scan stores the segment sums in "
            "bfloat16, where its 'xla' mode and the port keep float32 sums (ROADMAP Queue 3)")
    n = kwargs.get("num_devices") or 0
    if n not in (0, group_size()):
        raise ValueError(
            f"num_devices={n}, but the process group has {group_size()} rank(s): one device per rank; start "
            "the ranks with init_distributed() (torchrun, or tools/hybrid.py)"
        )


def CreateSolver(**kwargs) -> Solver:
    """hugectr.CreateSolver. A JAX `Solver` setting that the port cannot
    honour raises (`check_solver_settings`); `num_devices` must be 0 or the
    process group's size; the fields of `INERT_SOLVER_FIELDS` are accepted
    and ignored; any other unknown argument is ignored with a warning."""
    check_solver_settings(kwargs)
    for k in (*INERT_SOLVER_FIELDS, "num_devices"):
        kwargs.pop(k, None)
    return Solver(**_filter_kwargs(Solver, kwargs, "CreateSolver"))


def CreateOptimizer(optimizer_type=None, **kwargs) -> OptParams:
    """hugectr.CreateOptimizer."""
    if optimizer_type is not None:
        kwargs["optimizer"] = optimizer_type
    kwargs.pop("atomic_update", None)
    return OptParams(**_filter_kwargs(OptParams, kwargs, "CreateOptimizer"))


__version__ = "0.1.0"  # the JAX package's (hugectr_tpu/__init__.py:100)
__all__ = [
    "Activation_t",
    "Alignment_t",
    "AllReduceAlgo",
    "AsyncParam",
    "Check_t",
    "Combiner_t",
    "CommunicationStrategy",
    "CompressionStrategy",
    "CreateOptimizer",
    "CreateSolver",
    "DataGenerator",
    "DataGeneratorParams",
    "DataReaderParams",
    "DataReaderSparseParam",
    "DataReaderType_t",
    "DataSourceParams",
    "DenseLayer",
    "DenseLayerComputeConfig",
    "DeviceLayout",
    "Distribution_t",
    "EmbeddingCollectionConfig",
    "EmbeddingTableConfig",
    "Embedding_t",
    "Error_t",
    "FcPosition_t",
    "FileSystemType_t",
    "HugeCTRError",
    "Initializer_t",
    "Input",
    "Layer_t",
    "LearningRateScheduler",
    "LrPolicy_t",
    "Metric_t",
    "MetricsRawType",
    "MetricsType",
    "Model",
    "OptParams",
    "OptParamsPy",
    "Optimizer_t",
    "PowerLaw_t",
    "Regularizer_t",
    "ResourceManager",
    "Solver",
    "SourceType_t",
    "SparseEmbedding",
    "TablePlacementStrategy",
    "Tensor_t",
    "TrainPSType_t",
    "TrainingCallback",
    "Update_t",
    "init_distributed",
]
