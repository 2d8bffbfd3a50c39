"""hugectr_tpu_torch — the PyTorch / CUDA port of hugectr_tpu for NVIDIA
Hopper.

The JAX package `hugectr_tpu` is the reference; this package imports
nothing of it and no JAX. It keeps the reference-parity API the flagship
uses (`CreateSolver`, `CreateOptimizer`, `Model`, ...). Entry points run on
the card unless the caller passes `device="cpu"`; the one-hot and segmented
scan kernels are hand-written CUDA for sm_90a (`csrc/`), built at first use.
Over several cards each rank is a process: `init_distributed()` (under
torchrun, or `tools/hybrid.py`) and then the same API train hybrid-parallel.
"""
from __future__ import annotations

import dataclasses

from .core.config import (
    DataReaderParams,
    DataReaderSparseParam,
    DenseLayer,
    Input,
    Layer_t,
    Solver,
)
from .core.logger import get_logger
from .core.mesh import ResourceManager, init_distributed
from .core.types import (
    Activation_t,
    Combiner_t,
    DataReaderType_t,
    Initializer_t,
    Metric_t,
    Optimizer_t,
)
from .embedding.config import (
    EmbeddingCollectionConfig,
    EmbeddingTableConfig,
    Embedding_t,
    SparseEmbedding,
)
from .model.model import Model, TrainingCallback
from .optim.params import OptParams


def _filter_kwargs(cls, kwargs, label):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(kwargs) - fields)
    if unknown:
        get_logger().warning(f"{label}: ignoring unknown args {unknown}")
    return {k: v for k, v in kwargs.items() if k in fields}


def CreateSolver(**kwargs) -> Solver:
    """hugectr.CreateSolver; unknown reference arguments are ignored with a
    warning."""
    return Solver(**_filter_kwargs(Solver, kwargs, "CreateSolver"))


def CreateOptimizer(optimizer_type=None, **kwargs) -> OptParams:
    """hugectr.CreateOptimizer."""
    if optimizer_type is not None:
        kwargs["optimizer"] = optimizer_type
    kwargs.pop("atomic_update", None)
    return OptParams(**_filter_kwargs(OptParams, kwargs, "CreateOptimizer"))


__all__ = [
    "Activation_t",
    "Combiner_t",
    "CreateOptimizer",
    "CreateSolver",
    "DataReaderParams",
    "DataReaderSparseParam",
    "DataReaderType_t",
    "DenseLayer",
    "EmbeddingCollectionConfig",
    "EmbeddingTableConfig",
    "Embedding_t",
    "Initializer_t",
    "Input",
    "Layer_t",
    "Metric_t",
    "Model",
    "OptParams",
    "Optimizer_t",
    "ResourceManager",
    "Solver",
    "SparseEmbedding",
    "TrainingCallback",
    "init_distributed",
]
