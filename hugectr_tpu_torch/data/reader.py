"""Batch schema and the synthetic reader (counterpart of
hugectr_tpu/data/reader.py: `BatchSpec` :56, `SyntheticReader` :102).

Readers yield numpy batches ``{label: [B, dim] f32, dense: [B, D] f32,
sparse name: [B, hotness] int}``; the model moves them to its device. Batches
are bit-identical to the JAX package's for the same seed. The file readers
wait for a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np

from .generator import power_law_keys


@dataclasses.dataclass(frozen=True)
class SparseFeatureSpec:
    name: str
    slot_nnz: Tuple[int, ...]

    @property
    def total_nnz(self) -> int:
        return sum(self.slot_nnz)

    @property
    def slot_num(self) -> int:
        return len(self.slot_nnz)


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    batch_size: int
    label_dims: Tuple[int, ...]
    label_names: Tuple[str, ...]
    dense_dim: int
    dense_name: str
    sparse: Tuple[SparseFeatureSpec, ...]
    key_dtype: type = np.int32


Batch = Dict[str, np.ndarray]


class BaseReader:
    spec: BatchSpec
    num_batches: int = 0

    def __iter__(self) -> Iterator[Batch]:
        raise NotImplementedError


class SyntheticReader(BaseReader):
    """Seeded power-law or uniform batches (reader.py:102)."""

    def __init__(
        self,
        spec: BatchSpec,
        slot_vocabs: Dict[str, Sequence[int]],
        num_batches: int = 64,
        alpha: float = 0.0,
        seed: int = 1234,
        repeat: bool = True,
    ):
        self.spec = spec
        self.slot_vocabs = {k: list(v) for k, v in slot_vocabs.items()}
        self.num_batches = num_batches
        self.alpha = alpha
        self.seed = seed
        self.repeat = repeat
        for f in spec.sparse:
            if len(self.slot_vocabs[f.name]) != f.slot_num:
                raise ValueError(f"{f.name}: need one vocab per slot")

    def __iter__(self) -> Iterator[Batch]:
        epoch = 0
        while True:
            rng = np.random.default_rng(self.seed + epoch)
            for _ in range(self.num_batches):
                yield self._batch(rng)
            epoch += 1
            if not self.repeat:
                return

    def _batch(self, rng: np.random.Generator) -> Batch:
        # the draw order (labels, dense, then each slot) fixes the stream
        s = self.spec
        b: Batch = {}
        for name, dim in zip(s.label_names, s.label_dims):
            b[name] = rng.integers(0, 2, size=(s.batch_size, dim)).astype(np.float32)
        b[s.dense_name] = rng.random((s.batch_size, s.dense_dim), dtype=np.float32)
        for f in s.sparse:
            cols = []
            for si, nnz in enumerate(f.slot_nnz):
                vocab = self.slot_vocabs[f.name][si]
                if self.alpha > 0:
                    k = power_law_keys(rng, vocab, (s.batch_size, nnz), self.alpha)
                else:
                    k = rng.integers(0, vocab, size=(s.batch_size, nnz))
                cols.append(k)
            b[f.name] = np.concatenate(cols, axis=1).astype(s.key_dtype)
        return b
