"""Batch schema and the synthetic reader (counterpart of
hugectr_tpu/data/reader.py: `BatchSpec` :56, `SyntheticReader` :102).

Readers yield numpy batches ``{label: [B, dim] f32, dense: [B, D] f32,
sparse name: [B, hotness] int}``; the model moves them to its device. Batches
are bit-identical to the JAX package's for the same seed. The file readers
wait for a later slice.

Over W ranks, rank r reads the block [r * B / W, (r + 1) * B / W) of each
global batch (`block=(r, W)`): the block a one-process JAX mesh of W devices
puts on device r (`P(data_axes)`, model.py:1202-1210), so one rank and W
ranks train on the same examples.
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
    """Seeded power-law or uniform batches (reader.py:102); with `block`
    (r, W), rows [r * B / W, (r + 1) * B / W) of each global batch of
    `spec.batch_size` rows."""

    def __init__(
        self,
        spec: BatchSpec,
        slot_vocabs: Dict[str, Sequence[int]],
        num_batches: int = 64,
        alpha: float = 0.0,
        seed: int = 1234,
        repeat: bool = True,
        learnable_labels: bool = False,
        block: Tuple[int, int] = (0, 1),
    ):
        if spec.batch_size % block[1]:
            raise ValueError(f"global batch {spec.batch_size} does not split over {block[1]} ranks")
        self.block = block
        self.spec = spec
        self.slot_vocabs = {k: list(v) for k, v in slot_vocabs.items()}
        self.num_batches = num_batches
        self.alpha = alpha
        self.seed = seed
        self.repeat = repeat
        # labels drawn from the keys' parities and dense[0] (reader.py:154)
        self.learnable_labels = learnable_labels
        for f in spec.sparse:
            if len(self.slot_vocabs[f.name]) != f.slot_num:
                raise ValueError(f"{f.name}: need one vocab per slot")

    def __iter__(self) -> Iterator[Batch]:
        epoch = 0
        while True:
            rng = np.random.default_rng(self.seed + epoch)
            r, w = self.block
            n = self.spec.batch_size // w
            for _ in range(self.num_batches):
                b = self._batch(rng)
                yield b if w == 1 else {k: v[r * n : (r + 1) * n] for k, v in b.items()}
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
        if self.learnable_labels:
            # logit: the first slot's key parities summed over the features,
            # centred, plus dense[0]; then one more draw from the stream
            sig = np.zeros(s.batch_size, np.float32)
            for f in s.sparse:
                sig += (b[f.name][:, 0] % 2).astype(np.float32)
            sig = sig - sig.mean() + 2.0 * (b[s.dense_name][:, 0] - 0.5)
            prob = 1.0 / (1.0 + np.exp(-2.0 * sig))
            lab = (rng.random(s.batch_size) < prob).astype(np.float32)
            b[s.label_names[0]] = np.repeat(lab[:, None], s.label_dims[0], axis=1)
        return b
