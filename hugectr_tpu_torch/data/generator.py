"""Dataset writer and synthetic key sampler (counterpart of
hugectr_tpu/data/generator.py: `power_law_keys` :33, `DataGeneratorParams`
:46, `DataGenerator` :86).

numpy only; the same generator state gives the same keys as the JAX
package's sampler, and the same parameters give byte-equal Raw and Norm
files. Parquet imports `pyarrow` inside the method that writes it.

Raw rows are ``label_dim`` labels + ``dense_dim`` dense + ``sum(nnz_array)``
keys, all 4-byte little-endian; dense is float32 when ``float_label_dense``
else int32 (readers take log(x+1)). Norm files are a header unit and one
unit a record, framed ``[int32 len][payload][uint8 byte-sum]`` with
`Check_t.Sum`; a record is (label_dim + dense_dim) float32, then per slot
``int32 nnz`` + nnz keys carrying the slots' cumulative offsets.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List

import numpy as np

from ..core.types import Check_t, DataReaderType_t, PowerLaw_t

_POWER_LAW_ALPHA = {
    PowerLaw_t.Long: 0.9,
    PowerLaw_t.Medium: 1.1,
    PowerLaw_t.Short: 1.3,
}


def power_law_keys(rng: np.random.Generator, vocab: int, size, alpha: float) -> np.ndarray:
    """Inverse-CDF power-law sampler over [0, vocab) (reference:
    IntPowerLawDataSimulator, include/data_generator.hpp:109-128)."""
    x = rng.random(size)
    mn, mx = 1.0, float(vocab)
    one_m_a = 1.0 - alpha
    y = ((mx**one_m_a - mn**one_m_a) * x + mn**one_m_a) ** (1.0 / one_m_a)
    return np.clip(np.round(y) - 1.0, 0, vocab - 1).astype(np.int64)


@dataclasses.dataclass
class DataGeneratorParams:
    """Mirror of the reference DataGeneratorParams
    (include/data_generator.hpp:1072-1110)."""

    format: DataReaderType_t = DataReaderType_t.Parquet
    label_dim: int = 1
    dense_dim: int = 13
    num_slot: int = 26
    i64_input_key: bool = False
    source: str = "./train_data.txt"
    eval_source: str = "./eval_data.txt"
    slot_size_array: List[int] = dataclasses.field(default_factory=list)
    nnz_array: List[int] = dataclasses.field(default_factory=list)
    check_type: Check_t = Check_t.Non
    dist_type: str = "powerlaw"  # "powerlaw" | "uniform"
    power_law_type: PowerLaw_t = PowerLaw_t.Specific
    alpha: float = 1.2
    num_files: int = 16
    eval_num_files: int = 4
    num_samples_per_file: int = 40960
    num_samples: int = 0  # raw only: total train samples
    eval_num_samples: int = 0  # raw only
    float_label_dense: bool = False
    seed: int = 0

    def __post_init__(self):
        self.format = DataReaderType_t(self.format)
        if not self.nnz_array:
            self.nnz_array = [1] * self.num_slot
        if len(self.slot_size_array) != self.num_slot:
            raise ValueError("slot_size_array must have num_slot entries")
        if len(self.nnz_array) != self.num_slot:
            raise ValueError("nnz_array must have num_slot entries")
        if self.dist_type == "powerlaw" and self.power_law_type != PowerLaw_t.Specific:
            self.alpha = _POWER_LAW_ALPHA[PowerLaw_t(self.power_law_type)]

    @property
    def key_dtype(self):
        return np.int64 if self.i64_input_key else np.int32


class DataGenerator:
    """Writes synthetic datasets in Parquet or Raw format."""

    def __init__(self, params: DataGeneratorParams):
        self.p = params

    def generate(self) -> None:
        p = self.p
        if p.format == DataReaderType_t.Parquet:
            self._generate_parquet(p.source, p.num_files, seed_off=0)
            self._generate_parquet(p.eval_source, p.eval_num_files, seed_off=1 << 20)
        elif p.format in (DataReaderType_t.Raw, DataReaderType_t.RawAsync):
            n_train = p.num_samples or p.num_files * p.num_samples_per_file
            n_eval = p.eval_num_samples or p.eval_num_files * p.num_samples_per_file
            self._generate_raw(p.source, n_train, seed_off=0)
            self._generate_raw(p.eval_source, n_eval, seed_off=1 << 20)
        elif p.format == DataReaderType_t.Norm:
            self._generate_norm(p.source, p.num_files, seed_off=0)
            self._generate_norm(p.eval_source, p.eval_num_files, seed_off=1 << 20)
        else:
            raise NotImplementedError(f"format {p.format}")

    # ----------------------------------------------------------------- common
    def _sample_block(self, rng: np.random.Generator, n: int):
        p = self.p
        labels = rng.integers(0, 2, size=(n, p.label_dim)).astype(np.float32)
        dense = rng.random((n, p.dense_dim)).astype(np.float32)
        cats = []
        for s in range(p.num_slot):
            vocab = int(p.slot_size_array[s])
            nnz = int(p.nnz_array[s])
            if p.dist_type == "powerlaw":
                k = power_law_keys(rng, vocab, (n, nnz), p.alpha)
            else:
                k = rng.integers(0, vocab, size=(n, nnz))
            cats.append(k.astype(np.int64))
        return labels, dense, cats

    # ---------------------------------------------------------------- parquet
    def _generate_parquet(self, file_list_path: str, num_files: int, seed_off: int):
        import pyarrow as pa
        import pyarrow.parquet as pq

        p = self.p
        out_dir = os.path.dirname(os.path.abspath(file_list_path)) or "."
        data_dir = os.path.join(out_dir, os.path.basename(file_list_path) + ".d")
        os.makedirs(data_dir, exist_ok=True)
        rng = np.random.default_rng(p.seed + seed_off)

        label_cols = [f"label{i}" for i in range(p.label_dim)]
        cont_cols = [f"C{i}" for i in range(p.dense_dim)]
        cat_cols = [f"CAT{i}" for i in range(p.num_slot)]

        file_stats = []
        paths = []
        for fi in range(num_files):
            n = p.num_samples_per_file
            labels, dense, cats = self._sample_block(rng, n)
            cols, names = [], []
            for i, c in enumerate(label_cols):
                cols.append(pa.array(labels[:, i]))
                names.append(c)
            for i, c in enumerate(cont_cols):
                cols.append(pa.array(dense[:, i]))
                names.append(c)
            for s, c in enumerate(cat_cols):
                k = cats[s].astype(p.key_dtype)
                if k.shape[1] == 1:
                    cols.append(pa.array(k[:, 0]))
                else:
                    cols.append(pa.array(list(k)))
                names.append(c)
            fpath = os.path.join(data_dir, f"gen_{fi}.parquet")
            # bounded row groups so readers can stream/parallelize at
            # row-group granularity (reference datasets ship multi-RG files)
            pq.write_table(
                pa.table(cols, names=names), fpath, row_group_size=65536
            )
            file_stats.append({"file_name": f"gen_{fi}.parquet", "num_rows": n})
            paths.append(fpath)

        # _metadata.json layout per reference
        # (HugeCTR/src/data_readers/metadata.cpp:57-129)
        meta = {
            "file_stats": file_stats,
            "labels": [
                {"col_name": c, "index": i} for i, c in enumerate(label_cols)
            ],
            "conts": [
                {"col_name": c, "index": p.label_dim + i}
                for i, c in enumerate(cont_cols)
            ],
            "cats": [
                {"col_name": c, "index": p.label_dim + p.dense_dim + i}
                for i, c in enumerate(cat_cols)
            ],
        }
        with open(os.path.join(data_dir, "_metadata.json"), "w") as f:
            json.dump(meta, f)
        with open(file_list_path, "w") as f:
            f.write(f"{len(paths)}\n")
            f.writelines(pth + "\n" for pth in paths)

    # -------------------------------------------------------------------- raw
    def _generate_raw(self, path: str, num_samples: int, seed_off: int):
        p = self.p
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        rng = np.random.default_rng(p.seed + seed_off)
        total_nnz = sum(p.nnz_array)
        block = 65536
        with open(path, "wb") as f:
            done = 0
            while done < num_samples:
                n = min(block, num_samples - done)
                labels, dense, cats = self._sample_block(rng, n)
                row = np.empty(
                    (n, p.label_dim + p.dense_dim + total_nnz), dtype=np.int32
                )
                row[:, : p.label_dim] = labels.astype(np.int32)
                if p.float_label_dense:
                    row[:, : p.label_dim] = labels.view(np.int32).reshape(
                        n, p.label_dim
                    )
                    row[:, p.label_dim : p.label_dim + p.dense_dim] = dense.view(
                        np.int32
                    ).reshape(n, p.dense_dim)
                else:
                    row[:, p.label_dim : p.label_dim + p.dense_dim] = (
                        dense * 1000
                    ).astype(np.int32)
                off = p.label_dim + p.dense_dim
                for s in range(p.num_slot):
                    nnz = p.nnz_array[s]
                    row[:, off : off + nnz] = cats[s].astype(np.int32)
                    off += nnz
                f.write(row.tobytes())
                done += n

    # ------------------------------------------------------------------- norm
    def _generate_norm(self, file_list_path: str, num_files: int, seed_off: int):
        """Norm binary format writer (reference:
        include/data_generator.hpp:380-467 data_generation_for_test2 +
        include/common.hpp:184 DataSetHeader + Checker_Traits framing).

        Each ``.data`` file = one header unit + one unit per record. With
        Check_t.Sum every unit is framed ``[int32 len][payload][int8
        byte-sum]`` (check_sum.hpp semantics); Check_t.Non writes raw
        payloads. Record payload = (label_dim+dense_dim) float32, then per
        slot ``int32 nnz`` + nnz keys. Keys carry the reference's baked-in
        global slot offsets (simulator range [accum, accum+vocab)). The
        format is deprecated at runtime in the reference snapshot; it is
        supported here for dataset compatibility."""
        p = self.p
        out_dir = os.path.dirname(os.path.abspath(file_list_path)) or "."
        data_dir = os.path.join(out_dir, os.path.basename(file_list_path) + ".d")
        os.makedirs(data_dir, exist_ok=True)
        rng = np.random.default_rng(p.seed + seed_off)
        use_sum = p.check_type == Check_t.Sum
        kdt = np.dtype("<i8") if p.i64_input_key else np.dtype("<u4")
        slot_off = np.concatenate([[0], np.cumsum(p.slot_size_array)[:-1]])

        def write_unit(f, payload: bytes):
            if use_sum:
                f.write(np.int32(len(payload)).tobytes())
                f.write(payload)
                f.write(
                    np.uint8(
                        np.frombuffer(payload, np.uint8).sum(dtype=np.uint64)
                        & 0xFF
                    ).tobytes()
                )
            else:
                f.write(payload)

        paths = []
        for fi in range(num_files):
            n = p.num_samples_per_file
            labels, dense, cats = self._sample_block(rng, n)
            fpath = os.path.join(data_dir, f"gen_{fi}.data")
            with open(fpath, "wb") as f:
                header = np.array(
                    [1 if use_sum else 0, n, p.label_dim, p.dense_dim,
                     p.num_slot, 0, 0, 0],
                    dtype="<i8",
                )
                write_unit(f, header.tobytes())
                # vectorized record assembly: fixed per-slot nnz -> every
                # record payload has identical length L
                ld = np.concatenate([labels, dense], axis=1).astype("<f4")
                parts = [ld.view(np.uint8).reshape(n, -1)]
                for s in range(p.num_slot):
                    nnz = int(p.nnz_array[s])
                    nnz_bytes = np.frombuffer(
                        np.int32(nnz).astype("<i4").tobytes(), np.uint8
                    )
                    parts.append(np.tile(nnz_bytes, (n, 1)))
                    keys = (cats[s] + slot_off[s]).astype(kdt)
                    parts.append(keys.view(np.uint8).reshape(n, -1))
                rec = np.concatenate(parts, axis=1)
                if use_sum:
                    lens = np.full((n, 1), rec.shape[1], "<i4")
                    sums = (rec.sum(axis=1, dtype=np.uint64) & 0xFF).astype(
                        np.uint8
                    )[:, None]
                    out = np.concatenate(
                        [lens.view(np.uint8).reshape(n, -1), rec, sums], axis=1
                    )
                else:
                    out = rec
                f.write(out.tobytes())
            paths.append(fpath)
        with open(file_list_path, "w") as f:
            f.write(f"{len(paths)}\n")
            f.writelines(pth + "\n" for pth in paths)
