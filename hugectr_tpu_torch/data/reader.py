"""Batch schema, the readers and the device feeder (counterpart of
hugectr_tpu/data/reader.py: `BatchSpec` :56, `SyntheticReader` :102,
`RawReader` :168, `ParquetReader` :282, `AsyncParquetReader` :509,
`NormReader` :572, `DeviceFeeder` :804).

Readers yield numpy batches ``{label: [B, dim] f32, dense: [B, D] f32,
sparse name: [B, hotness] int}``, or with `fused` the undecoded [B, row]
int32 rows under `FUSED_KEY`, which the model splits on the device. A
padded tail batch (``drop_incomplete=False``) repeats its last row and
carries its true row count under `ROWS_KEY`. Batches are bit-identical to
the JAX package's readers' on the same files or seed.

Over W ranks, rank r reads the block [r * B / W, (r + 1) * B / W) of each
global batch: `SyntheticReader(block=(r, W))` and the Raw readers
(`process_index=r, num_processes=W`, each given the block's B / W rows),
the block a one-process JAX mesh of W devices puts on device r
(`P(data_axes)`, model.py:1202-1210). The Parquet and Norm readers shard
files over the ranks instead (`paths[r::W]`), as the JAX package's
processes do.

`DeviceFeeder` moves batches to the device on a thread of its own; on a
card through `Uploader`: pinned staging buffers, the copy on a stream of
its own and an event that the consumer's stream waits on.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.logger import get_logger
from ..core.types import INVALID_KEY
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
    # int64 with Solver.i64_input_key
    key_dtype: type = np.int32

    @property
    def label_dim_total(self) -> int:
        return sum(self.label_dims)

    @property
    def row_width(self) -> int:
        """int32 values in one Raw row: labels, dense, keys."""
        return self.label_dim_total + self.dense_dim + sum(f.total_nnz for f in self.sparse)


Batch = Dict[str, np.ndarray]
# a fused batch's [B, row_width] int32 rows (labels and dense as their
# float32 bits in the float layout), split on the device by the model
FUSED_KEY = "__raw_rows__"
# the true row count of a padded tail batch; popped before the upload
ROWS_KEY = "__rows__"


class BaseReader:
    """Yields batches forever (repeat) or for one epoch; `num_batches` is
    the batches of an epoch."""

    spec: BatchSpec
    num_batches: int = 0

    def __iter__(self) -> Iterator[Batch]:
        raise NotImplementedError

    def close(self) -> None:
        """Release what the reader holds (threads, files)."""


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


class RawReader(BaseReader):
    """Memory-mapped reader for the RawAsync fixed-stride binary format
    (reader.py:168); the Model reads Raw files through `NativeRawReader`
    and builds this one only when asked directly.

    Row = label_dim + dense_dim + sum(nnz) 4-byte values (reference:
    docs/source/api/python_interface.md:362-383). Dense values are float32
    when `float_label_dense`, else int32 with log1p transform applied here
    (reference: split_batch.cu dense conversion).
    """

    def __init__(
        self,
        path: str,
        spec: BatchSpec,
        num_samples: int = 0,
        float_label_dense: bool = False,
        drop_incomplete: bool = True,
        repeat: bool = True,
        shuffle: bool = False,
        seed: int = 0,
        process_index: int = 0,
        num_processes: int = 1,
        fused: bool = False,
    ):
        self.fused = fused
        self.spec = spec
        self.path = path
        self.float_label_dense = float_label_dense
        self.repeat = repeat
        self.shuffle = shuffle
        self.seed = seed
        # multi-controller: spec.batch_size is the LOCAL slice; global step g
        # reads rows [g*global_batch + pid*local_batch, +local_batch) so the
        # assembled global batch is contiguous, disjoint data per process.
        self.process_index = process_index
        self.num_processes = num_processes
        self.global_batch = spec.batch_size * num_processes
        self.row_width = spec.row_width
        file_rows = os.path.getsize(path) // (4 * self.row_width)
        self.num_samples = min(num_samples, file_rows) if num_samples else file_rows
        self.num_batches = self.num_samples // self.global_batch
        if num_processes == 1:
            if not drop_incomplete and self.num_samples % self.global_batch:
                self.num_batches += 1
        elif not drop_incomplete:
            get_logger().warning(
                "RawReader: drop_incomplete=False is not supported with "
                f"{num_processes} processes; tail samples are dropped"
            )
        if self.num_batches == 0:
            raise ValueError(
                f"{path}: {self.num_samples} samples < one global batch "
                f"({self.global_batch}) — reduce batch size or process count"
            )
        self._mm = np.memmap(path, dtype=np.int32, mode="r").reshape(
            file_rows, self.row_width
        )

    def __iter__(self) -> Iterator[Batch]:
        s = self.spec
        epoch = 0
        while True:
            order = np.arange(self.num_batches)
            if self.shuffle:
                np.random.default_rng(self.seed + epoch).shuffle(order)
            for bi in order:
                lo = int(bi) * self.global_batch + self.process_index * s.batch_size
                hi = min(lo + s.batch_size, self.num_samples)
                yield self._decode(np.asarray(self._mm[lo:hi]))
            epoch += 1
            if not self.repeat:
                return

    def _decode(self, rows: np.ndarray) -> Batch:
        s = self.spec
        n = rows.shape[0]
        partial = n < s.batch_size
        if partial:  # pad tail batch (labels repeat; metrics mask n/a)
            pad = np.repeat(rows[-1:], s.batch_size - n, axis=0)
            rows = np.concatenate([rows, pad], axis=0)
        if getattr(self, "fused", False):
            b = {FUSED_KEY: np.ascontiguousarray(rows)}
            if partial:
                b[ROWS_KEY] = np.int64(n)
            return b
        b: Batch = {}
        off = 0
        for name, dim in zip(s.label_names, s.label_dims):
            lab = rows[:, off : off + dim]
            b[name] = (
                lab.view(np.float32) if self.float_label_dense else lab
            ).astype(np.float32)
            off += dim
        dn = rows[:, off : off + s.dense_dim]
        if self.float_label_dense:
            b[s.dense_name] = dn.view(np.float32).astype(np.float32)
        else:
            # reference split_batch.cu:35 computes log(x+1) on int dense
            # (inputs are >=0 after MLPerf preprocessing); clamp the negative
            # tail to 0 rather than emit -inf/NaN.
            b[s.dense_name] = np.log1p(np.maximum(dn, 0).astype(np.float32))
        off += s.dense_dim
        for f in s.sparse:
            b[f.name] = rows[:, off : off + f.total_nnz].astype(self.spec.key_dtype)
            off += f.total_nnz
        if partial:
            b[ROWS_KEY] = np.int64(n)
        return b


class ParquetReader(BaseReader):
    """File-list Parquet reader (reference: parquet worker + Metadata).

    `file_list` is the ``.txt`` whose first line is the file count; columns
    are discovered from ``_metadata.json`` in the data dir. `slot_size_array`
    (if given) is NOT applied here — key offsetting is the model's choice
    (reference applies it in add_input.cpp:314-319 for fused-table setups).
    """

    def __init__(
        self,
        file_list: str,
        spec: BatchSpec,
        repeat: bool = True,
        drop_incomplete: bool = True,
        shuffle: bool = False,
        seed: int = 0,
        process_index: int = 0,
        num_processes: int = 1,
        fused: bool = False,
    ):
        import pyarrow.parquet as pq  # noqa: F401

        self.fused = fused
        self.spec = spec
        self.repeat = repeat
        self.drop_incomplete = drop_incomplete
        self.shuffle = shuffle
        self.seed = seed
        self.process_index = process_index
        self.num_processes = num_processes
        with open(file_list) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        self.paths = lines[1:] if lines and lines[0].isdigit() else lines
        self._all_paths = list(self.paths)
        if num_processes > 1:
            # file-level sharding per process (reference: per-node worker
            # groups round-robin the file list); requires len(files) >= P
            # and roughly even files for balanced epochs
            if len(self.paths) < num_processes:
                raise ValueError(
                    f"{len(self.paths)} parquet files cannot be sharded over "
                    f"{num_processes} processes"
                )
            self.paths = self.paths[process_index::num_processes]
        meta_path = os.path.join(
            os.path.dirname(os.path.abspath(self.paths[0])), "_metadata.json"
        )
        with open(meta_path) as f:
            meta = json.load(f)
        order = lambda key: [c["col_name"] for c in sorted(meta[key], key=lambda c: c["index"])]
        self.label_cols = order("labels")
        self.cont_cols = order("conts")
        self.cat_cols = order("cats")
        # basename BOTH sides: reference metadata may store relative paths
        # (reference: metadata.cpp:65-71 strips dirnames)
        stats = {
            os.path.basename(fs["file_name"]): fs["num_rows"]
            for fs in meta["file_stats"]
        }
        own_rows = sum(
            stats.get(os.path.basename(p_), 0) for p_ in self.paths
        )
        self.num_batches = own_rows // spec.batch_size
        if num_processes > 1:
            # every process must run the SAME number of collective steps:
            # use the minimum over all process slices (deterministic from
            # the shared metadata; uneven files otherwise deadlock SPMD)
            all_counts = []
            for pi in range(num_processes):
                rows_p = sum(
                    stats.get(os.path.basename(p_), 0)
                    for p_ in self._all_paths[pi::num_processes]
                )
                all_counts.append(rows_p // spec.batch_size)
            self.num_batches = min(all_counts)
        elif not drop_incomplete and own_rows % spec.batch_size:
            self.num_batches += 1
        if self.num_batches == 0:
            raise ValueError(
                f"{file_list}: no full batches for process "
                f"{process_index}/{num_processes} (batch {spec.batch_size})"
            )
        n_slots = sum(f.slot_num for f in spec.sparse)
        if len(self.cat_cols) != n_slots:
            raise ValueError(
                f"dataset has {len(self.cat_cols)} cat columns, model wants {n_slots}"
            )
        if len(self.label_cols) < spec.label_dim_total:
            raise ValueError(
                f"dataset has {len(self.label_cols)} label columns, model "
                f"wants {spec.label_dim_total}"
            )
        if len(self.cont_cols) < spec.dense_dim:
            raise ValueError(
                f"dataset has {len(self.cont_cols)} dense columns, model "
                f"wants {spec.dense_dim}"
            )

    def _decode_table(self, tbl) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Columnar table -> (labels, dense, cats) ndarray triple (the
        split_3_way analog for Parquet columns)."""
        lab = np.stack(
            [tbl[c].to_numpy(zero_copy_only=False) for c in self.label_cols],
            axis=1,
        ).astype(np.float32)
        dense = np.stack(
            [tbl[c].to_numpy(zero_copy_only=False) for c in self.cont_cols],
            axis=1,
        ).astype(np.float32)
        cat_parts = []
        for c in self.cat_cols:
            col = tbl[c].to_numpy(zero_copy_only=False)
            if col.dtype == object:  # list<int> multi-hot column
                col = np.stack([np.asarray(v) for v in col])
            else:
                col = col[:, None]
            cat_parts.append(col.astype(self.spec.key_dtype))
        cat = np.concatenate(cat_parts, axis=1)
        return lab, dense, cat

    def _chunk_stream(self, paths):
        """Yield decoded (lab, dense, cat) chunks for one epoch.

        Base implementation: synchronous whole-file reads.
        AsyncParquetReader overrides this with threaded row-group
        streaming."""
        import pyarrow.parquet as pq

        for path in paths:
            yield self._decode_table(pq.read_table(path))

    def __iter__(self) -> Iterator[Batch]:
        s = self.spec
        epoch = 0
        while True:
            paths = list(self.paths)
            if self.shuffle:  # file-order shuffle per epoch (reference:
                # worker-group round-robin + shuffle knob)
                np.random.default_rng(self.seed + epoch).shuffle(paths)
            epoch += 1
            pend_lab, pend_dense, pend_cat = [], [], []
            pending = 0
            yielded = 0
            for lab, dense, cat in self._chunk_stream(paths):
                pend_lab.append(lab)
                pend_dense.append(dense)
                pend_cat.append(cat)
                pending += lab.shape[0]
                while pending >= s.batch_size and yielded < self.num_batches:
                    lab_a = np.concatenate(pend_lab) if len(pend_lab) > 1 else pend_lab[0]
                    dn_a = np.concatenate(pend_dense) if len(pend_dense) > 1 else pend_dense[0]
                    cat_a = np.concatenate(pend_cat) if len(pend_cat) > 1 else pend_cat[0]
                    yield self._emit(lab_a[: s.batch_size], dn_a[: s.batch_size], cat_a[: s.batch_size])
                    yielded += 1
                    pend_lab = [lab_a[s.batch_size :]]
                    pend_dense = [dn_a[s.batch_size :]]
                    pend_cat = [cat_a[s.batch_size :]]
                    pending -= s.batch_size
            if pending and not self.drop_incomplete and self.num_processes == 1:
                lab_a = np.concatenate(pend_lab)
                dn_a = np.concatenate(pend_dense)
                cat_a = np.concatenate(pend_cat)
                pad = s.batch_size - pending
                tail = self._emit(
                    np.concatenate([lab_a, np.repeat(lab_a[-1:], pad, 0)]),
                    np.concatenate([dn_a, np.repeat(dn_a[-1:], pad, 0)]),
                    np.concatenate([cat_a, np.repeat(cat_a[-1:], pad, 0)]),
                )
                tail[ROWS_KEY] = np.int64(pending)
                yield tail
            if not self.repeat:
                return

    def _emit(self, lab: np.ndarray, dense: np.ndarray, cat: np.ndarray) -> Batch:
        s = self.spec
        if getattr(self, "fused", False):
            # single [B, W] int32 upload, assembled in ONE preallocated
            # buffer (labels/dense ride as f32 bit patterns; the model's
            # decode on the device reinterprets them). Feature blocks narrower
            # in the file than the spec hotness pad with INVALID_KEY.
            n = lab.shape[0]
            width = (
                s.label_dim_total
                + s.dense_dim
                + sum(f.total_nnz for f in s.sparse)
            )
            out = np.empty((n, width), np.int32)
            off = s.label_dim_total + s.dense_dim
            out[:, : s.label_dim_total] = lab.astype(np.float32).view(np.int32)
            out[:, s.label_dim_total : off] = dense.astype(np.float32).view(
                np.int32
            )
            off_c = 0
            for f in s.sparse:
                w = f.total_nnz
                take = min(w, cat.shape[1] - off_c)
                out[:, off : off + take] = cat[:, off_c : off_c + take]
                if take < w:
                    out[:, off + take : off + w] = INVALID_KEY
                off += w
                off_c += take
            return {FUSED_KEY: out}
        b: Batch = {}
        off = 0
        for name, dim in zip(s.label_names, s.label_dims):
            b[name] = lab[:, off : off + dim]
            off += dim
        b[s.dense_name] = dense
        # Each parquet slot column (scalar or list<int>) was flattened into
        # its nnz-wide block above; a feature takes total_nnz columns. If the
        # file holds fewer (1-hot file, hotness>1 requested) pad with -1.
        off_c = 0
        for f in s.sparse:
            w = f.total_nnz
            take = min(w, cat.shape[1] - off_c)
            block = cat[:, off_c : off_c + take]
            if take < w:
                block = np.concatenate(
                    [block, np.full((block.shape[0], w - take), INVALID_KEY, self.spec.key_dtype)],
                    axis=1,
                )
            b[f.name] = block
            off_c += take
        return b


class AsyncParquetReader(ParquetReader):
    """Threaded row-group-streaming Parquet reader.

    Analog of the reference's threaded Parquet worker group
    (parquet_data_reader_worker.cpp:1-469, row_group_reading_thread.cpp:
    1-263): a thread pool decodes ROW GROUPS (never whole files) while the
    consumer stitches fixed batches, keeping `prefetch` row groups in
    flight — IO and Arrow decode overlap training with a bounded memory
    footprint. Row-group order is deterministic, so batches are identical
    to the synchronous ParquetReader's (tested)."""

    def __init__(self, *args, n_threads: int = 4, prefetch: int = 8, **kw):
        super().__init__(*args, **kw)
        self.n_threads = n_threads
        self.prefetch = prefetch

    def _chunk_stream(self, paths):
        import concurrent.futures as cf

        import pyarrow.parquet as pq

        tasks = []
        for path in paths:
            pf = pq.ParquetFile(path)
            for rg in range(pf.metadata.num_row_groups):
                tasks.append((path, rg))
            pf.close()

        tls = threading.local()

        def read_rg(task):
            path, rg = task
            # thread-local file handle cache: one open ParquetFile per
            # (worker, path) — avoids footer re-reads per row group
            cache = getattr(tls, "files", None)
            if cache is None:
                cache = tls.files = {}
            pf = cache.get(path)
            if pf is None:
                for old in cache.values():
                    old.close()
                cache.clear()
                pf = cache[path] = pq.ParquetFile(path)
            return self._decode_table(pf.read_row_group(rg))

        with cf.ThreadPoolExecutor(max_workers=self.n_threads) as pool:
            inflight = []
            cursor = 0
            while cursor < len(tasks) or inflight:
                while cursor < len(tasks) and len(inflight) < self.prefetch:
                    inflight.append(pool.submit(read_rg, tasks[cursor]))
                    cursor += 1
                fut = inflight.pop(0)  # consume IN ORDER (deterministic)
                yield fut.result()


class NormCheckError(ValueError):
    """Record checksum mismatch (reference: Error_t::DataCheckError,
    check_sum.hpp)."""


class NormReader(ParquetReader):
    """Norm binary format reader (file list + DataSetHeader + per-record
    CheckSum framing).

    Reference: include/common.hpp:184 DataSetHeader,
    include/data_readers/check_sum.hpp (unit = [int32 len][payload][int8
    byte-sum]), data layout per data_generation_for_test2
    (include/data_generator.hpp:380-467): payload = (label_dim+dense_dim)
    float32 then per slot int32 nnz + nnz keys. The format is deprecated at
    runtime in the reference snapshot (add_input.cpp:140-145); it is read
    here for dataset compatibility.

    The reference generator bakes cumulative slot offsets into Norm keys
    (simulator range [accum, accum+vocab)); pass `slot_size_array` to
    subtract them and emit slot-LOCAL keys (symmetric with the Parquet
    reader, where offsetting is the model's choice).
    """

    def __init__(
        self,
        file_list: str,
        spec: BatchSpec,
        repeat: bool = True,
        drop_incomplete: bool = True,
        shuffle: bool = False,
        seed: int = 0,
        slot_size_array=None,
        process_index: int = 0,
        num_processes: int = 1,
    ):
        self.spec = spec
        self.repeat = repeat
        self.drop_incomplete = drop_incomplete
        self.shuffle = shuffle
        self.seed = seed
        self.process_index = process_index
        self.num_processes = num_processes
        self.slot_nnz = [n for f in spec.sparse for n in f.slot_nnz]
        self.slot_off = (
            np.concatenate([[0], np.cumsum(slot_size_array)[:-1]]).astype(
                np.int64
            )
            if slot_size_array
            else None
        )
        with open(file_list) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        self.paths = lines[1:] if lines and lines[0].isdigit() else lines
        self._all_paths = list(self.paths)
        if num_processes > 1:
            if len(self.paths) < num_processes:
                raise ValueError(
                    f"{len(self.paths)} norm files cannot be sharded over "
                    f"{num_processes} processes"
                )
            self.paths = self.paths[process_index::num_processes]
        counts = {p_: self._header(p_)[1] for p_ in self._all_paths}
        own = sum(counts[p_] for p_ in self.paths)
        self.num_batches = own // spec.batch_size
        if num_processes > 1:
            self.num_batches = min(
                sum(counts[p_] for p_ in self._all_paths[pi::num_processes])
                // spec.batch_size
                for pi in range(num_processes)
            )
        elif not drop_incomplete and own % spec.batch_size:
            self.num_batches += 1
        if self.num_batches == 0:
            raise ValueError(f"{file_list}: no full batches")

    def _header(self, path: str):
        with open(path, "rb") as f:
            first = f.read(4 + 64 + 1)
        # sum framing: [len=64][header][check]; none: raw 64-byte header
        if (
            len(first) >= 69
            and int(np.frombuffer(first[:4], "<i4")[0]) == 64
            and int(np.frombuffer(first[4:12], "<i8")[0]) == 1
        ):
            hdr = np.frombuffer(first[4:68], "<i8")
            if (np.frombuffer(first[4:68], np.uint8).sum() & 0xFF) != first[68]:
                raise NormCheckError(f"{path}: header checksum mismatch")
            return hdr, int(hdr[1]), 69
        hdr = np.frombuffer(first[:64], "<i8")
        return hdr, int(hdr[1]), 64

    def _chunk_stream(self, paths):
        for path in paths:
            yield self._load_file(path)

    def _load_file(self, path: str):
        s = self.spec
        raw = np.fromfile(path, np.uint8)
        hdr, n_rec, body = self._header(path)
        checked = int(hdr[0]) == 1
        label_dim, dense_dim, slot_num = int(hdr[2]), int(hdr[3]), int(hdr[4])
        if label_dim != s.label_dim_total or dense_dim != s.dense_dim:
            raise ValueError(
                f"{path}: header label/dense {label_dim}/{dense_dim} != "
                f"model {s.label_dim_total}/{s.dense_dim}"
            )
        if slot_num != len(self.slot_nnz):
            raise ValueError(
                f"{path}: {slot_num} slots != model {len(self.slot_nnz)}"
            )
        kdt = np.dtype("<i8") if s.key_dtype == np.int64 else np.dtype("<u4")
        ksz = kdt.itemsize
        ld_bytes = 4 * (label_dim + dense_dim)

        # fast path: every record has the same framed length (fixed nnz)
        if checked and body + 4 <= raw.size:
            L = int(np.frombuffer(raw[body : body + 4], "<i4")[0])
            stride = 4 + L + 1
            if body + n_rec * stride <= raw.size:
                view = raw[body : body + n_rec * stride].reshape(n_rec, stride)
                lens = view[:, :4].copy().view("<i4")[:, 0]
                if (lens == L).all():
                    payload = view[:, 4 : 4 + L]
                    sums = view[:, -1]
                    calc = payload.sum(axis=1, dtype=np.uint64) & 0xFF
                    if not (calc == sums).all():
                        bad = int(np.argmax(calc != sums))
                        raise NormCheckError(
                            f"{path}: record {bad} checksum mismatch"
                        )
                    return self._parse_fixed(
                        payload, label_dim, dense_dim, slot_num, kdt, path
                    )
        if not checked:
            # unframed: fixed layout requires the model's nnz widths
            L = ld_bytes + sum(4 + n * ksz for n in self.slot_nnz)
            if body + n_rec * L <= raw.size:
                payload = raw[body : body + n_rec * L].reshape(n_rec, L)
                try:
                    return self._parse_fixed(
                        payload, label_dim, dense_dim, slot_num, kdt, path
                    )
                except ValueError:
                    pass  # variable nnz; fall through to the record walk
        return self._parse_walk(
            raw, body, n_rec, checked, label_dim, dense_dim, slot_num, kdt,
            path,
        )

    def _parse_fixed(self, payload, label_dim, dense_dim, slot_num, kdt, path):
        """[n, L] uint8 payload matrix with uniform per-slot nnz."""
        n = payload.shape[0]
        ld_bytes = 4 * (label_dim + dense_dim)
        ld = payload[:, :ld_bytes].copy().view("<f4")
        lab = ld[:, :label_dim].astype(np.float32)
        dense = ld[:, label_dim:].astype(np.float32)
        cat_parts = []
        off = ld_bytes
        for s_i in range(slot_num):
            nnz = int(
                np.frombuffer(payload[0, off : off + 4].tobytes(), "<i4")[0]
            )
            width = self.slot_nnz[s_i]
            if nnz > width:
                raise ValueError(
                    f"{path}: slot {s_i} nnz {nnz} exceeds model hotness "
                    f"{width}"
                )
            nnz_col = payload[:, off : off + 4].copy().view("<i4")[:, 0]
            if not (nnz_col == nnz).all():
                raise ValueError("variable nnz")  # caller falls back to walk
            off += 4
            keys = (
                payload[:, off : off + nnz * kdt.itemsize]
                .copy()
                .view(kdt)
                .astype(np.int64)
            )
            off += nnz * kdt.itemsize
            if self.slot_off is not None:
                keys = keys - self.slot_off[s_i]
            block = np.full((n, width), INVALID_KEY, self.spec.key_dtype)
            block[:, :nnz] = keys.astype(self.spec.key_dtype)
            cat_parts.append(block)
        return lab, dense, np.concatenate(cat_parts, axis=1)

    def _parse_walk(
        self, raw, off, n_rec, checked, label_dim, dense_dim, slot_num, kdt,
        path,
    ):
        """General record-by-record walk (variable nnz)."""
        s = self.spec
        lab = np.zeros((n_rec, label_dim), np.float32)
        dense = np.zeros((n_rec, dense_dim), np.float32)
        cat = np.full(
            (n_rec, sum(self.slot_nnz)), INVALID_KEY, self.spec.key_dtype
        )
        col_off = np.concatenate([[0], np.cumsum(self.slot_nnz)])
        for i in range(n_rec):
            if checked:
                L = int(np.frombuffer(raw[off : off + 4].tobytes(), "<i4")[0])
                payload = raw[off + 4 : off + 4 + L]
                if (payload.sum(dtype=np.uint64) & 0xFF) != raw[off + 4 + L]:
                    raise NormCheckError(f"{path}: record {i} checksum mismatch")
                off += 4 + L + 1
            else:
                payload = raw[off:]
            p = 0
            ld = payload[: 4 * (label_dim + dense_dim)].tobytes()
            vals = np.frombuffer(ld, "<f4")
            lab[i] = vals[:label_dim]
            dense[i] = vals[label_dim:]
            p = 4 * (label_dim + dense_dim)
            for s_i in range(slot_num):
                nnz = int(
                    np.frombuffer(payload[p : p + 4].tobytes(), "<i4")[0]
                )
                p += 4
                keys = np.frombuffer(
                    payload[p : p + nnz * kdt.itemsize].tobytes(), kdt
                ).astype(np.int64)
                p += nnz * kdt.itemsize
                if self.slot_off is not None:
                    keys = keys - self.slot_off[s_i]
                width = self.slot_nnz[s_i]
                if nnz > width:
                    raise ValueError(
                        f"{path}: record {i} slot {s_i} nnz {nnz} > {width}"
                    )
                cat[i, col_off[s_i] : col_off[s_i] + nnz] = keys.astype(
                    self.spec.key_dtype
                )
            if not checked:
                off += p
        return lab, dense, cat




class DeviceBatch(dict):
    """A batch's tensors on the device. On a card, `event` marks the end of
    their copy; `ready()` makes the current stream wait for it."""

    event: Optional["torch.cuda.Event"] = None

    def ready(self) -> "DeviceBatch":
        """Order the current stream after the copy, and tell the caching
        allocator that this stream uses the tensors, so that their memory
        is not handed out again while its work may still read them."""
        ev, self.event = self.event, None
        if ev is not None:
            t0 = next(iter(self.values()))
            cur = torch.cuda.current_stream(t0.device)
            cur.wait_event(ev)
            for t in self.values():
                t.record_stream(cur)
        return self


class _Slot:
    def __init__(self):
        self.bufs: Dict[str, torch.Tensor] = {}
        self.event: Optional["torch.cuda.Event"] = None


class Uploader:
    """numpy batch -> `DeviceBatch` on `device` (the reference's H2D upload,
    data_collector.cu). On a card each array is copied into a pinned
    staging buffer, then to the device with a non-blocking copy on a
    stream of the uploader's own, and an event is recorded after the
    copies. A ring of `slots` staging sets is reused in turn, each only
    after its last copy's event has completed. On the CPU the arrays
    become tensors (a read-only array, such as a memmap's rows, is copied
    first). `bytes` and `batches` count what was uploaded."""

    def __init__(self, device, slots: int = 3):
        self.device = torch.device(device)
        self._slots = [_Slot() for _ in range(slots)]
        self._next = 0
        self._stream: Optional["torch.cuda.Stream"] = None
        self.bytes = 0
        self.batches = 0

    def __call__(self, batch: Batch) -> DeviceBatch:
        self.bytes += sum(int(v.nbytes) for v in batch.values())
        self.batches += 1
        if self.device.type != "cuda":
            return DeviceBatch({k: torch.from_numpy(np.array(v) if not v.flags.writeable else
                                                    np.ascontiguousarray(v)).to(self.device)
                                for k, v in batch.items()})
        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            slot = self._slots[self._next]
            self._next = (self._next + 1) % len(self._slots)
            if slot.event is not None:
                slot.event.synchronize()  # the slot's last copy has read its buffers
            out = DeviceBatch()
            for k, v in batch.items():
                v = np.asarray(v)
                buf = slot.bufs.get(k)
                if buf is None or tuple(buf.shape) != v.shape or buf.numpy().dtype != v.dtype:
                    buf = slot.bufs[k] = torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype,
                                                     pin_memory=True)
                np.copyto(buf.numpy(), v)
            with torch.cuda.stream(self._stream):
                for k in batch:
                    out[k] = slot.bufs[k].to(self.device, non_blocking=True)
                slot.event = out.event = torch.cuda.Event()
                slot.event.record(self._stream)
        return out


class DeviceFeeder:
    """Batches of `reader` through `put_fn` (host batch -> device batch) on a
    thread of its own, `depth` of them in flight, in the reader's order
    (reader.py:804). An error of the reader or of `put_fn` is raised to the
    consumer; the end of a non-repeating reader ends the iteration.
    `stop()` ends the thread and joins it. A `DeviceBatch` is made ready on
    the consumer's stream as it is taken."""

    def __init__(self, reader: BaseReader, put_fn, depth: int = 3):
        self.reader = reader
        self.put_fn = put_fn
        self.depth = depth
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "DeviceFeeder":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True, name="hctr-device-feeder")
            self._thread.start()
        return self

    def _run(self) -> None:
        try:
            for batch in self.reader:
                if self._stop.is_set():
                    return
                self._q.put(self.put_fn(batch))
        except Exception as e:  # surfaced to the consumer
            self._q.put(e)
        self._q.put(StopIteration())

    def __iter__(self):
        self.start()
        while True:
            item = self._q.get()
            if isinstance(item, StopIteration):
                return
            if isinstance(item, Exception):
                raise item
            yield item.ready() if isinstance(item, DeviceBatch) else item

    def _drain(self) -> None:
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def stop(self) -> None:
        self._stop.set()
        while self._thread is not None and self._thread.is_alive():
            self._drain()  # a thread blocked on a full queue goes on and sees the flag
            self._thread.join(timeout=0.05)
        self._drain()
