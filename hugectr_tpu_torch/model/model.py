"""High-level Model API: add / compile / train / eval / fit (counterpart of
hugectr_tpu/model/model.py: `Model.__init__`/`add`/`compile` :152-498,
`train_step` :787-883, `train`/`train_async` :1253/:1257, `eval` :1390,
`fit` :1441).

`compile` takes the Solver's embedding dtype (float32 or bfloat16 tables
and optimizer state), mixed precision (bf16 products in the dense network)
and the hot/cold/superhot split of big tables. A legacy `SparseEmbedding`
lowers onto the collection as in the JAX package (model.py:339-386): one
table `sparse_table_<name>` with one lookup per slot, each slot's keys
shifted by the slot's offset in `slot_size_array`, model-parallel, and a
[B, slots, ev] top. `compile(loss_names, loss_weights)` sets the tasks'
label weights (model.py:207-221).

The JAX package jits the whole iteration; here the step runs eagerly:

1. the embedding forward under `no_grad`;
2. the dense network on detached embedding outputs that require grad;
   `loss.backward()` gives the dense gradients and, as the outputs'
   `.grad`, the embedding cotangents (the JAX package's `value_and_grad`
   with respect to both, model.py:846);
3. the dense optimizer's update, in place;
4. the fused embedding backward and sparse update, in place (a dynamic
   table's new keys are inserted into its key store first).

Both optimizers get the 1-based global step (Adam's bias corrections).
Dynamic tables' key stores live in `tables` under `"{group}#keys"`; their
synthetic keys are drawn below each table's capacity (`_slot_vocabs`).

Over W ranks (`ResourceManager` over a process group, one process per
device) the model is hybrid-parallel, as the JAX package's step over a mesh
of W devices: the plan is compiled for W shards (model.py:393-397), each
rank reads its block of B/W rows of every global batch, the embedding
tables are model-parallel or replicated (`EmbeddingCollection`), and the
dense network is replicated. The local loss is a mean over B/W rows, so
the step differentiates loss / W: the dense gradients and the embedding
cotangents are then those of the global-batch mean. For W a power of two
the scaling is exact and commutes with the bfloat16 roundings of mixed
precision and of bfloat16 tables (the cotangents are all-gathered in the
tables' type); another W adds one float32 rounding. The dense parameters
stay float32 under mixed precision; their gradients and the loss go into
one flat float32 bucket and one `all_reduce` a step;
then every rank runs the same dense update. No
`DistributedDataParallel`: the update is the port's `DenseOptimizer`, as
the JAX step is a plain sum. `train()` returns the global mean loss, and
`eval` the metrics of the global eval set. Every rank calls `train`,
`eval` and `fit` together.

The mesh (model.py:162-166): without a `resource_manager` the Model builds
one from the Solver's `ev_parallelism` and `num_slices`. On the ("data",
"ev") mesh W above is the data-parallel size W / e: a rank reads and
trains the block of its data index, the dense bucket is all-reduced over
its data group and then taken from the first of its ev replicas, so that
they stay bitwise equal. The first collection's `comm_strategy` takes the
two-level exchange on a hierarchical mesh. `shard(column_factors={t: f})`
splits table t into f sub-tables `t#col{j}` of ev / f columns, shared by
t's lookups, one lookup each, their tops concatenated in j order into the
user's top (model.py:248-323); the strategy, the shard counts, snapshots,
`export_table` and freezing name the sub-tables. `Solver.group_rows` bins
the shared rowop groups (plan.py:642-660). Ranks on H hosts
(`local_world_size`) read as the JAX package's H processes do
(`_make_reader`).

`eval` runs one eager forward under `no_grad` per batch of the eval set
into a `MetricAccumulator` per loss layer, with no host sync per batch
(model.py:466-490): the first task's metrics under their plain names, the
loss on it, and each other task's as `"<metric>_<label>"`. The JAX
package's scanned eval (many batches in one XLA dispatch) is a device of
XLA's and is not ported.

The readers (model.py:501-637) follow the JAX package's rules: Raw and
RawAsync files go through the native threaded reader (`NativeRawReader`),
Parquet through `AsyncParquetReader`, Norm through `NormReader`, and a
Synthetic source (or a missing eval source) through `SyntheticReader`.
Synthetic batches, and `cache_train_data` / `cache_eval_data` batches of any
reader, are put on the device once and cycled; other batches come through a
`DeviceFeeder` thread (pinned staging, a copy stream, an event the step's
stream waits on). Raw and Parquet batches travel as one fused int32 [B, row]
upload, split on the device (`_decode_batch`). A non-repeating source that
runs dry raises StopIteration from `train()` and shows as `is_eof()` on the
reader's handle (`get_data_reader_train` / `_eval`); `set_source` re-points
the readers. A padded tail batch's rows all count in the metrics, as in the
JAX package. With `Solver.i64_input_key` the readers yield int64 keys,
folded to int32 on the host before the upload (model.py:927-1130): a static
table takes the key modulo its vocabulary; a dynamic table gives every
distinct 64-bit key its own 31-bit id from a map that snapshots keep
(`i64_fold_maps.npz`); over W ranks the ranks' new keys are all-gathered so
that every rank holds the map of the JAX package's one-process run.

`graph_to_json` / `construct_from_json` (model.py:2076-2202) write and
read the JAX package's graph layout, so a graph written by either package
loads in the other.

Snapshots and weight files (model.py:1513-1894) are written in the JAX
package's on-disk layout through `io/filesystem.py`, so that a snapshot
written by either package loads in the other; bfloat16 arrays are written
as the JAX package writes them (2-byte voids) and read back bitwise. Over W
ranks every rank computes (the sharded arrays are all-gathered) and rank 0
alone writes; on loading, each rank takes its block. The packed state
layouts have no counterpart here, and a snapshot that holds them raises
`NotImplementedError`.

The low-level training API (model.py:1897-2262: the learning rate, the
losses, freezing, the summary, `check_out_tensor`, the reader handles,
`read_a_batch`) and `fit`'s `TrainingCallback`s and `:::MLLOG` events
(model.py:1455-1505) are ported.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import (
    PORT_SOLVER_SETTINGS,
    UNPORTED_LAYER_FIELDS,
    DataReaderParams,
    DataReaderSparseParam,
    DenseLayer,
    Input,
    Solver,
)
from ..core.logger import get_logger
from ..core.mesh import DeviceLike, ResourceManager, all_gather, all_reduce, broadcast
from ..core.types import Combiner_t, DataReaderType_t, Metric_t
from ..core.types import INVALID_KEY
from ..data.reader import (
    FUSED_KEY,
    ROWS_KEY,
    AsyncParquetReader,
    BaseReader,
    BlockReader,
    BatchSpec,
    DeviceBatch,
    DeviceFeeder,
    NormReader,
    SparseFeatureSpec,
    SyntheticReader,
    Uploader,
)
from ..embedding.collection import EmbeddingCollection
from ..embedding.config import EmbeddingCollectionConfig, EmbeddingTableConfig, SparseEmbedding
from ..io import filesystem as iofs
from ..layers.network import Network
from ..metrics.metrics import MetricAccumulator
from ..optim.dense import DenseOptimizer
from ..optim.lr_schedule import LearningRateScheduler
from ..optim.params import OptParams
from ..parallel.plan import LookupConfig, ShardingPlan, compile_plan
from ..utils.diagnose import check_embedding_overflow


@dataclasses.dataclass
class _KeySource:
    param_name: str
    col_begin: int
    col_end: int
    key_offset: int = 0  # a SparseEmbedding slot's first row in its table


class TrainingCallback:
    """Hooks that `fit` calls (model.py:67-80); `on_eval_end` returning
    True stops the training early."""

    def on_training_start(self, model: "Model"):
        pass

    def on_eval_start(self, model: "Model", iteration: int):
        pass

    def on_eval_end(self, model: "Model", iteration: int, metrics: Dict) -> bool:
        return False

    def on_training_end(self, model: "Model", iteration: int):
        pass


class _DataReaderHandle:
    """The train or eval reader's handle (model.py:83-148): `set_source`,
    `is_eof`, `is_started` and the staged reads."""

    def __init__(self, model: "Model", train: bool):
        self._model = model
        self._train = train

    @property
    def reader(self) -> Optional[BaseReader]:
        return self._model.train_reader if self._train else self._model.eval_reader

    def set_source(self, file_name: str = "") -> None:
        """Re-point this reader at a new file or file list; clears EOF."""
        if self._train:
            self._model.set_source(source=file_name or None)
        else:
            self._model.set_source(eval_source=file_name)

    def is_eof(self) -> bool:
        """Whether a non-repeating source ran dry."""
        return self._model._train_eof if self._train else self._model._eval_eof

    def is_started(self) -> bool:
        """Whether this reader's feed has started (EOF does not un-start it)."""
        return self._model._train_iter is not None if self._train else self._model._eval_feed_started

    def read_a_batch_to_device(self) -> int:
        """Stage the next batch (a train batch is what the next `train()`
        takes); returns its true row count (less than the batch for a padded
        tail), 0 at EOF."""
        if not self._model.read_a_batch(is_train=self._train):
            return 0
        s = self._model.solver
        return self._model._last_read_rows or int(s.batchsize if self._train else s.batchsize_eval)

    def read_a_batch_to_device_delay_release(self) -> int:
        """The same staged read: the feeder keeps its own buffers in flight."""
        return self.read_a_batch_to_device()

    def ready_to_collect(self) -> None:
        """A no-op, as in the JAX package (model.py:144)."""


class Model:
    """add() / compile() / train() (model.py:149). The model lives on
    `resource_manager.device`, or on `device` (default: the card)."""

    def __init__(
        self,
        solver: Solver,
        reader_params: Optional[DataReaderParams],
        optimizer: OptParams,
        resource_manager: Optional[ResourceManager] = None,
        device: DeviceLike = None,
    ):
        self.solver = solver
        self.reader_params = reader_params
        self.opt_params = optimizer
        self.rm = resource_manager or ResourceManager.create(
            device=device, ev_parallelism=solver.ev_parallelism, num_slices=solver.num_slices)
        self.device = self.rm.device
        self.input: Optional[Input] = None
        self.dense_layers: List[DenseLayer] = []
        self.ebc_configs: List[EmbeddingCollectionConfig] = []
        self.sparse_embeddings: List[SparseEmbedding] = []
        self.callbacks: List[TrainingCallback] = list(solver.training_callbacks or [])
        self._step = 0  # the optimizers' step (the JAX package's state["step"])
        self._iter = 0  # train() calls, or a snapshot's iteration
        self._lr_override = -1.0  # set_learning_rate: >= 0 replaces the schedule
        self._dense_frozen = False
        self._emb_frozen = False
        self._staged_train_batch: Optional[Dict[str, torch.Tensor]] = None
        self._last_loss: Optional[torch.Tensor] = None
        self._train_iter = None
        self._train_feeder: Optional[DeviceFeeder] = None
        self._train_rows_fifo: collections.deque = collections.deque()
        self._train_eof = False
        self._eval_eof = False
        self._eval_feed_started = False
        self._peek_eval_iter = None
        self._last_read_rows = 0
        self._fused_float = False  # fused rows carry labels and dense as float32 bits
        # the exact i64 fold's maps {table: {i64 key: id}} and their inverses;
        # the train and eval feeder threads insert under the lock
        self._i64_maps: Dict[str, Dict[int, int]] = {}
        self._i64_rev: Dict[str, Dict[int, int]] = {}
        self._i64_lock = threading.Lock()
        self._i64_fold: Optional[Dict[str, list]] = None
        # the synchronous uploads (cached batches, a feed without a thread);
        # each feeder gets an uploader of its own
        self._uploader = Uploader(self.device)
        self.lr_sch = LearningRateScheduler(
            base_lr=solver.lr,
            warmup_steps=solver.warmup_steps,
            decay_start=solver.decay_start,
            decay_steps=solver.decay_steps,
            decay_power=solver.decay_power,
            end_lr=solver.end_lr,
        )

    def add(self, obj: Any) -> None:
        if isinstance(obj, Input):
            if self.input is not None:
                raise ValueError("only one Input supported")
            self.input = obj
        elif isinstance(obj, EmbeddingCollectionConfig):
            self.ebc_configs.append(obj)
        elif isinstance(obj, SparseEmbedding):
            self.sparse_embeddings.append(obj)
        elif isinstance(obj, DenseLayer):
            self.dense_layers.append(obj)
        else:
            raise TypeError(f"cannot add {type(obj)}")

    # -------------------------------------------------------------- compile
    def compile(self, loss_names: Optional[List[str]] = None, loss_weights: Optional[List[float]] = None) -> None:
        """Plan the tables, build the network and the state; `loss_names`
        with `loss_weights` set the tasks' label weights (model.py:207)."""
        if self.input is None:
            raise ValueError("model needs an Input")
        s = self.solver
        inp = self.input
        if loss_names and loss_weights:
            inp.label_weights = dict(zip(loss_names, loss_weights))
        sparse_specs = tuple(
            SparseFeatureSpec(name=p.top_name, slot_nnz=tuple(p.per_slot_nnz()))
            for p in inp.data_reader_sparse_param_array
        )
        self.batch_spec = BatchSpec(
            batch_size=s.batchsize,
            label_dims=tuple(inp.label_dims()),
            label_names=tuple(inp.label_names()),
            dense_dim=inp.dense_dim,
            dense_name=inp.dense_name,
            sparse=sparse_specs,
            key_dtype=np.int64 if s.i64_input_key else np.int32,
        )
        self.eval_batch_spec = dataclasses.replace(self.batch_spec, batch_size=s.batchsize_eval)
        self.world = w = self.rm.data_parallel_size
        for what, n in (("batchsize", s.batchsize), ("batchsize_eval", s.batchsize_eval)):
            if n % w:
                raise ValueError(f"{what} {n} does not split over {w} ranks")
        self._sparse_by_name = {f.name: f for f in sparse_specs}

        # ---- embedding plan (model.py:242-411)
        lookup_cfgs: List[LookupConfig] = []
        self._key_sources: Dict[str, _KeySource] = {}
        self._user_tops: Dict[str, List[str]] = {}
        self._top3d: Dict[str, Tuple[int, int]] = {}  # a SparseEmbedding's top: (slots, ev)
        strategy: List[Tuple[str, List[str]]] = []
        shard_counts: Dict[str, int] = {}
        column_factors: Dict[str, int] = {}
        # column-wise sharding (model.py:248-323): table t with factor f
        # becomes f sub-tables t#col{j} of ev / f columns, made once per
        # table and shared by its lookups, one lookup each; the user top
        # concatenates them in j order
        split_tables: Dict[str, List[EmbeddingTableConfig]] = {}
        for ebc in self.ebc_configs:
            for decl in ebc.lookup_decls:
                feat = self._sparse_by_name.get(decl.bottom_name)
                if feat is None:
                    raise ValueError(f"EBC lookup bottom {decl.bottom_name!r} has no sparse input")
                for sub in self._column_tables(decl, int(ebc.column_factors.get(decl.table.name, 1)),
                                               split_tables):
                    lid = len(lookup_cfgs)
                    top = f"{decl.top_name}:{lid}"
                    lookup_cfgs.append(
                        LookupConfig(
                            lookup_id=lid, table=sub, bottom_name=top, top_name=top,
                            combiner=decl.combiner, max_hotness=feat.total_nnz,
                            sp_weight_name=decl.sp_weight_name,
                        )
                    )
                    self._key_sources[top] = _KeySource(feat.name, 0, feat.total_nnz)
                    self._user_tops.setdefault(decl.top_name, []).append(top)
            plan = ebc.sharding_plan()
            # a split table's strategy entries and shard count cover its sub-tables
            strategy.extend((kind, [t for n in names for t in self._sub_names(n, split_tables)])
                            for kind, names in plan.strategy)
            column_factors.update(plan.column_factors)
            for name in {n for row in ebc.shard_matrix or [] for n in row}:
                for t in self._sub_names(name, split_tables):
                    shard_counts[t] = sum(1 for row in ebc.shard_matrix if name in row)
        for se in self.sparse_embeddings:
            strategy.append(("mp", [self._lower_sparse_embedding(se, lookup_cfgs)]))
        self.ec: Optional[EmbeddingCollection] = None
        if lookup_cfgs:
            plan = compile_plan(
                lookup_cfgs, ShardingPlan(strategy=strategy, column_factors=column_factors), num_shards=w,
                shard_counts=shard_counts, onehot_vocab=s.onehot_vocab, split_vocab=s.split_vocab,
                hot_rows=s.hot_rows, superhot_rows=s.superhot_rows, warm_rows=s.warm_rows,
                shard_rotation=s.shard_rotation, group_rows=s.group_rows,
            )
            self.ec = EmbeddingCollection(
                plan, self.rm, self.opt_params, dtype=s.emb_dtype,
                dense_update_rows=s.dense_update_rows, dense_key_ratio=s.dense_key_ratio,
                state_dtype=s.emb_state_dtype, fwd_partition=s.fwd_partition,
                capacity_factor=s.mp_capacity_factor,
                dense_exchange_cap=s.dense_exchange_cap if s.dense_exchange else 0,
                # the first collection's strategy, as the JAX Model takes it (model.py:398-405)
                comm_strategy=self.ebc_configs[0].comm_strategy if self.ebc_configs else None,
            )

        # ---- dense network (model.py:413-435), on the rank's rows
        b = s.batchsize // w
        input_shapes: Dict[str, Tuple[int, ...]] = {
            name: (b, dim) for name, dim in zip(self.batch_spec.label_names, self.batch_spec.label_dims)
        }
        input_shapes[inp.dense_name] = (b, inp.dense_dim)
        if self.ec is not None:
            for user_top, tops in self._user_tops.items():
                # the user's lookups, before the split merges its tiers back
                input_shapes[user_top] = (
                    (b, *self._top3d[user_top]) if user_top in self._top3d else
                    (b, sum(self.ec.plan.lookups[int(t.rsplit(":", 1)[1])].out_width for t in tops))
                )
        gen = self.rm.generator(s.seed)
        self.network = Network(
            self.dense_layers, input_shapes, gen, self.device, label_weights=inp.label_weights
        )

        # ---- state (model.py:437-460)
        self.dense_opt = DenseOptimizer(self.opt_params)
        self.dopt = self.dense_opt.init(self.network.param_tree())
        self.tables: Dict[str, torch.Tensor] = {}
        self.eopt: Dict[str, Dict[str, torch.Tensor]] = {}
        if self.ec is not None:
            self.tables = self.ec.init(gen)
            self.eopt = self.ec.init_optimizer(self.tables)
        self.train_reader = self._make_reader(train=True)
        self.eval_reader = self._make_reader(train=False)
        self._eval_cache: Optional[List[Dict[str, torch.Tensor]]] = None
        self._last_eval_metrics: Dict[str, float] = {}
        # one accumulator per loss layer (model.py:466-490): the first
        # task's under the plain metric names, the others' by label
        label_dims = dict(zip(self.batch_spec.label_names, self.batch_spec.label_dims))
        accs = {
            spec.label_name: MetricAccumulator(
                s.metrics_spec, batch_size=s.batchsize_eval // w, max_batches=s.max_eval_batches,
                device=self.device, label_dim=label_dims.get(spec.label_name, 1),
                auc_exact_max=s.auc_exact_max, world=w, group=self.rm.data_group,
            )
            for spec in self.network.loss_specs
        }
        self.metrics = accs.pop(self.network.loss_specs[0].label_name)
        self._task_metrics: Dict[str, MetricAccumulator] = accs

    @staticmethod
    def _column_tables(decl, factor: int, split_tables: Dict[str, List[EmbeddingTableConfig]]):
        """The tables of one lookup: the declared one, or for a column
        factor f > 1 its f sub-tables `name#col{j}` of ev / f columns, made
        once per table (model.py:260-300, with its errors)."""
        if factor <= 1:
            return [decl.table]
        t = decl.table
        if t.ev_size % factor:
            raise ValueError(f"table {t.name}: ev_size {t.ev_size} not divisible by column factor {factor}")
        if decl.combiner == Combiner_t.Concat:
            raise NotImplementedError("column-wise sharding with concat combiner")
        if t.name not in split_tables:
            split_tables[t.name] = [
                EmbeddingTableConfig(name=f"{t.name}#col{j}", max_vocabulary_size=t.max_vocabulary_size,
                                     ev_size=t.ev_size // factor, opt_params=t.opt_params,
                                     init_scale=t.init_scale, dynamic_capacity=t.dynamic_capacity)
                for j in range(factor)
            ]
        return split_tables[t.name]

    @staticmethod
    def _sub_names(name: str, split_tables: Dict[str, List[EmbeddingTableConfig]]) -> List[str]:
        """A table's name, or its column sub-tables' names."""
        return [t.name for t in split_tables[name]] if name in split_tables else [name]

    def _lower_sparse_embedding(self, se: SparseEmbedding, lookup_cfgs: List[LookupConfig]) -> str:
        """A SparseEmbedding as one table of `vocabulary_for(W)` rows and one
        lookup per slot (model.py:339-386); returns the table's name."""
        feat = self._sparse_by_name.get(se.bottom_name)
        if feat is None:
            raise ValueError(f"SparseEmbedding bottom {se.bottom_name!r} has no sparse input")
        table = EmbeddingTableConfig(
            name=f"sparse_table_{se.sparse_embedding_name}",
            max_vocabulary_size=se.vocabulary_for(self.rm.num_devices),
            ev_size=se.embedding_vec_size, opt_params=se.optimizer,
        )
        offsets = np.concatenate([[0], np.cumsum(se.slot_size_array)[:-1]]).astype(int) \
            if se.slot_size_array else np.zeros(feat.slot_num, dtype=int)
        col, tops = 0, []
        for si, nnz in enumerate(feat.slot_nnz):
            lid = len(lookup_cfgs)
            top = f"{se.sparse_embedding_name}:{lid}"
            lookup_cfgs.append(LookupConfig(lookup_id=lid, table=table, bottom_name=top, top_name=top,
                                            combiner=Combiner_t(se.combiner), max_hotness=nnz))
            self._key_sources[top] = _KeySource(feat.name, col, col + nnz,
                                                int(offsets[si]) if si < len(offsets) else 0)
            tops.append(top)
            col += nnz
        self._user_tops[se.sparse_embedding_name] = tops
        self._top3d[se.sparse_embedding_name] = (feat.slot_num, se.embedding_vec_size)
        return table.name

    def _hosts(self) -> Tuple[int, int, int]:
        """(the hosts H, this rank's host h, the batch blocks a host holds):
        ranks span H = W / `local_world_size` hosts, host h holding ranks
        [h L, (h + 1) L); host h plays the JAX package's process h."""
        w, local = self.rm.num_devices, self.rm.local_world_size
        if w % local or local % self.rm.ev_parallel_size:
            raise ValueError(f"{w} ranks do not split into hosts of {local} "
                             f"(ev_parallelism {self.rm.ev_parallel_size})")
        hosts = w // local
        return hosts, self.rm.rank // local, self.world // hosts

    def _make_reader(self, train: bool) -> Optional[BaseReader]:
        """The train or the eval reader, by the JAX package's rules
        (model.py:501-637). The eval reader takes `batchsize_eval` and never
        repeats; a missing eval source means synthetic eval batches. Over
        W ranks on H hosts (`_hosts`), host h reads what JAX's process h
        reads, a batch of B / H rows, and each rank takes its data block of
        it (the process-local batch split over the local devices): a
        synthetic batch from seed + 7919 h (eval: + 99991), a Parquet or
        Norm reader over files h::H. The Raw readers take the block's rows
        of the file themselves (`process_index`, `num_processes` of the
        blocks: the same rows). On the ("data", "ev") mesh the ev replicas
        read the same block."""
        rp = self.reader_params
        if rp is None:
            return None
        spec = self.batch_spec if train else self.eval_batch_spec
        src = rp.source[0] if train and rp.source else rp.eval_source
        kind = rp.data_reader_type
        hosts, host, per_host = self._hosts()
        block = (self.rm.data_index % per_host, per_host)
        host_spec = dataclasses.replace(spec, batch_size=spec.batch_size // hosts)
        if kind == DataReaderType_t.Synthetic or not src:
            return SyntheticReader(
                host_spec, self._slot_vocabs(), num_batches=rp.synthetic_num_batches, alpha=rp.synthetic_alpha,
                seed=(self.solver.seed or 1234) + (0 if train else 99991) + 7919 * host,
                learnable_labels=rp.synthetic_learnable, block=block,
            )
        s = self.solver
        repeat = s.repeat_dataset if train else False
        if kind in (DataReaderType_t.Raw, DataReaderType_t.RawAsync):
            from ..data.native_reader import NativeRawReader

            # AsyncParam: fill threads, ring depth, and the float layout of
            # the multi-hot reader; i64 keys fold on the host, so unfused
            ap = rp.async_param
            n_threads = (ap.num_threads if ap is not None else 0) or rp.num_workers
            depth = max(ap.num_batches_per_thread or 6, 2) if ap is not None else 6
            self._fused_float = rp.float_label_dense or bool(
                ap is not None and ap.is_dense_float and ap.multi_hot_reader)
            return NativeRawReader(
                src, dataclasses.replace(spec, batch_size=spec.batch_size // self.world),
                num_samples=rp.num_samples if train else rp.eval_num_samples,
                float_label_dense=self._fused_float, repeat=repeat, n_threads=n_threads,
                queue_depth=depth, fused=not s.i64_input_key, process_index=self.rm.data_index,
                num_processes=self.world,
            )
        ranks = dict(process_index=host, num_processes=hosts)
        if kind == DataReaderType_t.Parquet:
            # fused Parquet rows carry labels and dense as float32 bits
            self._fused_float = True
            reader = AsyncParquetReader(
                src, host_spec, repeat=repeat, drop_incomplete=s.drop_incomplete_batch,
                n_threads=max(rp.num_workers, 1), fused=not s.i64_input_key, **ranks,
            )
        elif kind == DataReaderType_t.Norm:
            reader = NormReader(
                src, host_spec, repeat=repeat, drop_incomplete=s.drop_incomplete_batch,
                slot_size_array=rp.slot_size_array or None, **ranks,
            )
        else:
            raise NotImplementedError(f"reader {kind}")
        return BlockReader(reader, block) if per_host > 1 else reader

    def _slot_vocabs(self) -> Dict[str, List[int]]:
        """Per-slot key bounds of the synthetic reader (model.py:639): each
        table's vocabulary, a dynamic table's capacity, less a
        SparseEmbedding slot's key offset."""
        vocabs = {f.name: [1000] * f.slot_num for f in self.batch_spec.sparse}
        if self.ec is not None:
            for top, ks in self._key_sources.items():
                vocab = int(self.ec.plan.lookups[int(top.rsplit(":", 1)[1])].table.vocabulary_size)
                f = self._sparse_by_name[ks.param_name]
                col = 0
                for si, nnz in enumerate(f.slot_nnz):
                    if col == ks.col_begin:
                        vocabs[f.name][si] = max(vocab - ks.key_offset, 2)
                        break
                    col += nnz
        return vocabs

    # ------------------------------------------------------------ training
    def _put_batch(self, batch: Dict[str, np.ndarray], uploader: Optional[Uploader] = None) -> DeviceBatch:
        """A reader's batch on the device (model.py:1194): the tail's row
        count dropped, i64 keys folded, then uploaded (`Uploader`; through
        pinned memory on a stream of its own on a card)."""
        batch = dict(batch)
        batch.pop(ROWS_KEY, None)
        if self.solver.i64_input_key:
            batch = self._fold_i64_keys(batch)
        return (uploader or self._uploader)(batch)

    def _put_now(self, batch: Dict[str, np.ndarray]) -> DeviceBatch:
        """`_put_batch` on the consumer's thread, ready on its stream."""
        return self._put_batch(batch).ready()

    def _new_feeder(self, reader: BaseReader, put_fn=None) -> DeviceFeeder:
        """A `DeviceFeeder` over `reader` with an uploader of its own
        (`feeder.uploader`); `put_fn(batch, uploader)` defaults to
        `_put_batch`."""
        up = Uploader(self.device)
        put = put_fn or self._put_batch
        feeder = DeviceFeeder(reader, lambda b: put(b, up), depth=3)
        feeder.uploader = up
        return feeder

    # ------------------------------------------------------------ i64 keys
    def _build_i64_fold(self) -> Dict[str, list]:
        """{feature: [(col_begin, col_end, modulo, dynamic, table), ...]}, one
        window a lookup, for the host-side fold of int64 keys
        (model.py:927-955): a static table takes `k mod (vocab - key
        offset)` (exact for keys in range), a dynamic one the exact fold
        (`_i64_exact_fold`). The lookup's own table is used (a split table's
        user-level name), so that every key of it folds in one window."""
        fold: Dict[str, list] = {}
        if self.ec is None:
            return fold
        for top, ks in self._key_sources.items():
            t = self.ec.plan.lookups[int(top.rsplit(":", 1)[1])].table
            fold.setdefault(ks.param_name, []).append(
                (ks.col_begin, ks.col_end, int(t.vocabulary_size) - ks.key_offset, bool(t.is_dynamic),
                 t.name.split("::", 1)[0]))
        return fold

    def _mc_sync_feed(self) -> bool:
        """Whether batches are folded on the consuming thread (model.py:957):
        over W ranks with a dynamic table under i64 keys, each batch's fold
        all-gathers the ranks' new keys, and such collectives must come in
        program order on every rank, which prefetch threads would not keep."""
        if self.world <= 1 or not self.solver.i64_input_key:
            return False
        if self._i64_fold is None:
            self._i64_fold = self._build_i64_fold()
        return any(dyn for ws in self._i64_fold.values() for (_lo, _hi, _mod, dyn, _t) in ws)

    @staticmethod
    def _splitmix31(w: np.ndarray) -> np.ndarray:
        """64 -> 31-bit mix, the exact fold's first probe (model.py:976): it
        relies on uint64 wrap-around, so it stays in numpy; never the key
        store's EMPTY marker 2^31 - 1."""
        m = w.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        f = ((m >> np.uint64(33)) & np.uint64(0x7FFFFFFF)).astype(np.int64)
        return np.where(f == 2**31 - 1, 0, f)

    def _i64_exact_fold(self, tname: str, w: np.ndarray) -> np.ndarray:
        """Every distinct int64 key of window `w` ([B, h], negative keys are
        padding) of dynamic table `tname` as its own 31-bit id
        (model.py:986-1052): new keys, sorted, are placed in turn from
        their `_splitmix31` probe onward (linear probe, wrapping below the
        EMPTY marker), so two keys never share an id. The map depends on
        the order of insertion, which is the JAX package's: the window's
        sorted new keys, window after window. Over W ranks the new keys are
        the sorted union of the ranks' (`_mc_union_missing`), so that each
        rank's map is the one-process run's on the global batch."""
        m = self._i64_maps.setdefault(tname, {})
        rev = self._i64_rev.setdefault(tname, {})
        uq = np.unique(w[w >= 0])
        missing = [k for k in uq.tolist() if k not in m]
        if self.world > 1:
            missing = [k for k in self._mc_union_missing(missing) if k not in m]
        if missing:
            with self._i64_lock:  # the train and eval feeders fold concurrently
                for k, c0 in zip(missing, self._splitmix31(np.asarray(missing))):
                    if k in m:
                        continue
                    c = int(c0)
                    while True:
                        owner = rev.get(c)
                        if owner is None:
                            m[k] = c
                            rev[c] = k
                            break
                        if owner == k:
                            break
                        c += 1
                        if c >= 2**31 - 1:
                            c = 0
        flat = w.reshape(-1)
        neg = flat < 0
        uq2, inv = np.unique(np.where(neg, 0, flat), return_inverse=True)
        lut = np.fromiter((m.get(int(k), 0) for k in uq2), np.int32, len(uq2))
        return np.where(neg, np.int32(INVALID_KEY), lut[inv.reshape(-1)]).reshape(w.shape)

    def _mc_union_missing(self, missing: list) -> list:
        """The sorted union of every rank's new keys (model.py:1054): the
        counts all-gathered, then the keys padded with -1 to the largest
        count (skipped when no rank has a new key). Every rank calls this
        for every window of every batch, in the same order."""
        dev = self.device
        counts = all_gather(torch.tensor([len(missing)], dtype=torch.int64, device=dev), self.rm.data_group)
        mx = int(counts.max())
        if mx == 0:
            return []
        pad = torch.full((mx,), -1, dtype=torch.int64)
        if missing:
            pad[: len(missing)] = torch.tensor(missing, dtype=torch.int64)
        keys = all_gather(pad.to(dev), self.rm.data_group).cpu().numpy()
        return np.unique(keys[keys >= 0]).tolist()

    def _fold_i64_keys(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """A batch's int64 key columns as int32, window by window
        (model.py:1085); -1 stays -1."""
        if self._i64_fold is None:
            self._i64_fold = self._build_i64_fold()
        out = dict(batch)
        for name, windows in self._i64_fold.items():
            if name not in out:
                continue
            k = np.asarray(out[name])
            if k.dtype != np.int64:
                continue
            k32 = np.empty(k.shape, np.int32)
            for lo, hi, modulo, dynamic, tname in windows:
                w = k[:, lo:hi]
                if dynamic:
                    k32[:, lo:hi] = self._i64_exact_fold(tname, w)
                    continue
                f = (w % max(modulo, 1)).astype(np.int32)
                k32[:, lo:hi] = np.where(w < 0, np.int32(INVALID_KEY), f)
            out[name] = k32
        return out

    def _i64_fold_maps_arrays(self) -> Dict[str, np.ndarray]:
        """{"<table>.orig": int64 keys, "<table>.fold": int32 ids} in the
        maps' insertion order, for `i64_fold_maps.npz` (model.py:1110)."""
        arrays: Dict[str, np.ndarray] = {}
        for tname, m in self._i64_maps.items():
            if m:
                arrays[f"{tname}.orig"] = np.fromiter(m.keys(), np.int64, len(m))
                arrays[f"{tname}.fold"] = np.fromiter(m.values(), np.int32, len(m))
        return arrays

    def _restore_i64_fold_maps(self, arrays) -> None:
        """The maps of an `i64_fold_maps.npz` (model.py:1124)."""
        self._i64_maps, self._i64_rev = {}, {}
        for tname in {k.rsplit(".", 1)[0] for k in arrays.keys()}:
            orig = np.asarray(arrays[f"{tname}.orig"]).tolist()
            fold = np.asarray(arrays[f"{tname}.fold"]).tolist()
            self._i64_maps[tname] = dict(zip(orig, fold))
            self._i64_rev[tname] = dict(zip(fold, orig))

    def _decode_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The on-device split of a fused [B, row] int32 batch
        (model.py:659-697, the reference's split_3_way): labels and dense
        are the float32 bits of their columns in the float layout (Parquet,
        or Raw with `float_label_dense`), else int labels as float and int
        dense as log1p(max(x, 0)); each feature is a column view of the
        rows. Other batches pass through."""
        if FUSED_KEY not in batch:
            return batch
        raw = batch[FUSED_KEY]
        s = self.batch_spec
        fld = self._fused_float
        out, off = {}, 0
        for name, dim in zip(s.label_names, s.label_dims):
            col = raw[:, off : off + dim]
            out[name] = col.view(torch.float32) if fld else col.float()
            off += dim
        dn = raw[:, off : off + s.dense_dim]
        out[s.dense_name] = dn.view(torch.float32) if fld else torch.log1p(dn.clamp_min(0).float())
        off += s.dense_dim
        for f in s.sparse:
            out[f.name] = raw[:, off : off + f.total_nnz]
            off += f.total_nnz
        return out

    def start_data_reading(self) -> None:
        """Start the train feed (model.py:1213-1250): synthetic batches, or
        `cache_train_data` batches of any reader, are put on the device once
        and cycled; otherwise a `DeviceFeeder` thread uploads them, and a
        FIFO beside it keeps each batch's tail row count (0 for a whole
        batch) for `read_a_batch_to_device`. Over W ranks with exact i64
        folding the batches are folded and uploaded on this thread, so that
        every rank's collectives come in program order."""
        if self._train_iter is not None:
            return
        if self.train_reader is None:
            raise ValueError("model has no reader")
        cache_n = self.reader_params.cache_train_data
        if not cache_n and isinstance(self.train_reader, SyntheticReader):
            cache_n = self.train_reader.num_batches
        if cache_n:
            it = iter(self.train_reader)
            self._train_iter = itertools.cycle([self._put_now(next(it)) for _ in range(cache_n)])
            return
        self._train_rows_fifo = collections.deque()

        def put_train(b, uploader=None):
            rows = b.get(ROWS_KEY)
            self._train_rows_fifo.append(int(rows) if rows is not None else 0)
            return self._put_batch(b, uploader)

        if self._mc_sync_feed():
            self._train_iter = (put_train(b).ready() for b in self.train_reader)
        else:
            self._train_feeder = self._new_feeder(self.train_reader, put_train)
            self._train_iter = iter(self._train_feeder)

    def _next_train_batch(self) -> DeviceBatch:
        """The next train batch, its tail count popped from the FIFO; a
        source that ran dry marks the train reader at EOF and raises
        StopIteration (model.py:1270-1282)."""
        try:
            batch = next(self._train_iter)
        except StopIteration:
            self._train_eof = True
            raise
        self._last_read_rows = self._train_rows_fifo.popleft() if self._train_rows_fifo else 0
        return batch

    def _feature_keys(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each lookup's key columns of the batch (model.py:741); a
        SparseEmbedding slot's keys (not -1) shifted by its offset."""
        out = {}
        for top, ks in self._key_sources.items():
            k = batch[ks.param_name][:, ks.col_begin : ks.col_end]
            out[top] = torch.where(k >= 0, k + ks.key_offset, k) if ks.key_offset else k
        return out

    def _feature_weights(self, batch: Dict[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
        """The per-key weights of the weighted lookups (model.py:735-755):
        each `sp_weight_name` names a [B, hotness] float feature of the
        batch, taken as float32; None when no lookup is weighted. A missing
        feature raises KeyError naming it."""
        names = {lk.sp_weight_name for lk in self.ec.plan.lookups if lk.sp_weight_name} if self.ec else set()
        if not names:
            return None
        out = {}
        for n in sorted(names):
            if n not in batch:
                raise KeyError(f"weighted lookup needs feature {n!r} in the batch (declare it as an input feature)")
            out[n] = torch.as_tensor(batch[n], device=self.device).float()
        return out

    def _user_tensors(self, emb_outs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The lookups' outputs as the user's tops (model.py:758-772): a
        concatenation, or [B, slots, ev] for a SparseEmbedding."""
        out = {}
        for user_top, tops in self._user_tops.items():
            t = emb_outs[tops[0]] if len(tops) == 1 else torch.cat([emb_outs[t] for t in tops], dim=1)
            if user_top in self._top3d:
                t = t.reshape(t.shape[0], *self._top3d[user_top])
            out[user_top] = t
        return out

    def train_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One iteration on a device batch (the rank's block over W ranks);
        returns the global mean loss as a device tensor without waiting for
        the device (model.py:787-883)."""
        ec = self.ec
        batch = self._decode_batch(batch)
        step = self._step + 1
        # set_learning_rate(x >= 0) replaces the schedule: 0 freezes updates
        ov = self._lr_override
        lr = torch.tensor(ov if ov >= 0 else float(self.lr_sch(step)), dtype=torch.float32, device=self.device)
        feature_keys = self._feature_keys(batch) if ec is not None else {}
        weights = self._feature_weights(batch)
        emb_in: Dict[str, torch.Tensor] = {}
        if ec is not None:
            with torch.no_grad():
                emb_outs = ec.forward(self.tables, feature_keys, weights)
            emb_in = {k: v.detach().requires_grad_(True) for k, v in emb_outs.items()}
        tensors = {
            n: batch[n] for n in (*self.batch_spec.label_names, self.batch_spec.dense_name)
        }
        tensors.update(self._user_tensors(emb_in))
        self.network.train()
        loss, _ = self.network.forward_with_loss(tensors, self.solver.compute_dtype)
        params = self.network.param_tree()
        if self.rm.num_devices > 1:
            # the global-batch mean: loss / W on every rank, summed below
            loss = loss / self.world
            loss.backward()
            loss = self._all_reduce_grads(params, loss.detach(), self.rm)
        else:
            loss.backward()
        if not self._dense_frozen:
            self.dense_opt.update(params, self.dopt, lr, step)
        self.network.zero_grad(set_to_none=True)
        if ec is not None and not self._emb_frozen:
            egrads = {k: v.grad for k, v in emb_in.items()}
            with torch.no_grad():
                ec.backward_and_update(self.tables, self.eopt, feature_keys, egrads, lr, step, weights)
        self._step = step
        return loss.detach()

    @staticmethod
    def _all_reduce_grads(params, loss: torch.Tensor, rm: ResourceManager) -> torch.Tensor:
        """One flat float32 bucket of every dense gradient and the loss, one
        `all_reduce` of it over the data axes, and the sums copied back; on
        the ("data", "ev") mesh the ev group then takes its first rank's
        bucket, so that the ev replicas stay bitwise equal whatever order
        their kernels summed in. Returns the summed loss."""
        grads = [p.grad for ps in params.values() for p in ps.values() if p.grad is not None]
        flat = torch.cat([g.reshape(-1).float() for g in grads] + [loss.reshape(1).float()])
        all_reduce(flat, rm.data_group)
        if rm.ev_parallel_size > 1:
            broadcast(flat, rm.ev_group.ranks[0], rm.ev_group)
        off = 0
        for g in grads:
            g.copy_(flat[off : off + g.numel()].view_as(g))
            off += g.numel()
        return flat[-1]

    def train_async(self) -> torch.Tensor:
        """One training iteration; returns the device loss (model.py:1257).
        A batch staged by `read_a_batch` is taken first."""
        self.start_data_reading()
        batch, self._staged_train_batch = self._staged_train_batch, None
        loss = self.train_step(batch if batch is not None else self._next_train_batch())
        self._iter += 1
        self._last_loss = loss
        return loss

    def train(self) -> float:
        """One training iteration; returns the loss (model.py:1253)."""
        return float(self.train_async())

    # ---------------------------------------------------------------- eval
    def _eval_batches(self):
        """(the eval batches, the feeder that makes them or None, whether
        they come from the reader rather than a cache) (model.py:1292-1355): synthetic eval batches (the first
        min(num_batches, max_eval_batches)) or `cache_eval_data` batches of
        any reader are put on the device once, and cycled to cover
        max_eval_batches when `repeat_dataset` is set; otherwise a new
        `DeviceFeeder` reads the non-repeating eval reader from its start."""
        if self.eval_reader is None:
            raise ValueError("model has no reader")
        n = self.solver.max_eval_batches
        cache_n = self.reader_params.cache_eval_data
        if not cache_n and isinstance(self.eval_reader, SyntheticReader):
            cache_n = min(self.eval_reader.num_batches, n)
        if cache_n:
            if self._eval_cache is None:
                it = iter(self.eval_reader)
                self._eval_cache = [self._put_now(next(it)) for _ in range(cache_n)]
            if self.solver.repeat_dataset and len(self._eval_cache) < n:
                return itertools.islice(itertools.cycle(self._eval_cache), n), None, False
            return iter(self._eval_cache), None, False
        if self._mc_sync_feed():
            return (self._put_now(b) for b in self.eval_reader), None, True
        feeder = self._new_feeder(self.eval_reader)
        return iter(feeder), feeder, True

    @torch.no_grad()
    def _eval_step(self, batch: Dict[str, torch.Tensor]):
        """The forward of one eval batch: (loss, {label: predictions},
        {label: labels}) of the loss layers, on the device (model.py:885)."""
        ec = self.ec
        batch = self._decode_batch(batch)
        emb_outs = (ec.forward(self.tables, self._feature_keys(batch), self._feature_weights(batch))
                    if ec is not None else {})
        tensors = {n: batch[n] for n in (*self.batch_spec.label_names, self.batch_spec.dense_name)}
        tensors.update(self._user_tensors(emb_outs))
        self.network.eval()
        loss, out = self.network.forward_with_loss(tensors, self.solver.compute_dtype)
        labels = {spec.label_name: tensors[spec.label_name] for spec in self.network.loss_specs}
        return loss, self.network.predictions(out), labels

    def _reset_metrics(self) -> None:
        self.metrics.reset()
        for acc in self._task_metrics.values():
            acc.reset()

    def _eval_update(self, batch: Dict[str, torch.Tensor]) -> None:
        """One eval batch into the accumulators: the first task's with the
        loss, each other task's by its label."""
        loss, preds, labels = self._eval_step(batch)
        first = self.network.loss_specs[0].label_name
        self.metrics.update(preds[first], labels[first], loss=loss)
        for name, acc in self._task_metrics.items():
            acc.update(preds[name], labels[name])

    def eval(self) -> Dict[str, float]:
        """One pass over max_eval_batches eval batches; returns the metrics
        (model.py:1390), each other task's as `"<metric>_<label>"`. Losses,
        predictions and labels stay on the device until the metrics are
        finalized. A feeder is stopped once max_eval_batches are taken; a
        file source that runs dry first marks the eval reader at EOF. Every
        row of a padded tail batch counts in the metrics, the repeated last
        row too, as in the JAX package."""
        self._reset_metrics()
        self._eval_feed_started = True
        source, feeder, fed = self._eval_batches()
        n, exhausted = 0, True
        for batch in source:
            if n >= self.solver.max_eval_batches:
                exhausted = False
                break
            self._eval_update(batch)
            n += 1
        if feeder is not None:
            feeder.stop()
        if exhausted and fed:
            self._eval_eof = True
        vals = self.metrics.finalize()
        for name, acc in self._task_metrics.items():
            vals.update({f"{m}_{name}": v for m, v in acc.finalize().items()})
        self._last_eval_metrics = vals
        return vals

    def get_eval_metrics(self) -> List[Tuple[str, float]]:
        """The last eval's metrics as (name, value) pairs (model.py:1929)."""
        return list(self._last_eval_metrics.items())

    # ---------------------------------------------------------------- graph
    def graph_to_json(self, path: str) -> None:
        """Write the graph (model.py:2076-2130) in the JAX package's layout:
        the solver, the Input, the dense layers, the SparseEmbeddings and
        the embedding collections. `PORT_SOLVER_SETTINGS` go under
        "solver_settings", which the JAX package does not read; each dense
        layer also holds `UNPORTED_LAYER_FIELDS`."""
        solver = dataclasses.asdict(self.solver)
        settings = {k: solver.pop(k) for k in PORT_SOLVER_SETTINGS}
        ebcs = []
        for ebc in self.ebc_configs:
            tables = {d.table.name: {"name": d.table.name, "max_vocabulary_size": d.table.max_vocabulary_size,
                                     "ev_size": d.table.ev_size, "dynamic_capacity": d.table.dynamic_capacity}
                      for d in ebc.lookup_decls}
            lookups = [{"table": d.table.name, "bottom_name": d.bottom_name, "top_name": d.top_name,
                        "combiner": d.combiner.value} for d in ebc.lookup_decls]
            ebcs.append({"tables": list(tables.values()), "lookups": lookups,
                         "shard_matrix": ebc.shard_matrix, "shard_strategy": ebc.shard_strategy})
        graph = {
            "solver": solver,
            "solver_settings": settings,
            "input": dataclasses.asdict(self.input),
            "dense_layers": [dict(dataclasses.asdict(d), **UNPORTED_LAYER_FIELDS) for d in self.dense_layers],
            "sparse_embeddings": [dataclasses.asdict(se) for se in self.sparse_embeddings],
            "embedding_collections": ebcs,
        }
        with open(path, "w") as f:
            json.dump(graph, f, default=lambda o: o.item() if isinstance(o, np.generic) else str(o), indent=2)

    @classmethod
    def construct_from_json(cls, graph_path: str, reader_params=None, optimizer: Optional[OptParams] = None,
                            resource_manager: Optional[ResourceManager] = None, compile_model: bool = True,
                            device: DeviceLike = None) -> "Model":
        """A Model from a graph file of either package (model.py:2132-2202).
        The JAX package's Solver fields that the port lacks (its mesh, XLA
        and reference-parity settings) are not read, nor are its engine
        settings left unset (None: the port's defaults hold). A dense
        layer's `UNPORTED_LAYER_FIELDS` must be at their defaults. Equal
        SparseEmbedding optimizers become one `OptParams`, as one object
        passed to each."""
        with open(graph_path) as f:
            graph = json.load(f)
        known = {fl.name for fl in dataclasses.fields(Solver)}
        sol = {k: v for k, v in graph["solver"].items() if k in known and v is not None}
        sol.update(graph.get("solver_settings", {}))
        sol["metrics_spec"] = {Metric_t(k): v for k, v in sol.get("metrics_spec", {}).items()}
        model = cls(Solver(**sol), reader_params, optimizer or OptParams(), resource_manager=resource_manager,
                    device=device)
        inp = dict(graph["input"])
        inp["data_reader_sparse_param_array"] = [
            DataReaderSparseParam(top_name=p["top_name"], nnz_per_slot=p["nnz_per_slot"],
                                  is_fixed_length=p.get("is_fixed_length", True), slot_num=p["slot_num"])
            for p in inp["data_reader_sparse_param_array"]
        ]
        model.add(Input(**inp))
        for e in graph.get("embedding_collections", []):
            tbls = {t["name"]: EmbeddingTableConfig(name=t["name"], max_vocabulary_size=t["max_vocabulary_size"],
                                                    ev_size=t["ev_size"],
                                                    dynamic_capacity=t.get("dynamic_capacity", 2**22))
                    for t in e["tables"]}
            ebc = EmbeddingCollectionConfig()
            for lk in e["lookups"]:
                ebc.embedding_lookup(tbls[lk["table"]], lk["bottom_name"], lk["top_name"], lk["combiner"])
            if e.get("shard_strategy"):
                ebc.shard(shard_matrix=e.get("shard_matrix") or [list(tbls)] * model.rm.num_devices,
                          shard_strategy=[(k, v) for k, v in e["shard_strategy"]])
            model.add(ebc)
        opts: List[OptParams] = []
        for se in graph.get("sparse_embeddings", []):
            se = dict(se)
            if isinstance(se.get("optimizer"), dict):
                opt = OptParams(**se["optimizer"])
                se["optimizer"] = next((o for o in opts if o == opt), opt)
                if se["optimizer"] is opt:
                    opts.append(opt)
            model.add(SparseEmbedding(**se))
        for d in graph["dense_layers"]:
            d = dict(d)
            d.pop("compute_config", None)
            for k, default in UNPORTED_LAYER_FIELDS.items():
                if k in d and d.pop(k) != default:
                    raise NotImplementedError(f"layer {d['layer_type']}: {k} belongs to a layer that is not "
                                              "ported yet (ROADMAP Queue 1 item 7)")
            if d.get("ranges"):
                d["ranges"] = [tuple(r) for r in d["ranges"]]
            model.add(DenseLayer(**d))
        if compile_model:
            model.compile()
        return model

    def fit(self, num_epochs: int = 0, max_iter: int = 1000, display: int = 200,
            eval_interval: int = 1000, snapshot: int = 0, snapshot_prefix: str = "./snapshot") -> None:
        """The training loop (model.py:1441): `max_iter` iterations (or
        `num_epochs` passes over the train reader), the loss checked and
        logged every `display` iterations (a non-finite loss raises), an
        eval every `eval_interval` iterations, stopping early once a metric
        passes its threshold in `metrics_spec` or a callback's
        `on_eval_end` returns True, a snapshot `{snapshot_prefix}_iter{k}`
        after every `snapshot`-th iteration. The callbacks and the
        `:::MLLOG` events (`Solver.perf_logging`) come in the JAX package's
        order (model.py:1455-1505). Over W ranks every rank runs the loop
        and rank 0 logs and writes."""
        say = get_logger().info if self.rm.is_master_process() else (lambda msg: None)
        for cb in self.callbacks:
            cb.on_training_start(self)
        self.start_data_reading()
        if num_epochs > 0:
            max_iter = num_epochs * max(self.train_reader.num_batches, 1)
        t0 = window_t0 = time.time()
        window_iter = 0
        if self.solver.perf_logging:
            self._perf_log("init_start")
            self._perf_log("run_start")
        stop = False
        for it in range(1, max_iter + 1):
            loss_dev = self.train_async()
            if display and it % display == 0:
                loss = float(loss_dev)  # one host sync per display window
                if not np.isfinite(loss):
                    raise RuntimeError(f"NaN/Inf loss at iter {it}: training stopped")
                dt = time.time() - window_t0
                ips = (it - window_iter) * self.solver.batchsize / max(dt, 1e-9)
                say(f"Iter: {it} Time: {dt:.3f}s Loss: {loss:.6f} "
                    f"lr: {self.lr_sch.get_next(it):.6f} ({ips:,.0f} ex/s)")
                window_t0, window_iter = time.time(), it
            if eval_interval and it % eval_interval == 0:
                for cb in self.callbacks:
                    cb.on_eval_start(self, it)
                if self.solver.perf_logging:
                    self._perf_log("eval_start", iteration=it)
                vals = self.eval()
                if self.solver.perf_logging:
                    self._perf_log("eval_accuracy", iteration=it, **vals)
                say(f"Evaluation at iter {it}: {vals}")
                for cb in self.callbacks:
                    stop = cb.on_eval_end(self, it, vals) or stop
                if self.metrics.check_earlystop(vals):
                    say(f"Hit target metric at iter {it}: {vals}; early stop")
                    stop = True
            if snapshot and it % snapshot == 0:
                self.download_params_to_files(snapshot_prefix, it)
            if stop:
                break
        for cb in self.callbacks:
            cb.on_training_end(self, self._iter)
        if self.solver.perf_logging:
            self._perf_log("run_stop", iteration=self._iter)
        total = time.time() - t0
        say(f"fit done: {self._iter} iters in {total:.1f}s "
            f"({self._iter * self.solver.batchsize / max(total, 1e-9):,.0f} ex/s)")

    # ----------------------------------------------------------- persistence
    def _row_sharded(self, name: str) -> bool:
        """Whether storage array `name` (a group, or its key store
        `"{group}#keys"`) is row-sharded over the ranks: the rank holds
        block r of the JAX package's global array."""
        if self.ec is None or self.world == 1:
            return False
        base = name.split("#keys", 1)[0]
        return any(g.name == base and g.is_model_parallel for g in self.ec.plan.groups)

    def _sharded_host(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """A storage array (table, state or key store of group `name`) as
        the JAX package's global array on the host: a row-sharded group's
        blocks all-gathered in rank order (every rank calls this
        together)."""
        t = t.detach()
        return (all_gather(t.contiguous(), self.rm.data_group) if self._row_sharded(name) else t).cpu()

    def _rank_block(self, arr, name: str):
        """This rank's rows of the JAX package's global array of group
        `name` (block r of a row-sharded group, else all of it)."""
        if not self._row_sharded(name):
            return arr
        n = self.tables[name].shape[0]
        return arr[self.rm.data_index * n : (self.rm.data_index + 1) * n]

    def _dense_flat(self) -> Dict[str, torch.Tensor]:
        """`dense/<layer>/<key>` and `dopt/<slot>/<layer>/<key>`, as the
        JAX package's `_flatten` names them (model.py:1526-1535), each
        level in sorted order as the JAX state's trees come back; the port's
        layers keep no `net_state`."""
        def flat(tree, prefix):
            for k in sorted(tree):
                if isinstance(tree[k], dict):
                    yield from flat(tree[k], f"{prefix}{k}/")
                else:
                    yield f"{prefix}{k}", tree[k]

        return dict(itertools.chain(flat(self.network.param_tree(), "dense/"), flat(self.dopt, "dopt/")))

    def _user_table_names(self) -> List[str]:
        """Every table of every group (a split table's tiers), then each
        split table's user-level name (model.py:1553-1568)."""
        if self.ec is None:
            return []
        return [t.name for g in self.ec.plan.groups for t in g.tables] + list(self.ec.plan.table_splits)

    def download_params_to_files(self, prefix: str, iteration: int) -> None:
        """Write `{prefix}_iter{iteration}/` (model.py:1513-1633):
        `dense_model.npz`, `emb_opt_states/<group>.<slot>.npy` (the raw
        storage arrays, over W ranks the global array),
        `sparse_<table>/emb_vector.npy` for every table of every group and
        for each split table's merged view, `keystore_<group>.npy` for each
        dynamic group and `meta.json` (iteration, step and the layout
        stamp), and `i64_fold_maps.npz` where the exact i64 fold holds keys.
        `prefix` may be a remote URL (`io/filesystem.py`)."""
        out_dir = f"{prefix}_iter{iteration}"
        write = self.rm.is_master_process()
        if write:
            iofs.makedirs(out_dir)
            iofs.save_npz(os.path.join(out_dir, "dense_model.npz"), **self._dense_flat())
        if self.ec is not None:
            edir = os.path.join(out_dir, "emb_opt_states")
            if write:
                iofs.makedirs(edir)
            for gname, st in self.eopt.items():
                for slot, arr in st.items():
                    host = self._sharded_host(arr, gname)
                    if write:
                        iofs.save_npy(os.path.join(edir, f"{gname}.{slot}.npy"), host)
            for name in self._user_table_names():
                arr = self.ec.export_rows(self.tables, name)
                if write:
                    tdir = os.path.join(out_dir, f"sparse_{name}")
                    iofs.makedirs(tdir)
                    iofs.save_npy(os.path.join(tdir, "emb_vector.npy"), arr)
            for name, arr in self.tables.items():
                if name.endswith("#keys"):
                    host = self._sharded_host(arr, name)
                    if write:
                        iofs.save_npy(os.path.join(out_dir, f"keystore_{name[: -len('#keys')]}.npy"), host)
        # the exact i64 fold's maps: the key stores hold folded ids, which
        # mean nothing without them (every rank holds the same maps)
        fold_maps = self._i64_fold_maps_arrays()
        if write and fold_maps:
            iofs.save_npz(os.path.join(out_dir, "i64_fold_maps.npz"), **fold_maps)
        if write:
            with iofs.open_file(os.path.join(out_dir, "meta.json"), "w") as f:
                json.dump({"iteration": iteration, "step": int(self._step),
                           "shard_rotation": int(self._rotated_layout())}, f)
            get_logger().info(f"snapshot written to {out_dir}")
        if self.world > 1:  # every rank returns once the files are written
            all_reduce(torch.zeros(1, device=self.device), self.rm.data_group)

    def save_params_to_files(self, prefix: str, iteration: int = 0) -> None:
        """`download_params_to_files` under the reference's name (model.py:1721)."""
        self.download_params_to_files(prefix, iteration)

    def _rotated_layout(self) -> bool:
        """Whether the shard rotation moves rows of this model's storage: a
        model-parallel group over more than one shard with a table whose
        rotation is not 0 modulo the shards (model.py:1623-1633)."""
        if self.ec is None:
            return False
        return any(g.is_model_parallel and g.num_shards > 1 and any(int(r) % g.num_shards for r in g.table_rotation)
                   for g in self.ec.plan.groups)

    @staticmethod
    def _refuse_unported_files(out_dir: str) -> None:
        """A snapshot file the port cannot represent raises, since skipping
        it would lose state: the packed table-and-state arrays."""
        if not iofs.isdir(out_dir):
            return
        names = iofs.listdir(out_dir)
        packed = [n for n in names if n.startswith("packed_") and n.endswith(".npy")]
        if packed:
            raise NotImplementedError(
                f"{out_dir}: {packed} hold the packed table-and-state layout (the JAX package's "
                "HCTR_TPU_PACKED_STATE), which the port leaves out on purpose (ROADMAP Queue 1, "
                "'Left out on purpose'); skipping it would lose the optimizer state")

    @torch.no_grad()
    def _put(self, dst: torch.Tensor, src, what: str) -> None:
        """Copy a loaded array (numpy, or a bfloat16 tensor) into `dst`."""
        t = src if isinstance(src, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(src))
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"{what}: shape {tuple(t.shape)} != {tuple(dst.shape)}")
        dst.copy_(t.to(dst.device))

    def load_params_from_files(self, out_dir: str) -> None:
        """Restore a snapshot of either package (model.py:1635-1718): the
        layout stamp is checked first; then the dense parameters and their
        state, every table in key order, the key stores, the i64 fold's
        maps, the sparse optimizer state, the step and the iteration. Each rank takes its
        own rows."""
        meta_path = os.path.join(out_dir, "meta.json")
        if iofs.exists(meta_path):
            with iofs.open_file(meta_path, "r") as f:
                saved = int(json.load(f).get("shard_rotation", 0))
            cur = int(self._rotated_layout())
            if saved != cur:
                raise ValueError(
                    f"snapshot {out_dir} was written with shard_rotation={saved} but this model compiled with "
                    f"{cur}: raw storage layouts differ (optimizer states and key stores would silently "
                    f"misalign). Build the model with Solver(shard_rotation={bool(saved)}), or re-export via "
                    "embedding_dump (positional per-table format, layout-independent).")
        self._refuse_unported_files(out_dir)
        self._load_dense(out_dir, params=True, dopt=True)
        if self.ec is not None:
            for g in self.ec.plan.groups:
                for t in g.tables:
                    path = os.path.join(out_dir, f"sparse_{t.name}", "emb_vector.npy")
                    if iofs.exists(path):
                        self.ec.import_table(self.tables, t.name, iofs.load_npy(path))
            self._load_key_stores(out_dir)
            fmap = os.path.join(out_dir, "i64_fold_maps.npz")
            if iofs.exists(fmap):
                self._restore_i64_fold_maps(iofs.load_npz(fmap))
            edir = os.path.join(out_dir, "emb_opt_states")
            if iofs.isdir(edir):
                self._load_eopt({f"{g}.{slot}": os.path.join(edir, f"{g}.{slot}.npy")
                                 for g, st in self.eopt.items() for slot in st})
        with iofs.open_file(meta_path, "r") as f:
            meta = json.load(f)
        self._step = int(meta.get("step", 0))
        self._iter = int(meta.get("iteration", 0))

    def _load_key_stores(self, out_dir: str) -> None:
        """Each dynamic group's `keystore_<group>.npy`, this rank's block."""
        for name in [n for n in self.tables if n.endswith("#keys")]:
            p = os.path.join(out_dir, f"keystore_{name[: -len('#keys')]}.npy")
            if iofs.exists(p):
                self._put(self.tables[name], self._rank_block(iofs.load_npy(p), name), f"key store {name}")

    def _load_eopt(self, paths: Dict[str, str]) -> None:
        """{"<group>.<slot>": path} of raw state arrays, the files that
        exist; this rank's block of each."""
        for key, p in paths.items():
            gname, slot = key.rsplit(".", 1)
            if iofs.exists(p):
                self._put(self.eopt[gname][slot], self._rank_block(iofs.load_npy(p), gname),
                          f"sparse state {key}")

    def _load_dense(self, path: str, params: bool, dopt: bool) -> None:
        """The dense parameters and/or their state from a snapshot dir or a
        `dense_model.npz` (model.py:1726-1729)."""
        data = iofs.load_npz(path if path.endswith(".npz") else os.path.join(path, "dense_model.npz"))
        for key, t in self._dense_flat().items():
            if (params and key.startswith("dense/")) or (dopt and key.startswith("dopt/")):
                self._put(t, data[key], f"dense member {key}")

    def load_dense_weights(self, path: str) -> None:
        """Only the dense parameters, from a snapshot dir or its
        `dense_model.npz` (model.py:1731)."""
        self._load_dense(path, params=True, dopt=False)

    def load_dense_optimizer_states(self, path: str) -> None:
        """Only the dense optimizer state (model.py:1752)."""
        self._load_dense(path, params=False, dopt=True)

    def _sparse_sources(self, paths) -> Dict[str, str]:
        """{table: emb_vector.npy path} of a snapshot dir (a split table's
        merged view in place of its tiers), a list of `sparse_<table>` dirs,
        or a {table: path} dict (model.py:1767)."""
        if self.ec is None:
            return {}
        if isinstance(paths, str):
            out = {n: p for n in self._user_table_names()
                   if iofs.exists(p := os.path.join(paths, f"sparse_{n}", "emb_vector.npy"))}
            for user, subs in self.ec.plan.table_splits.items():
                if user in out:
                    for sub, _off in subs:
                        out.pop(sub, None)
            return out
        if isinstance(paths, dict):
            return dict(paths)
        out = {}
        for p in paths:
            base = os.path.basename(p.rstrip("/"))
            name = base[len("sparse_"):] if base.startswith("sparse_") else base
            f = os.path.join(p, "emb_vector.npy")
            out[name] = f if iofs.exists(f) else p
        return out

    def load_sparse_weights(self, sparse_embedding_files) -> None:
        """Tables from a snapshot dir, a list of `sparse_<table>` dirs or a
        {table: path} dict, each with the `key_store.npy` beside it if there
        is one; a snapshot dir's `keystore_<group>.npy` too (model.py:1796)."""
        if isinstance(sparse_embedding_files, str):
            self._refuse_unported_files(sparse_embedding_files)
        for name, path in self._sparse_sources(sparse_embedding_files).items():
            self.ec.import_table(self.tables, name, iofs.load_npy(path))
            kpath = os.path.join(os.path.dirname(path), "key_store.npy")
            if iofs.exists(kpath):
                self.ec.import_key_store(self.tables, name, iofs.load_npy(kpath))
        if isinstance(sparse_embedding_files, str) and self.ec is not None:
            self._load_key_stores(sparse_embedding_files)

    def load_sparse_optimizer_states(self, path) -> None:
        """Sparse optimizer state from a snapshot dir, its `emb_opt_states/`
        or a {"<group>.<slot>": path} dict (model.py:1828)."""
        if self.ec is None:
            return
        if isinstance(path, dict):
            self._load_eopt(path)
            return
        in_edir = os.path.basename(path.rstrip("/")) == "emb_opt_states"
        self._refuse_unported_files(os.path.dirname(path.rstrip("/")) if in_edir else path)
        edir = path if in_edir else os.path.join(path, "emb_opt_states")
        self._load_eopt({f"{g}.{slot}": os.path.join(edir, f"{g}.{slot}.npy")
                         for g, st in self.eopt.items() for slot in st})

    def embedding_dump(self, dump_path: str, table_names=None) -> None:
        """`{dump_path}/{table}/emb_vector.npy`, and `key_store.npy` for a
        dynamic table, of the given tables (default: every unsplit table and
        each split table's user-level name) (model.py:1853)."""
        if self.ec is None:
            raise RuntimeError("no embedding collection in this model")
        if table_names is None:
            table_names = [t.name for g in self.ec.plan.groups for t in g.tables if "::" not in t.name] + list(
                self.ec.plan.table_splits)
        write = self.rm.is_master_process()
        for name in table_names:
            arr = self.ec.export_rows(self.tables, name)
            ks = self.ec.export_key_store(self.tables, name)
            if write:
                tdir = os.path.join(dump_path, name)
                iofs.makedirs(tdir)
                iofs.save_npy(os.path.join(tdir, "emb_vector.npy"), arr)
                if ks is not None:
                    iofs.save_npy(os.path.join(tdir, "key_store.npy"), ks)

    def embedding_load(self, load_path: str, table_names=None) -> None:
        """Tables written by `embedding_dump` (default: every dir under
        `load_path` with an `emb_vector.npy`) (model.py:1878)."""
        if self.ec is None:
            raise RuntimeError("no embedding collection in this model")
        if table_names is None:
            table_names = [d for d in iofs.listdir(load_path)
                           if iofs.exists(os.path.join(load_path, d, "emb_vector.npy"))]
        for name in table_names:
            self.ec.import_table(self.tables, name, iofs.load_npy(os.path.join(load_path, name, "emb_vector.npy")))
            kpath = os.path.join(load_path, name, "key_store.npy")
            if iofs.exists(kpath):
                self.ec.import_key_store(self.tables, name, iofs.load_npy(kpath))

    # ---------------------------------------------- low-level training API
    def set_learning_rate(self, lr: float) -> None:
        """The learning rate of the next steps (model.py:1896): lr >= 0
        replaces the schedule (0 freezes the updates), lr < 0 restores it."""
        self._lr_override = float(lr)

    def get_learning_rate_scheduler(self) -> LearningRateScheduler:
        """The host-side scheduler (model.py:1903; `get_next(step)`)."""
        return self.lr_sch

    def reset_learning_rate_scheduler(self, base_lr, warmup_steps=1, decay_start=0, decay_steps=1,
                                      decay_power=2.0, end_lr=0.0) -> None:
        """A new schedule for the next steps (model.py:1908)."""
        self.lr_sch = LearningRateScheduler(base_lr, warmup_steps, decay_start, decay_steps, decay_power, end_lr)

    def get_current_loss(self) -> float:
        """The loss of the last train() call, 0.0 before any (model.py:1923)."""
        return float(self._last_loss) if self._last_loss is not None else 0.0

    def _close_readers(self) -> None:
        """Stop the train feed's thread and close both readers (the native
        reader's threads)."""
        if self._train_feeder is not None:
            self._train_feeder.stop()
        for r in (self.train_reader, self.eval_reader):
            if r is not None:
                r.close()

    def get_data_reader_train(self) -> _DataReaderHandle:
        """The train reader's handle (model.py:1934)."""
        return _DataReaderHandle(self, train=True)

    def get_data_reader_eval(self) -> _DataReaderHandle:
        """The eval reader's handle (model.py:1940)."""
        return _DataReaderHandle(self, train=False)

    def set_source(self, source=None, eval_source: str = "") -> None:
        """Re-point the readers at new sources (model.py:1942-1969), with
        `data_source_params.make_uri` applied: the old reader's feed stops
        and it is closed, the new reader starts from its first batch and
        EOF is cleared; training goes on from the current state. A new eval
        source also drops the eval cache and the reader that
        `read_a_batch(is_train=False)` was reading."""
        dsp = self.reader_params.data_source_params
        mk = dsp.make_uri if dsp is not None else (lambda p: p)
        if source is not None:
            self.reader_params.source = [mk(source)] if isinstance(source, str) else [mk(p) for p in source]
            if self._train_feeder is not None:
                self._train_feeder.stop()
            if self.train_reader is not None:
                self.train_reader.close()
            self.train_reader = self._make_reader(train=True)
            self._train_iter = None
            self._train_feeder = None
            self._train_eof = False
        if eval_source:
            self.reader_params.eval_source = mk(eval_source)
            if self.eval_reader is not None:
                self.eval_reader.close()
            self.eval_reader = self._make_reader(train=False)
            self._eval_cache = None
            self._peek_eval_iter = None
            self._eval_eof = False

    def update_label_weights(self, label_names, label_weights) -> None:
        """New weights of the tasks' losses for the next steps
        (model.py:1971)."""
        if len(label_names) != len(label_weights):
            raise ValueError("label_names and label_weights length mismatch")
        w = dict(zip(label_names, (float(x) for x in label_weights)))
        missing = [n for n in w if n not in {s.label_name for s in self.network.loss_specs}]
        if missing:
            raise ValueError(f"unknown label names: {missing}")
        for spec in self.network.loss_specs:
            spec.weight = w.get(spec.label_name, spec.weight)
        self.input.label_weights = {**(self.input.label_weights or {}), **w}

    def get_params_num(self) -> int:
        """The dense parameters' elements plus each table's vocab x ev (a
        split table's tiers partition its rows) (model.py:1994)."""
        n = sum(p.numel() for ps in self.network.param_tree().values() for p in ps.values())
        if self.ec is not None:
            n += sum(int(v) * g.ev_size for g in self.ec.plan.groups for v in g.table_vocab)
        return int(n)

    def copy_weights_for_evaluation(self) -> None:
        """A no-op: train and eval share one set of weights (model.py:2010)."""

    def read_a_batch(self, is_train: bool = True) -> bool:
        """Stage the next train batch, which the next train() takes, or read
        the next eval batch on the host (model.py:2015-2040); False once a
        non-repeating source ran dry (EOF). The true row count of the batch
        read goes to the reader handle's `read_a_batch_to_device`."""
        if is_train:
            self.start_data_reading()
            if self._staged_train_batch is not None:
                get_logger().warning("read_a_batch: overwriting a staged train batch that train() never took")
            try:
                self._staged_train_batch = self._next_train_batch()
            except StopIteration:
                self._staged_train_batch = None
                return False
            return True
        if self.eval_reader is None:
            raise ValueError("model has no reader")
        self._eval_feed_started = True
        if self._peek_eval_iter is None:
            self._peek_eval_iter = iter(self.eval_reader)
        try:
            b = next(self._peek_eval_iter)
        except StopIteration:
            self._eval_eof = True
            self._peek_eval_iter = None
            return False
        rows = b.get(ROWS_KEY)
        self._last_read_rows = int(rows) if rows is not None else 0
        return True

    def _perf_log(self, key: str, **kw) -> None:
        """An MLPerf-style event (model.py:2044), on rank 0."""
        if self.rm.is_master_process():
            payload = {"key": key, "time_ms": int(time.time() * 1000), **kw}
            get_logger().info(f":::MLLOG {json.dumps(payload)}")

    def check_overflow(self) -> Dict[str, float]:
        """The largest |value| of each group's table (model.py:2052)."""
        return check_embedding_overflow(self)

    def summary(self) -> str:
        """The layer table the JAX package prints (model.py:2058)."""
        lines = ["=" * 80, f"{'Layer Type':<28}{'Input':<26}{'Output':<26}", "=" * 80]
        if self.ec is not None:
            for user_top in self._user_tops:
                lines.append(f"{'EmbeddingCollection':<28}{'(sparse keys)':<26}{user_top:<26}")
        for row in self.network.summary_rows():
            lines.append(f"{row[0]:<28}{row[1]:<26}{row[2]:<26}")
        lines.append("=" * 80)
        out = "\n".join(lines)
        if self.rm.is_master_process():
            get_logger().info("\n" + out)
        return out

    def freeze_dense(self) -> None:
        """The dense parameters and their state take no update (model.py:2204)."""
        self._dense_frozen = True

    def unfreeze_dense(self) -> None:
        self._dense_frozen = False

    def freeze_embedding(self, embedding_name: Optional[str] = None) -> None:
        """No sparse update (model.py:2213): of the table `embedding_name`
        (a split table's user-level name freezes its tiers), or without a
        name of the whole collection."""
        if embedding_name is None:
            self._emb_frozen = True
            return
        if self.ec is None:
            raise ValueError("no embedding collection in this model")
        if embedding_name not in self.ec.plan.table_splits:
            self.ec._find_table(embedding_name)  # raises KeyError for an unknown table
        self.ec.frozen_tables.add(embedding_name)

    def unfreeze_embedding(self, embedding_name: Optional[str] = None) -> None:
        """Undo `freeze_embedding` (model.py:2226); without a name, every
        table."""
        if embedding_name is None:
            self._emb_frozen = False
            if self.ec is not None:
                self.ec.frozen_tables.clear()
        elif self.ec is not None:
            self.ec.frozen_tables.discard(embedding_name)

    @torch.no_grad()
    def check_out_tensor(self, tensor_name: str, batch=None) -> np.ndarray:
        """The named tensor of the forward in eval mode on `batch` (a numpy
        or device batch; default the next train batch) (model.py:2235);
        bfloat16 as float32."""
        if batch is None:
            self.start_data_reading()
            batch = self._next_train_batch()
        elif not all(isinstance(v, torch.Tensor) for v in batch.values()):
            batch = self._put_now(batch)
        batch = self._decode_batch(batch)
        emb_outs = (self.ec.forward(self.tables, self._feature_keys(batch), self._feature_weights(batch))
                    if self.ec is not None else {})
        tensors = {n: batch[n] for n in (*self.batch_spec.label_names, self.batch_spec.dense_name)}
        tensors.update(self._user_tensors(emb_outs))
        self.network.eval()
        out = self.network(tensors, self.solver.compute_dtype)[tensor_name]
        return (out.float() if out.dtype == torch.bfloat16 else out).cpu().numpy()
