"""High-level Model API: add / compile / train / eval / fit (counterpart of
hugectr_tpu/model/model.py: `Model.__init__`/`add`/`compile` :152-498,
`train_step` :787-883, `train`/`train_async` :1253/:1257, `eval` :1390,
`fit` :1441).

`compile` takes the Solver's embedding dtype (float32 or bfloat16 tables
and optimizer state), mixed precision (bf16 products in the dense network)
and the hot/cold/superhot split of big tables.

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
cotangents are then those of the global-batch mean. The dense gradients
and the loss go into one flat float32 bucket and one `all_reduce` a step;
then every rank runs the same dense update. No
`DistributedDataParallel`: the update is the port's `DenseOptimizer`, as
the JAX step is a plain sum. `train()` returns the global mean loss, and
`eval` the metrics of the global eval set. Every rank calls `train`,
`eval` and `fit` together.

`eval` runs one eager forward under `no_grad` per batch of the eval set
(synthetic eval batches made once and kept on the device, cycled to fill
`max_eval_batches` when `repeat_dataset` is set) into a `MetricAccumulator`,
with no host sync per batch. The JAX package's scanned eval (many batches in
one XLA dispatch) is a device of XLA's and is not ported.

Snapshots, i64 key folding, callbacks and the file readers wait for later
slices.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import DataReaderParams, DenseLayer, Input, Solver
from ..core.logger import get_logger
from ..core.mesh import DeviceLike, ResourceManager, all_reduce
from ..core.types import DataReaderType_t
from ..data.reader import BatchSpec, SparseFeatureSpec, SyntheticReader
from ..embedding.collection import EmbeddingCollection
from ..embedding.config import EmbeddingCollectionConfig
from ..layers.network import Network
from ..metrics.metrics import MetricAccumulator
from ..optim.dense import DenseOptimizer
from ..optim.lr_schedule import LearningRateScheduler
from ..optim.params import OptParams
from ..parallel.plan import LookupConfig, ShardingPlan, compile_plan


@dataclasses.dataclass
class _KeySource:
    param_name: str
    col_begin: int
    col_end: int


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
        self.rm = resource_manager or ResourceManager.create(device=device)
        self.device = self.rm.device
        self.input: Optional[Input] = None
        self.dense_layers: List[DenseLayer] = []
        self.ebc_configs: List[EmbeddingCollectionConfig] = []
        self._step = 0
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
        elif isinstance(obj, DenseLayer):
            self.dense_layers.append(obj)
        else:
            raise TypeError(f"cannot add {type(obj)}")

    # -------------------------------------------------------------- compile
    def compile(self) -> None:
        if self.input is None:
            raise ValueError("model needs an Input")
        s = self.solver
        if s.i64_input_key:
            raise NotImplementedError("i64 input keys are not ported yet (ROADMAP Queue 1 item 6d)")
        inp = self.input
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
        )
        self.eval_batch_spec = dataclasses.replace(self.batch_spec, batch_size=s.batchsize_eval)
        self.world = w = self.rm.data_parallel_size
        if w > 1 and (s.use_mixed_precision or s.emb_dtype != torch.float32
                      or s.emb_state_dtype != torch.float32 or s.hot_rows):
            raise NotImplementedError(
                "bf16 tables or state, mixed precision and the hot/cold split over more than one "
                "rank are not ported yet (ROADMAP Queue 1 item 1e)"
            )
        for what, n in (("batchsize", s.batchsize), ("batchsize_eval", s.batchsize_eval)):
            if n % w:
                raise ValueError(f"{what} {n} does not split over {w} ranks")
        self._sparse_by_name = {f.name: f for f in sparse_specs}

        # ---- embedding plan (model.py:242-411)
        lookup_cfgs: List[LookupConfig] = []
        self._key_sources: Dict[str, _KeySource] = {}
        self._user_tops: Dict[str, List[str]] = {}
        strategy: List[Tuple[str, List[str]]] = []
        shard_counts: Dict[str, int] = {}
        for ebc in self.ebc_configs:
            for decl in ebc.lookup_decls:
                feat = self._sparse_by_name.get(decl.bottom_name)
                if feat is None:
                    raise ValueError(f"EBC lookup bottom {decl.bottom_name!r} has no sparse input")
                lid = len(lookup_cfgs)
                top = f"{decl.top_name}:{lid}"
                lookup_cfgs.append(
                    LookupConfig(
                        lookup_id=lid, table=decl.table, bottom_name=top, top_name=top,
                        combiner=decl.combiner, max_hotness=feat.total_nnz,
                    )
                )
                self._key_sources[top] = _KeySource(feat.name, 0, feat.total_nnz)
                self._user_tops.setdefault(decl.top_name, []).append(top)
            strategy.extend(ebc.sharding_plan().strategy)
            for name in {n for row in ebc.shard_matrix or [] for n in row}:
                shard_counts[name] = sum(1 for row in ebc.shard_matrix if name in row)
        self.ec: Optional[EmbeddingCollection] = None
        if lookup_cfgs:
            plan = compile_plan(
                lookup_cfgs, ShardingPlan(strategy=strategy), num_shards=w,
                shard_counts=shard_counts, onehot_vocab=s.onehot_vocab, split_vocab=s.split_vocab,
                hot_rows=s.hot_rows, superhot_rows=s.superhot_rows, warm_rows=s.warm_rows,
                shard_rotation=s.shard_rotation,
            )
            self.ec = EmbeddingCollection(
                plan, self.rm, self.opt_params, dtype=s.emb_dtype,
                dense_update_rows=s.dense_update_rows, dense_key_ratio=s.dense_key_ratio,
                state_dtype=s.emb_state_dtype,
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
                    b, sum(self.ec.plan.lookups[int(t.rsplit(":", 1)[1])].out_width for t in tops)
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
        self._train_iter = None
        self._eval_cache: Optional[List[Dict[str, torch.Tensor]]] = None
        self._last_eval_metrics: Dict[str, float] = {}
        label_dims = dict(zip(self.batch_spec.label_names, self.batch_spec.label_dims))
        if len(self.network.loss_specs) != 1:
            raise NotImplementedError("eval of multi-task models is not ported yet")
        self.metrics = MetricAccumulator(
            s.metrics_spec, batch_size=s.batchsize_eval // w, max_batches=s.max_eval_batches,
            device=self.device, label_dim=label_dims.get(self.network.loss_specs[0].label_name, 1),
            auc_exact_max=s.auc_exact_max, world=w,
        )

    def _make_reader(self, train: bool) -> Optional[SyntheticReader]:
        """The train or the eval reader (model.py:501); the eval reader
        takes the eval batch size and the seed + 99991. Over W ranks, rank r
        reads its block of each global batch from the same seed; ranks on
        more than one host would take the JAX package's multi-host rule
        (seed + 7919 * process, model.py:506-527), which is not ported."""
        rp = self.reader_params
        if rp is None:
            return None
        if rp.data_reader_type != DataReaderType_t.Synthetic:
            raise NotImplementedError(
                f"reader {rp.data_reader_type.value} is not ported yet (ROADMAP Queue 1 item 7)"
            )
        if self.rm.local_world_size < self.world:
            raise NotImplementedError(
                "ranks on more than one host: the multi-host reader is not ported yet "
                "(ROADMAP Queue 1 item 1h)"
            )
        return SyntheticReader(
            self.batch_spec if train else self.eval_batch_spec,
            self._slot_vocabs(),
            num_batches=rp.synthetic_num_batches,
            alpha=rp.synthetic_alpha,
            seed=(self.solver.seed or 1234) + (0 if train else 99991),
            learnable_labels=rp.synthetic_learnable,
            block=(self.rm.rank, self.world),
        )

    def _slot_vocabs(self) -> Dict[str, List[int]]:
        """Per-slot key bounds of the synthetic reader (model.py:639): each
        table's vocabulary, a dynamic table's capacity."""
        vocabs = {f.name: [1000] * f.slot_num for f in self.batch_spec.sparse}
        if self.ec is not None:
            for top, ks in self._key_sources.items():
                vocab = int(self.ec.plan.lookups[int(top.rsplit(":", 1)[1])].table.vocabulary_size)
                f = self._sparse_by_name[ks.param_name]
                col = 0
                for si, nnz in enumerate(f.slot_nnz):
                    if col == ks.col_begin:
                        vocabs[f.name][si] = max(vocab, 2)
                        break
                    col += nnz
        return vocabs

    # ------------------------------------------------------------ training
    def _put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device) for k, v in batch.items()}

    def start_data_reading(self) -> None:
        """Synthetic batches are made once, kept on the device and cycled,
        as the JAX package does (model.py:1213-1228)."""
        if self._train_iter is not None:
            return
        if self.train_reader is None:
            raise ValueError("model has no reader")
        it = iter(self.train_reader)
        batches = [self._put_batch(next(it)) for _ in range(self.train_reader.num_batches)]
        self._train_iter = itertools.cycle(batches)

    def _feature_keys(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {
            top: batch[ks.param_name][:, ks.col_begin : ks.col_end]
            for top, ks in self._key_sources.items()
        }

    def _user_tensors(self, emb_outs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {
            user_top: emb_outs[tops[0]] if len(tops) == 1 else torch.cat([emb_outs[t] for t in tops], dim=1)
            for user_top, tops in self._user_tops.items()
        }

    def train_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One iteration on a device batch (the rank's block over W ranks);
        returns the global mean loss as a device tensor without waiting for
        the device (model.py:787-883)."""
        ec = self.ec
        step = self._step + 1
        lr = torch.tensor(float(self.lr_sch(step)), dtype=torch.float32, device=self.device)
        feature_keys = self._feature_keys(batch) if ec is not None else {}
        emb_in: Dict[str, torch.Tensor] = {}
        if ec is not None:
            with torch.no_grad():
                emb_outs = ec.forward(self.tables, feature_keys)
            emb_in = {k: v.detach().requires_grad_(True) for k, v in emb_outs.items()}
        tensors = {
            n: batch[n] for n in (*self.batch_spec.label_names, self.batch_spec.dense_name)
        }
        tensors.update(self._user_tensors(emb_in))
        loss, _ = self.network.forward_with_loss(tensors, self.solver.compute_dtype)
        params = self.network.param_tree()
        if self.world > 1:
            # the global-batch mean: loss / W on every rank, summed below
            loss = loss / self.world
            loss.backward()
            loss = self._all_reduce_grads(params, loss.detach())
        else:
            loss.backward()
        self.dense_opt.update(params, self.dopt, lr, step)
        self.network.zero_grad(set_to_none=True)
        if ec is not None:
            egrads = {k: v.grad for k, v in emb_in.items()}
            with torch.no_grad():
                ec.backward_and_update(self.tables, self.eopt, feature_keys, egrads, lr, step)
        self._step = step
        return loss.detach()

    @staticmethod
    def _all_reduce_grads(params, loss: torch.Tensor) -> torch.Tensor:
        """One flat float32 bucket of every dense gradient and the loss, one
        `all_reduce` of it, and the sums copied back. Returns the summed
        loss."""
        grads = [p.grad for ps in params.values() for p in ps.values() if p.grad is not None]
        flat = torch.cat([g.reshape(-1).float() for g in grads] + [loss.reshape(1).float()])
        all_reduce(flat)
        off = 0
        for g in grads:
            g.copy_(flat[off : off + g.numel()].view_as(g))
            off += g.numel()
        return flat[-1]

    def train_async(self) -> torch.Tensor:
        """One training iteration; returns the device loss (model.py:1257)."""
        self.start_data_reading()
        return self.train_step(next(self._train_iter))

    def train(self) -> float:
        """One training iteration; returns the loss (model.py:1253)."""
        return float(self.train_async())

    # ---------------------------------------------------------------- eval
    def _eval_batches(self):
        """The eval batches (model.py:1292): the synthetic eval set's first
        min(num_batches, max_eval_batches) batches, made once and kept on
        the device; cycled to cover max_eval_batches when repeat_dataset is
        set."""
        if self.eval_reader is None:
            raise ValueError("model has no reader")
        n = self.solver.max_eval_batches
        if self._eval_cache is None:
            it = iter(self.eval_reader)
            self._eval_cache = [self._put_batch(next(it))
                                for _ in range(min(self.eval_reader.num_batches, n))]
        if self.solver.repeat_dataset and len(self._eval_cache) < n:
            return itertools.islice(itertools.cycle(self._eval_cache), n)
        return iter(self._eval_cache)

    @torch.no_grad()
    def _eval_step(self, batch: Dict[str, torch.Tensor]):
        """The forward of one eval batch: (loss, predictions, labels) of the
        loss layer, on the device (model.py:885)."""
        ec = self.ec
        emb_outs = ec.forward(self.tables, self._feature_keys(batch)) if ec is not None else {}
        tensors = {n: batch[n] for n in (*self.batch_spec.label_names, self.batch_spec.dense_name)}
        tensors.update(self._user_tensors(emb_outs))
        loss, out = self.network.forward_with_loss(tensors, self.solver.compute_dtype)
        spec = self.network.loss_specs[0]
        return loss, self.network.predictions(out)[spec.label_name], tensors[spec.label_name]

    def eval(self) -> Dict[str, float]:
        """One pass over max_eval_batches eval batches; returns the metrics
        (model.py:1390). Losses, predictions and labels stay on the device
        until the metrics are finalized."""
        self.metrics.reset()
        for batch in self._eval_batches():
            loss, preds, labels = self._eval_step(batch)
            self.metrics.update(preds, labels, loss=loss)
        self._last_eval_metrics = self.metrics.finalize()
        return self._last_eval_metrics

    def get_eval_metrics(self) -> List[Tuple[str, float]]:
        """The last eval's metrics as (name, value) pairs (model.py:1929)."""
        return list(self._last_eval_metrics.items())

    def fit(self, num_epochs: int = 0, max_iter: int = 1000, display: int = 200,
            eval_interval: int = 1000, snapshot: int = 0, snapshot_prefix: str = "") -> None:
        """The training loop (model.py:1441): `max_iter` iterations (or
        `num_epochs` passes over the train reader), the loss checked and
        logged every `display` iterations (a non-finite loss raises), an
        eval every `eval_interval` iterations, stopping early once a metric
        passes its threshold in `metrics_spec`. Snapshots are not ported.
        Over W ranks every rank runs the loop and rank 0 logs."""
        if snapshot:
            raise NotImplementedError("snapshots are not ported yet (ROADMAP Queue 1 item 9)")
        say = get_logger().info if self.rm.is_master_process() else (lambda msg: None)
        self.start_data_reading()
        if num_epochs > 0:
            max_iter = num_epochs * max(self.train_reader.num_batches, 1)
        t0 = window_t0 = time.time()
        window_iter = 0
        for it in range(1, max_iter + 1):
            loss_dev = self.train_async()
            if display and it % display == 0:
                loss = float(loss_dev)  # one host sync per display window
                if not np.isfinite(loss):
                    raise RuntimeError(f"NaN/Inf loss at iter {it}: training stopped")
                dt = time.time() - window_t0
                ips = (it - window_iter) * self.solver.batchsize / max(dt, 1e-9)
                say(f"Iter: {it} Time: {dt:.3f}s Loss: {loss:.6f} "
                         f"lr: {self.lr_sch(it):.6f} ({ips:,.0f} ex/s)")
                window_t0, window_iter = time.time(), it
            if eval_interval and it % eval_interval == 0:
                vals = self.eval()
                say(f"Evaluation at iter {it}: {vals}")
                if self.metrics.check_earlystop(vals):
                    say(f"Hit target metric at iter {it}: {vals}; early stop")
                    break
        total = time.time() - t0
        say(f"fit done: {self._step} iters in {total:.1f}s "
                 f"({self._step * self.solver.batchsize / max(total, 1e-9):,.0f} ex/s)")
