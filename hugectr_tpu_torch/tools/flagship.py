"""The flagship models (counterpart of hugectr_tpu/tools/flagship.py).

DLRM-DCNv2 in the MLPerf v3.1 shape: 26 tables with the MLPerf multi-hot
sizes, ev 128, bottom MLP 512/256/128, Concat, DCNv2 MultiCross (projection
512, 3 layers), top MLP 1024/1024/512/256/1, BCE. `vocab_cap` caps each
table's vocabulary. The JAX package's `build_dlrm_dcnv2` picks its sparse
optimizer and dtypes from the environment; here they are the `optimizer`
argument and `Solver` fields passed as keyword arguments, as are the engine
settings (`onehot_vocab=...`). `bench_settings()` names the values bench.py
gives the JAX package.

DLRM with FTRL (`build_dlrm_ftrl`) is the graph of samples/dlrm_ftrl.py
(reference: samples/ftrl/dlrm_train_ftrl.py): 26 tables with the sample's
slot sizes capped at `vocab_cap`, ev 128, hotness 1, sum, all
model-parallel; a Reshape to [B, 26, ev]; bottom MLP 512/256/ev; the DLRM
Interaction; top MLP 1024/1024/512/256/1; BCE; FTRL (lambda1 = lambda2 =
0.01, beta 0) for the tables and the dense network. `dynamic=True` makes
every table dynamic (`max_vocabulary_size` -1) with `dynamic_capacity`
rows. The sample reads Parquet files; by default the port reads synthetic
power-law keys.

Each builder takes `reader=` (a `DataReaderParams`) in place of its
synthetic reader, so that a full-width model can read files.
"""
from __future__ import annotations

import hugectr_tpu_torch as hugectr
from hugectr_tpu_torch.core.types import DataReaderType_t, Metric_t

MLPERF_TABLE_SIZES = [
    40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
    3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000,
    40000000, 40000000, 590152, 12973, 108, 36,
]
MLPERF_MULTI_HOT_SIZES = [
    3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
    100, 27, 10, 3, 40, 1,
]
NUM_TABLE = 26
NUM_DENSE = 13
# samples/dlrm_ftrl.py:15-19, the reference's Criteo slot sizes
FTRL_SLOT_SIZES = [
    39884, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532, 2953546,
    403346, 10, 2208, 11938, 155, 4, 976, 14, 39979, 25641295, 39664984,
    585935, 12972, 108, 36,
]
# the tiny DLRM-FTRL of the tests: the sample's dense widths, tables capped
# at 200 rows (dynamic: 200 rows each), batch 32. Six tables of <= 64 rows
# take the one-hot engine, the 18 tables capped at 200 rows a storage group
# each and the dense sweep, tables 15 and 24 (155 and 108 rows) one shared
# group and the sorted route. The dynamic variant keeps its 26 tables in one
# group (no storage group of their own) on the dense sweep, as at full size
TINY_FTRL = dict(batchsize=32, vocab_cap=200, dynamic_capacity=200, synthetic_batches=3,
                 onehot_vocab=64, split_vocab=200, dense_update_rows=200)
TINY_FTRL_DYNAMIC = dict(split_vocab=0, dense_update_rows=8192)


def bench_settings() -> dict:
    """The flagship as bench.py configures the JAX package on its chip
    (bench.py:22-61, 83-100), as `build_dlrm_dcnv2` keyword arguments:
    batch 16,384, vocab_cap 2,000,000, ev 128; bf16 tables and bf16
    rowwise-AdaGrad state; bf16 products in the dense network; the split of
    each big table at 131,072 rows with a 1,024-row superhot tier in the
    one-hot group, and a storage group of its own for every rowop table of
    16,384 rows or more; eval over 320 batches of 16,384, the binned AUC
    past 1,048,576 samples; the caps measured on the first batch with a
    headroom of 1.05 (HCTR_TPU_UCAP_FACTOR=auto, HCTR_TPU_UCAP_HEADROOM,
    bench.py:29, 34), which send the groups with a valid cap to the
    compact forward and count their measured keys in the key-ratio rule.
    bench.py's HCTR_TPU_SEGSUM=xla is the port's segment sum."""
    return dict(
        batchsize=16384, vocab_cap=2_000_000, ev_size=128, use_mixed_precision=True,
        embedding_vec_dtype="bfloat16", embedding_state_dtype="bfloat16",
        optimizer="rowwise_adagrad", hot_rows=131072, superhot_rows=1024, split_vocab=16384,
        max_eval_batches=320, auc_exact_max=1048576, unique_cap_factor="auto", ucap_headroom=1.05,
    )


# bench_settings() scaled down for the tiny parity runs: ev 16, tables of
# >= 1,024 rows split at 256 rows with a 32-row superhot tier, one-hot for
# vocab <= 64, groups of more than 1,024 rows on the sorted route, the eval
# buffer (5 x 64 samples) past the exact AUC's limit, learnable labels
TINY_BENCH = dict(ev_size=16, vocab_cap=4000, synthetic_batches=3, bottom_mlp=(32, 16), top_mlp=(32, 16, 1),
                  projection_dim=8, num_cross_layers=2, batchsize=64, max_eval_batches=5, onehot_vocab=64,
                  hot_rows=256, superhot_rows=32, split_vocab=512, auc_exact_max=100, dense_update_rows=1024,
                  synthetic_learnable=True)

# the plan settings of bench_settings(), as flagship_plan keyword arguments
BENCH_PLAN = dict(split_vocab=16384, hot_rows=131072, superhot_rows=1024)


def shard_matrix(names, world: int, shard_counts=None):
    """The `shard_matrix` (one row of table names per rank) that puts table
    n on `shard_counts[n]` ranks (the first ones) and every other table on
    all `world` ranks; the plan widens a count to the next divisor of the
    rank count (plan.py:566-581)."""
    counts = shard_counts or {}
    return [[n for n in names if r < counts.get(n, world)] for r in range(world)]


def build_dlrm_dcnv2(
    rm,
    batchsize: int = 8192,
    ev_size: int = 128,
    vocab_cap: int = 2_000_000,
    synthetic_batches: int = 64,
    lr: float = 0.005,
    use_mixed_precision: bool = False,
    bottom_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
    projection_dim: int = 512,
    num_cross_layers: int = 3,
    multi_hot_sizes=None,
    optimizer: str = "rowwise_adagrad",
    max_eval_batches: int = 8,
    synthetic_learnable: bool = False,
    shard_counts=None,
    reader=None,
    comm_strategy=None,
    column_factors=None,
    batchsize_eval=None,
    **solver_kwargs,
):
    """DLRM-DCNv2 (flagship.py:28); returns a compiled Model on `rm.device`,
    over `rm.num_devices` ranks (`batchsize` is the global batch; the
    tables not on the one-hot engine are model-parallel, table n on
    `shard_counts[n]` of the ranks where given, else on all of them).
    `reader` replaces the synthetic reader; `comm_strategy` is the
    collection's (flagship.py:40; "hierarchical" takes the two-level
    exchange on a hierarchical mesh), `column_factors` {table: f} splits
    tables column-wise; `batchsize_eval` defaults to `batchsize`;
    `solver_kwargs` are `Solver` fields (dtypes, split, engine settings)."""
    table_sizes = [min(v, vocab_cap) for v in MLPERF_TABLE_SIZES]
    if multi_hot_sizes is None:
        multi_hot_sizes = MLPERF_MULTI_HOT_SIZES
    solver_kwargs.setdefault("metrics_spec", {Metric_t.AUC: 0.80275})
    solver_kwargs.setdefault("repeat_dataset", True)
    solver = hugectr.CreateSolver(
        batchsize=batchsize, batchsize_eval=batchsize_eval or batchsize, max_eval_batches=max_eval_batches,
        lr=lr, use_mixed_precision=use_mixed_precision, **solver_kwargs,
    )
    reader = reader or hugectr.DataReaderParams(
        data_reader_type=DataReaderType_t.Synthetic,
        synthetic_num_batches=synthetic_batches,
        synthetic_alpha=1.05,
        synthetic_learnable=synthetic_learnable,
    )
    opt = hugectr.CreateOptimizer(
        optimizer_type=hugectr.Optimizer_t(optimizer), initial_accu_value=0.0
    )
    model = hugectr.Model(solver, reader, opt, resource_manager=rm)
    model.add(
        hugectr.Input(
            label_dim=1,
            label_name="label",
            dense_dim=NUM_DENSE,
            dense_name="dense",
            data_reader_sparse_param_array=[
                hugectr.DataReaderSparseParam(f"data{i}", multi_hot_sizes[i], True, 1)
                for i in range(NUM_TABLE)
            ],
        )
    )
    tables = [
        hugectr.EmbeddingTableConfig(name=str(i), max_vocabulary_size=table_sizes[i], ev_size=ev_size)
        for i in range(NUM_TABLE)
    ]
    ebc = hugectr.EmbeddingCollectionConfig(comm_strategy=comm_strategy or "uniform")
    ebc.embedding_lookup(
        table_config=tables,
        bottom_name=[f"data{i}" for i in range(NUM_TABLE)],
        top_name="sparse_embedding",
        combiner=["sum"] * NUM_TABLE,
    )
    names = [str(i) for i in range(NUM_TABLE)]
    ebc.shard(shard_matrix=shard_matrix(names, rm.num_devices, shard_counts), shard_strategy=[("mp", names)],
              column_factors=column_factors)
    model.add(ebc)
    model.add(
        hugectr.DenseLayer(
            layer_type=hugectr.Layer_t.MLP, bottom_names=["dense"], top_names=["mlp1"],
            num_outputs=list(bottom_mlp),
        )
    )
    model.add(
        hugectr.DenseLayer(
            layer_type=hugectr.Layer_t.Concat, bottom_names=["sparse_embedding", "mlp1"],
            top_names=["concat1"],
        )
    )
    model.add(
        hugectr.DenseLayer(
            layer_type=hugectr.Layer_t.MultiCross, bottom_names=["concat1"],
            top_names=["interaction1"], projection_dim=projection_dim, num_layers=num_cross_layers,
        )
    )
    acts = [hugectr.Activation_t.Relu] * (len(top_mlp) - 1) + [hugectr.Activation_t.Non]
    model.add(
        hugectr.DenseLayer(
            layer_type=hugectr.Layer_t.MLP, bottom_names=["interaction1"], top_names=["mlp2"],
            num_outputs=list(top_mlp), activations=acts,
        )
    )
    model.add(
        hugectr.DenseLayer(
            layer_type=hugectr.Layer_t.BinaryCrossEntropyLoss, bottom_names=["mlp2", "label"],
            top_names=["loss"],
        )
    )
    model.compile()
    return model


def flagship_plan(vocab_cap: int = 2_000_000, ev_size: int = 128, onehot_vocab: int = 8192,
                  split_vocab: int = 256 * 1024, hot_rows: int = 0, superhot_rows: int = 0,
                  num_shards: int = 1):
    """The flagship's embedding plan on `num_shards` ranks (one card by
    default), compiled as `Model` does for `build_dlrm_dcnv2` (the engine's
    default thresholds, or those given: `flagship_plan(**BENCH_PLAN)` is
    the plan of `bench_settings()`)."""
    from ..core.types import Combiner_t
    from ..parallel.plan import EmbeddingTableConfig, LookupConfig, ShardingPlan, compile_plan

    names = [str(i) for i in range(NUM_TABLE)]
    lookups = [
        LookupConfig(i, EmbeddingTableConfig(names[i], min(v, vocab_cap), ev_size), f"data{i}",
                     f"sparse_embedding:{i}", Combiner_t.Sum, MLPERF_MULTI_HOT_SIZES[i])
        for i, v in enumerate(MLPERF_TABLE_SIZES)
    ]
    return compile_plan(lookups, ShardingPlan([("mp", names)]), num_shards, {n: num_shards for n in names},
                        onehot_vocab=onehot_vocab, split_vocab=split_vocab, hot_rows=hot_rows,
                        superhot_rows=superhot_rows)


def ftrl_plan(dynamic: bool = False, vocab_cap: int = 400_000, ev_size: int = 128,
              dynamic_capacity: int = 4096, onehot_vocab: int = 8192, split_vocab: int = 256 * 1024,
              num_shards: int = 1):
    """The embedding plan `Model` compiles for `build_dlrm_ftrl` on
    `num_shards` ranks (one card by default; the engine's default
    thresholds, or those given)."""
    from ..core.types import Combiner_t
    from ..parallel.plan import EmbeddingTableConfig, LookupConfig, ShardingPlan, compile_plan

    names = [str(i) for i in range(NUM_TABLE)]
    lookups = [
        LookupConfig(i, EmbeddingTableConfig(names[i], -1 if dynamic else min(v, vocab_cap), ev_size,
                                             dynamic_capacity=dynamic_capacity),
                     f"sparse_embedding1:{i}", f"sparse_embedding1:{i}", Combiner_t.Sum, 1)
        for i, v in enumerate(FTRL_SLOT_SIZES)
    ]
    return compile_plan(lookups, ShardingPlan([("mp", names)]), num_shards, {n: num_shards for n in names},
                        onehot_vocab=onehot_vocab, split_vocab=split_vocab)


def raw_vocab(plan, lm) -> int:
    """The vocabulary a group lookup's raw keys come from: its user table's,
    before any split."""
    top = lm.top_name.split("::", 1)[0]
    return int(next(lk for lk in plan.lookups if lk.top_name == top).table.vocabulary_size)


def onehot_group_inputs(rng, batch: int, ev_size: int, dtype, device, alpha: float = 1.05, plan=None,
                        **plan_kw):
    """The flagship's one-hot group forward as the step gives it: the group
    of `plan` (default `flagship_plan(**plan_kw)`), power-law keys over each user table's
    vocabulary as int32 column views of one [batch, sum h] tensor (a
    superhot tier reads the raw keys through its window), the group's
    forward descriptors, a random group storage and the output width.
    Returns (keys, lookups, storage, width)."""
    import numpy as np
    import torch

    from ..data.generator import power_law_keys
    from ..embedding.collection import onehot_fwd_lookups

    plan = plan or flagship_plan(ev_size=ev_size, **plan_kw)
    g = next(g for g in plan.groups if g.compute_kind == "onehot")
    allk = np.concatenate([power_law_keys(rng, raw_vocab(plan, lm), (batch, lm.hotness), alpha)
                           for lm in g.lookups], axis=1)
    allk = torch.as_tensor(allk.astype(np.int32), device=device)
    keys = [allk[:, lm.slot_begin : lm.slot_end] for lm in g.lookups]
    storage = torch.as_tensor(rng.standard_normal((g.total_storage_rows, ev_size), dtype=np.float32),
                              device=device)
    return keys, onehot_fwd_lookups(g), storage.to(dtype), g.out_width


def build_tiny_dlrm(rm, batchsize: int = 32, **kwargs):
    """Tiny-shape variant (flagship.py:168)."""
    params = dict(
        ev_size=16, vocab_cap=1000, synthetic_batches=4, bottom_mlp=(32, 16),
        top_mlp=(32, 16, 1), projection_dim=8, num_cross_layers=2,
    )
    params.update(kwargs)
    return build_dlrm_dcnv2(rm, batchsize=batchsize, **params)


# partial placement in the tiny DLRM-DCNv2 (after
# tests/test_partial_placement.py:57, t0 on 2 of 8 devices): tables 0 and 9
# on 2 ranks, 21 and 22 on one (so on every rank), the other rowop tables
# on all. With the one-hot engine for vocab <= 100 and the dense sweep for
# shards of <= 1,000 rows, over 4 ranks the f = 2 group (`mp_ev16_x2`,
# 1,000 rows a shard, 2 replicas) takes the dense sweep, the f = 1 group
# (`mp_ev16_x1`, 2,000 rows, 4 replicas) and the full one (3,560 rows a
# shard) the sorted route
TINY_PARTIAL = dict(batchsize=64, onehot_vocab=100, dense_update_rows=1000, dense_key_ratio=0.0,
                    shard_counts={"0": 2, "9": 2, "21": 1, "22": 1})


def build_tiny_partial(rm, **kwargs):
    """The tiny DLRM-DCNv2 with a partial `shard_matrix` (`TINY_PARTIAL`)."""
    return build_tiny_dlrm(rm, **dict(TINY_PARTIAL, **kwargs))


def build_tiny_column(rm, factor: int = 1, batchsize: int = 64, synthetic_batches: int = 4, **solver_kwargs):
    """The model of the JAX package's tests/test_column_sharding.py::_model
    on `rm`: table t0 (100 rows, ev 16), one Sum lookup of 2 keys,
    model-parallel on every rank and split column-wise into `factor`
    sub-tables t0#col{j}, an InnerProduct of one output, the binary
    cross-entropy, AdaGrad at lr 0.05, synthetic batches; `solver_kwargs`
    are `Solver` fields (engine settings)."""
    solver = hugectr.CreateSolver(max_eval_batches=2, batchsize_eval=batchsize, batchsize=batchsize, lr=0.05,
                                  **solver_kwargs)
    reader = hugectr.DataReaderParams(data_reader_type=DataReaderType_t.Synthetic,
                                      synthetic_num_batches=synthetic_batches)
    model = hugectr.Model(solver, reader, hugectr.CreateOptimizer(optimizer_type=hugectr.Optimizer_t.AdaGrad),
                          resource_manager=rm)
    model.add(hugectr.Input(label_dim=1, label_name="label", dense_dim=4, dense_name="dense",
                            data_reader_sparse_param_array=[hugectr.DataReaderSparseParam("d0", 2, True, 1)]))
    ebc = hugectr.EmbeddingCollectionConfig()
    ebc.embedding_lookup(hugectr.EmbeddingTableConfig(name="t0", max_vocabulary_size=100, ev_size=16),
                         "d0", "emb", "sum")
    ebc.shard(shard_matrix=[["t0"]] * rm.num_devices, shard_strategy=[("mp", ["t0"])],
              column_factors={"t0": factor} if factor > 1 else None)
    model.add(ebc)
    model.add(hugectr.DenseLayer(layer_type=hugectr.Layer_t.InnerProduct, bottom_names=["emb"],
                                 top_names=["logit"], num_output=1, act_type=hugectr.Activation_t.Non))
    model.add(hugectr.DenseLayer(layer_type=hugectr.Layer_t.BinaryCrossEntropyLoss,
                                 bottom_names=["logit", "label"], top_names=["loss"]))
    model.compile()
    return model


def build_dlrm_ftrl(
    rm,
    batchsize: int = 2048,
    dynamic: bool = False,
    vocab_cap: int = 400_000,
    ev_size: int = 128,
    dynamic_capacity: int = 4096,
    synthetic_batches: int = 64,
    lr: float = 0.001,
    max_eval_batches: int = 50,
    synthetic_alpha: float = 1.05,
    synthetic_learnable: bool = False,
    reader=None,
    compile_model: bool = True,
    **solver_kwargs,
):
    """DLRM with FTRL, samples/dlrm_ftrl.py:15-114, on `rm.device` over
    `rm.num_devices` ranks, every table on every rank as the sample's
    `shard_matrix` puts them (samples/dlrm_ftrl.py:69-72); compiled unless
    `compile_model` is False. A static table's `dynamic_capacity` is 0, as
    the sample sets it (:60). `synthetic_learnable` gives the synthetic
    batches labels from the keys' parities, so that the loss can fall and
    eval can see learning; `reader` replaces the synthetic reader;
    `solver_kwargs` are `Solver` fields (engine settings, dtypes,
    `i64_input_key`)."""
    sizes = [min(v, vocab_cap) for v in FTRL_SLOT_SIZES]
    solver_kwargs.setdefault("repeat_dataset", True)
    solver = hugectr.CreateSolver(
        max_eval_batches=max_eval_batches, batchsize_eval=batchsize, batchsize=batchsize, lr=lr,
        **solver_kwargs,
    )
    reader = reader or hugectr.DataReaderParams(
        data_reader_type=DataReaderType_t.Synthetic, synthetic_num_batches=synthetic_batches,
        synthetic_alpha=synthetic_alpha, synthetic_learnable=synthetic_learnable,
    )
    opt = hugectr.CreateOptimizer(
        optimizer_type=hugectr.Optimizer_t.FTRL, lr=lr, beta=0.0, lambda1=0.01, lambda2=0.01
    )
    model = hugectr.Model(solver, reader, opt, resource_manager=rm)
    model.add(
        hugectr.Input(
            label_dim=1, label_name="label", dense_dim=NUM_DENSE, dense_name="dense",
            data_reader_sparse_param_array=[
                hugectr.DataReaderSparseParam(f"data{i}", 1, True, 1) for i in range(NUM_TABLE)
            ],
        )
    )
    tables = [
        hugectr.EmbeddingTableConfig(
            name=str(i), max_vocabulary_size=-1 if dynamic else sizes[i], ev_size=ev_size,
            dynamic_capacity=dynamic_capacity if dynamic else 0,
        )
        for i in range(NUM_TABLE)
    ]
    ebc = hugectr.EmbeddingCollectionConfig()
    ebc.embedding_lookup(tables, [f"data{i}" for i in range(NUM_TABLE)], "sparse_embedding1",
                         ["sum"] * NUM_TABLE)
    names = [t.name for t in tables]
    ebc.shard(shard_matrix=[names] * rm.num_devices, shard_strategy=[("mp", names)])
    model.add(ebc)
    model.add(hugectr.DenseLayer(layer_type=hugectr.Layer_t.Reshape, bottom_names=["sparse_embedding1"],
                                 top_names=["emb3d"], shape=[-1, NUM_TABLE, ev_size]))
    model.add(hugectr.DenseLayer(layer_type=hugectr.Layer_t.MLP, bottom_names=["dense"],
                                 top_names=["bottom_mlp"], num_outputs=[512, 256, ev_size],
                                 activations=[hugectr.Activation_t.Relu] * 3))
    model.add(hugectr.DenseLayer(layer_type=hugectr.Layer_t.Interaction, bottom_names=["bottom_mlp", "emb3d"],
                                 top_names=["interaction1"]))
    model.add(hugectr.DenseLayer(layer_type=hugectr.Layer_t.MLP, bottom_names=["interaction1"],
                                 top_names=["top_mlp"], num_outputs=[1024, 1024, 512, 256, 1],
                                 activations=[hugectr.Activation_t.Relu] * 4 + [hugectr.Activation_t.Non]))
    model.add(hugectr.DenseLayer(layer_type=hugectr.Layer_t.BinaryCrossEntropyLoss,
                                 bottom_names=["top_mlp", "label"], top_names=["loss"]))
    if compile_model:
        model.compile()
    return model


def build_tiny_dlrm_ftrl(rm, dynamic: bool = False, **kwargs):
    """The tiny DLRM-FTRL of the tests (`TINY_FTRL`, and `TINY_FTRL_DYNAMIC`
    for the dynamic variant)."""
    params = dict(TINY_FTRL, **(TINY_FTRL_DYNAMIC if dynamic else {}))
    params.update(kwargs)
    return build_dlrm_ftrl(rm, dynamic=dynamic, **params)
