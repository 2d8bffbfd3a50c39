"""The flagship models (counterpart of hugectr_tpu/tools/flagship.py).

DLRM-DCNv2 in the MLPerf v3.1 shape: 26 tables with the MLPerf multi-hot
sizes, ev 128, bottom MLP 512/256/128, Concat, DCNv2 MultiCross (projection
512, 3 layers), top MLP 1024/1024/512/256/1, BCE. `vocab_cap` caps each
table's vocabulary. The JAX package's `build_dlrm_dcnv2` picks its sparse
optimizer from the environment; here it is the `optimizer` argument, and
engine settings go to the `Solver` as keyword arguments (`onehot_vocab=...`).
"""
from __future__ import annotations

import hugectr_tpu_torch as hugectr
from hugectr_tpu_torch.core.types import DataReaderType_t

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
    **solver_kwargs,
):
    """DLRM-DCNv2 (flagship.py:28); returns a compiled Model on `rm.device`."""
    table_sizes = [min(v, vocab_cap) for v in MLPERF_TABLE_SIZES]
    if multi_hot_sizes is None:
        multi_hot_sizes = MLPERF_MULTI_HOT_SIZES
    solver = hugectr.CreateSolver(
        batchsize=batchsize, lr=lr, use_mixed_precision=use_mixed_precision, **solver_kwargs
    )
    reader = hugectr.DataReaderParams(
        data_reader_type=DataReaderType_t.Synthetic,
        synthetic_num_batches=synthetic_batches,
        synthetic_alpha=1.05,
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
    ebc = hugectr.EmbeddingCollectionConfig()
    ebc.embedding_lookup(
        table_config=tables,
        bottom_name=[f"data{i}" for i in range(NUM_TABLE)],
        top_name="sparse_embedding",
        combiner=["sum"] * NUM_TABLE,
    )
    names = [str(i) for i in range(NUM_TABLE)]
    ebc.shard(shard_matrix=[names] * rm.num_devices, shard_strategy=[("mp", names)])
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


def build_tiny_dlrm(rm, batchsize: int = 32, **kwargs):
    """Tiny-shape variant (flagship.py:168)."""
    params = dict(
        ev_size=16, vocab_cap=1000, synthetic_batches=4, bottom_mlp=(32, 16),
        top_mlp=(32, 16, 1), projection_dim=8, num_cross_layers=2,
    )
    params.update(kwargs)
    return build_dlrm_dcnv2(rm, batchsize=batchsize, **params)
