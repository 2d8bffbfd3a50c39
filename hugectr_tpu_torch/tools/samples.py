"""The JAX package's other samples on the port: `build_sample(name, rm)`
builds and compiles the graph of `samples/<name>.py` as a port `Model`.

    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools.samples import build_sample
    model = build_sample("din", ResourceManager.create())   # on the card
    model.train(); model.eval()

Each builder follows its sample line for line (the lines are cited): the
same slot sizes, embedding widths, layers, optimizer and solver settings,
with the Synthetic reader in place of the sample's Parquet files unless
`reader=` is given (`synthetic_alpha` 1.05: power-law keys, as the DLRM
builders draw them).
The samples and their variants (tests/test_samples.py:14-25) are `GRAPHS`:
criteo_parquet, wdl, dcn, deepfm, ncf (gmf, ncf, neumf), mmoe (mmoe,
shared_bottom), din and bst. Keyword arguments scale a graph down for the
tests: `slot_cap` caps every slot size, `dropout_rate` replaces the
samples' 0.5, and the others are `Solver` fields (the engine settings) or
the reader's (`synthetic_batches`, `synthetic_learnable`). `TINY_SAMPLE`
is the tests' size.
"""
from __future__ import annotations

from typing import List, Optional

import hugectr_tpu_torch as hugectr
from hugectr_tpu_torch.core.types import DataReaderType_t

GRAPHS = [
    ("criteo_parquet", None), ("wdl", None), ("dcn", None), ("deepfm", None), ("ncf", "gmf"), ("ncf", "ncf"),
    ("ncf", "neumf"), ("mmoe", "mmoe"), ("mmoe", "shared_bottom"), ("din", None), ("bst", None),
]
DEFAULT_VARIANT = {"ncf": "gmf", "mmoe": "mmoe"}

# the tests' size: every slot capped at 100 rows, batch 64, no dropout. The
# engine settings put tables of <= 1,000 rows in the one-hot group and
# shards of <= 2,100 rows on the dense sweep (criteo_parquet, wdl, deepfm;
# dcn and din stay sorted), so that the graphs take every update route
# between them (the JAX package's HCTR_TPU_ONEHOT_VOCAB, _SPLIT_VOCAB,
# _DENSE_UPDATE_ROWS and _DENSE_KEY_RATIO at these values)
TINY_SAMPLE = dict(batchsize=64, slot_cap=100, dropout_rate=0.0, synthetic_batches=3, onehot_vocab=1000,
                   split_vocab=0, dense_update_rows=2100, dense_key_ratio=0.0)

CRITEO_SLOTS = [  # criteo_parquet.py:7-11, deepfm.py:8-12
    203931, 18598, 14092, 7012, 18977, 4, 6385, 1245, 49, 186213, 71328,
    67288, 11, 2168, 7338, 61, 4, 932, 15, 204515, 141526, 199433, 60919,
    9137, 71, 34,
]
WDL_DEEP_SLOTS = [  # wdl.py:10-14
    203750, 18573, 14082, 7020, 18966, 4, 6382, 1246, 49, 185920, 71354,
    67346, 11, 2166, 7340, 60, 4, 934, 15, 204208, 141572, 199066, 60940,
    9115, 72, 34,
]
WDL_WIDE_SLOTS = [278899, 355877]  # wdl.py:15
DCN_SLOTS = [  # dcn.py:7-11
    39884, 39043, 17289, 7420, 20263, 3, 7120, 1543, 39884, 39043, 17289,
    7420, 20263, 3, 7120, 1543, 63, 63, 39884, 39043, 17289, 7420, 20263,
    3, 7120, 1543,
]
NCF_SLOTS = [162543, 56573]  # ncf.py:12
MMOE_SLOTS = [  # mmoe.py:11-14
    91, 73622, 17, 1425, 3, 24, 15, 5, 10, 2, 3, 6, 8, 133, 114, 1675,
    6, 6, 51, 38, 8, 47, 10, 9, 10, 3, 4, 7, 5, 2, 52, 9,
]
USER_VOCAB, GOOD_VOCAB, CATE_VOCAB = 192403, 63001, 801  # din.py:10-12, bst.py:9-13
SEQ = 10  # din.py:14, bst.py:8


class _Builder:
    """The sample's `model` and the scaling knobs."""

    def __init__(self, model, slot_cap: int, dropout_rate: Optional[float]):
        self.model = model
        self.slot_cap = slot_cap
        self.dropout_rate = dropout_rate

    def slots(self, sizes: List[int]) -> List[int]:
        return [min(s, self.slot_cap) for s in sizes] if self.slot_cap else list(sizes)

    def layer(self, layer_type: str, bottoms: List[str], tops: List[str], **kw) -> None:
        if layer_type == hugectr.Layer_t.Dropout and self.dropout_rate is not None:
            kw["dropout_rate"] = self.dropout_rate
        self.model.add(hugectr.DenseLayer(layer_type=layer_type, bottom_names=bottoms, top_names=tops, **kw))

    def input(self, sparse, label_dim=1, label_name="label", dense_dim=13, label_weights=None) -> None:
        self.model.add(hugectr.Input(
            label_dim=label_dim, label_name=label_name, dense_dim=dense_dim, dense_name="dense",
            data_reader_sparse_param_array=[hugectr.DataReaderSparseParam(*p) for p in sparse],
            label_weights=label_weights,
        ))

    def embedding(self, name: str, bottom: str, slots: List[int], ev: int, mb: int, kind=None) -> None:
        self.model.add(hugectr.SparseEmbedding(
            embedding_type=kind or hugectr.Embedding_t.DistributedSlotSparseEmbeddingHash,
            workspace_size_per_gpu_in_mb=mb, embedding_vec_size=ev, combiner="sum",
            sparse_embedding_name=name, bottom_name=bottom, optimizer=self.model.opt_params,
            slot_size_array=self.slots(slots),
        ))


def _criteo_parquet(b: _Builder, variant) -> None:
    """criteo_parquet.py:25-85."""
    L = hugectr.Layer_t
    b.input([("data1", 1, True, 26)])
    b.embedding("sparse_embedding1", "data1", CRITEO_SLOTS, 16, 150)
    b.layer(L.Reshape, ["sparse_embedding1"], ["reshape1"], leading_dim=416)
    b.layer(L.Concat, ["reshape1", "dense"], ["concat1"])
    b.layer(L.MLP, ["concat1"], ["mlp1"], num_outputs=[200, 200, 200])
    b.layer(L.InnerProduct, ["mlp1"], ["fc4"], num_output=1, act_type=hugectr.Activation_t.Non)
    b.layer(L.BinaryCrossEntropyLoss, ["fc4", "label"], ["loss"])


def _wdl(b: _Builder, variant) -> None:
    """wdl.py:34-147."""
    L = hugectr.Layer_t
    b.input([("wide_data", 1, True, 2), ("deep_data", 1, True, 26)])
    b.embedding("sparse_embedding2", "wide_data", WDL_WIDE_SLOTS, 1, 24)
    b.embedding("sparse_embedding1", "deep_data", WDL_DEEP_SLOTS, 16, 342)
    b.layer(L.Reshape, ["sparse_embedding1"], ["reshape1"], leading_dim=416)
    b.layer(L.Reshape, ["sparse_embedding2"], ["reshape2"], leading_dim=2)
    b.layer(L.ReduceSum, ["reshape2"], ["wide_redn"], axis=1)
    b.layer(L.Concat, ["reshape1", "dense"], ["concat1"])
    prev = "concat1"
    for i in (1, 2):
        b.layer(L.InnerProduct, [prev], [f"fc{i}"], num_output=1024)
        b.layer(L.ReLU, [f"fc{i}"], [f"relu{i}"])
        b.layer(L.Dropout, [f"relu{i}"], [f"dropout{i}"], dropout_rate=0.5)
        prev = f"dropout{i}"
    b.layer(L.InnerProduct, [prev], ["fc3"], num_output=1)
    b.layer(L.Add, ["fc3", "wide_redn"], ["add1"])
    b.layer(L.BinaryCrossEntropyLoss, ["add1", "label"], ["loss"])


def _dcn(b: _Builder, variant) -> None:
    """dcn.py:25-133: DCN v1 (MultiCross without projection)."""
    L = hugectr.Layer_t
    b.input([("data1", 2, False, 26)])
    b.embedding("sparse_embedding1", "data1", DCN_SLOTS, 16, 300)
    b.layer(L.Reshape, ["sparse_embedding1"], ["reshape1"], leading_dim=416)
    b.layer(L.Concat, ["reshape1", "dense"], ["concat1"])
    b.layer(L.MultiCross, ["concat1"], ["multicross1"], num_layers=6)
    b.layer(L.InnerProduct, ["concat1"], ["fc1"], num_output=1024)
    b.layer(L.ReLU, ["fc1"], ["relu1"])
    b.layer(L.Dropout, ["relu1"], ["dropout1"], dropout_rate=0.5)
    b.layer(L.InnerProduct, ["dropout1"], ["fc2"], num_output=1024)
    b.layer(L.ReLU, ["fc2"], ["relu2"])
    b.layer(L.Dropout, ["relu2"], ["dropout2"], dropout_rate=0.5)
    b.layer(L.Concat, ["multicross1", "dropout2"], ["concat2"])
    b.layer(L.InnerProduct, ["concat2"], ["fc3"], num_output=1)
    b.layer(L.BinaryCrossEntropyLoss, ["fc3", "label"], ["loss"])


def _deepfm(b: _Builder, variant) -> None:
    """deepfm.py:26-182: [B, 26, 11] split into 10-dim latent vectors and
    1-dim first-order weights."""
    L = hugectr.Layer_t
    b.input([("data1", 1, True, 26)])
    b.embedding("sparse_embedding1", "data1", CRITEO_SLOTS, 11, 183,
                kind=hugectr.Embedding_t.LocalizedSlotSparseEmbeddingHash)
    b.layer(L.Reshape, ["sparse_embedding1"], ["reshape1"], leading_dim=11)
    b.layer(L.Slice, ["reshape1"], ["slice11", "slice12"], ranges=[(0, 10), (10, 11)])
    b.layer(L.Reshape, ["slice11"], ["reshape2"], leading_dim=260)
    b.layer(L.Reshape, ["slice12"], ["reshape3"], leading_dim=26)
    b.layer(L.WeightMultiply, ["dense"], ["weight_multiply1"], weight_dims=[13, 10])
    b.layer(L.WeightMultiply, ["dense"], ["weight_multiply2"], weight_dims=[13, 1])
    b.layer(L.Concat, ["reshape2", "weight_multiply1"], ["concat1"])
    prev = "concat1"
    for i in (1, 2, 3):
        b.layer(L.InnerProduct, [prev], [f"fc{i}"], num_output=400)
        b.layer(L.ReLU, [f"fc{i}"], [f"relu{i}"])
        b.layer(L.Dropout, [f"relu{i}"], [f"dropout{i}"], dropout_rate=0.5)
        prev = f"dropout{i}"
    b.layer(L.InnerProduct, [prev], ["fc4"], num_output=1)
    b.layer(L.FmOrder2, ["concat1"], ["fmorder2"], out_dim=10)
    b.layer(L.ReduceSum, ["fmorder2"], ["reducesum1"], axis=1)
    b.layer(L.Concat, ["reshape3", "weight_multiply2"], ["concat2"])
    b.layer(L.ReduceSum, ["concat2"], ["reducesum2"], axis=1)
    b.layer(L.Add, ["fc4", "reducesum1", "reducesum2"], ["add"])
    b.layer(L.BinaryCrossEntropyLoss, ["add", "label"], ["loss"])


def _ncf(b: _Builder, variant) -> None:
    """ncf.py:33-160: gmf, ncf (an MLP tower) or neumf (both)."""
    L = hugectr.Layer_t
    b.input([("data", 1, True, 2)], dense_dim=1)
    ev = 16 if variant != "neumf" else 32
    b.embedding("mixed_embedding", "data", NCF_SLOTS, ev, 60)
    b.layer(L.Reshape, ["mixed_embedding"], ["reshape1"], leading_dim=2 * ev)

    def gmf_branch(user, item, top):  # ncf.py:70-77
        b.layer(L.ElementwiseMultiply, [user, item], [top])

    def mlp_tower(bottom, top, widths=(256, 256, 128, 64)):  # ncf.py:80-102
        prev = bottom
        for i, w in enumerate(widths):
            last = i == len(widths) - 1
            fc, drop = f"fc{i + 1}", (top if last else f"dropout{i + 1}")
            b.layer(L.InnerProduct, [prev], [fc], num_output=w, act_type=hugectr.Activation_t.Relu)
            b.layer(L.Dropout, [fc], [drop], dropout_rate=0.5)
            prev = drop

    if variant == "gmf":
        b.layer(L.Slice, ["reshape1"], ["user", "item"], ranges=[(0, ev), (ev, 2 * ev)])
        gmf_branch("user", "item", "gmf_multiply")
        head = "gmf_multiply"
    elif variant == "ncf":
        mlp_tower("reshape1", "mlp_out")
        head = "mlp_out"
    else:
        b.layer(L.Slice, ["reshape1"], ["mlp_user", "gmf_user", "mlp_item", "gmf_item"],
                ranges=[(0, 16), (16, 32), (32, 48), (48, 64)])
        b.layer(L.Concat, ["mlp_user", "mlp_item"], ["mlp_in"])
        mlp_tower("mlp_in", "mlp_out")
        gmf_branch("gmf_user", "gmf_item", "gmf_multiply")
        b.layer(L.Concat, ["gmf_multiply", "mlp_out"], ["concat_head"])
        head = "concat_head"
    b.layer(L.InnerProduct, [head], ["logit"], num_output=1, act_type=hugectr.Activation_t.Non)
    b.layer(L.BinaryCrossEntropyLoss, ["logit", "label"], ["loss"])


def _mmoe(b: _Builder, variant) -> None:
    """mmoe.py:41-203: three experts gated per task, or one shared
    bottom; two towers and two losses weighted 0.5 each."""
    L = hugectr.Layer_t
    b.input([("data1", 1, True, len(MMOE_SLOTS))], label_dim=[1, 1], label_name=["50k_label", "married_label"],
            dense_dim=2, label_weights={"50k_label": 0.5, "married_label": 0.5})
    b.embedding("embedding", "data1", MMOE_SLOTS, 16, 1000)
    b.layer(L.Reshape, ["embedding"], ["reshape_embedding"], leading_dim=len(MMOE_SLOTS) * 16)
    n_expert = 1 if variant == "shared_bottom" else 3
    for e in range(n_expert):
        b.layer(L.InnerProduct, ["reshape_embedding"], [f"e{e}_fc1"], num_output=256)
        b.layer(L.ReLU, [f"e{e}_fc1"], [f"e{e}_relu1"])
        b.layer(L.InnerProduct, [f"e{e}_relu1"], [f"e{e}_out"], num_output=128)

    def tower(task):  # mmoe.py:100-126
        b.layer(L.InnerProduct, [f"tower_{task}_input"], [f"tower_{task}_fc"], num_output=64)
        b.layer(L.ReLU, [f"tower_{task}_fc"], [f"tower_{task}_relu"])
        b.layer(L.InnerProduct, [f"tower_{task}_relu"], [f"{task}_out"], num_output=1,
                act_type=hugectr.Activation_t.Non)

    for task in ("A", "B"):
        if variant == "shared_bottom":
            b.layer(L.InnerProduct, ["e0_out"], [f"tower_{task}_input"], num_output=128)
            tower(task)
            continue
        b.layer(L.InnerProduct, ["reshape_embedding"], [f"g{task}_dense"], num_output=n_expert)
        b.layer(L.Softmax, [f"g{task}_dense"], [f"g{task}_softmax"])
        b.layer(L.Slice, [f"g{task}_softmax"], [f"g{task}_e{e}" for e in range(n_expert)],
                ranges=[(e, e + 1) for e in range(n_expert)])
        gated = []
        for e in range(n_expert):
            b.layer(L.Scale, [f"g{task}_e{e}"], [f"g{task}_e{e}_scaled"], axis=0, factor=128)
            b.layer(L.ElementwiseMultiply, [f"e{e}_out", f"g{task}_e{e}_scaled"], [f"e{e}_{task}_gated"])
            gated.append(f"e{e}_{task}_gated")
        b.layer(L.Add, gated, [f"tower_{task}_input"])
        tower(task)
    b.layer(L.BinaryCrossEntropyLoss, ["A_out", "50k_label"], ["lossA"])
    b.layer(L.BinaryCrossEntropyLoss, ["B_out", "married_label"], ["lossB"])


def _din(b: _Builder, variant) -> None:
    """din.py:30-259: attention over the history from Scale / Sub /
    ElementwiseMultiply / Softmax, a Dice MLP."""
    L = hugectr.Layer_t
    ev = 18
    b.input([("UserID", 1, True, 1), ("GoodID", 1, True, 11), ("CateID", 1, True, 11)], dense_dim=1)
    for name, bottom, slots, mb in (("sparse_embedding_user", "UserID", [USER_VOCAB], 84),
                                    ("sparse_embedding_good", "GoodID", [GOOD_VOCAB] * 11, 72),
                                    ("sparse_embedding_cate", "CateID", [CATE_VOCAB] * 11, 30)):
        b.embedding(name, bottom, slots, ev, mb)
    b.layer(L.FusedReshapeConcat, ["sparse_embedding_good", "sparse_embedding_cate"],
            ["FusedReshapeConcat_item_his_em", "FusedReshapeConcat_item"])
    b.layer(L.Scale, ["FusedReshapeConcat_item"], ["Scale_item"], axis=1, factor=SEQ)
    b.layer(L.Sub, ["Scale_item", "FusedReshapeConcat_item_his_em"], ["sub_ih"])
    b.layer(L.ElementwiseMultiply, ["Scale_item", "FusedReshapeConcat_item_his_em"], ["ElementwiseMul_i"])
    b.layer(L.Concat, ["Scale_item", "FusedReshapeConcat_item_his_em", "sub_ih", "ElementwiseMul_i"],
            ["concat_i_h"])
    b.layer(L.InnerProduct, ["concat_i_h"], ["fc_att_i2"], num_output=40)
    b.layer(L.InnerProduct, ["fc_att_i2"], ["fc_att_i3"], num_output=1)
    b.layer(L.Reshape, ["fc_att_i3"], ["reshape_score"], leading_dim=SEQ)
    b.layer(L.Softmax, ["reshape_score"], ["softmax_att_i"])
    b.layer(L.Scale, ["softmax_att_i"], ["Scale_i"], axis=0, factor=2 * ev)
    b.layer(L.Reshape, ["FusedReshapeConcat_item_his_em"], ["reshape_item_his"], leading_dim=SEQ * 2 * ev)
    b.layer(L.ElementwiseMultiply, ["Scale_i", "reshape_item_his"], ["ElementwiseMul_ih"])
    b.layer(L.ReduceSum, ["ElementwiseMul_ih"], ["reduce_ih"], axis=1)
    b.layer(L.Reshape, ["FusedReshapeConcat_item_his_em"], ["reshape_his"], leading_dim=2 * ev, time_step=SEQ)
    b.layer(L.ReduceMean, ["reshape_his"], ["reduce_item_his"], axis=1)
    b.layer(L.Reshape, ["reduce_item_his"], ["reshape_reduce_item_his"], leading_dim=2 * ev)
    b.layer(L.Reshape, ["sparse_embedding_user"], ["reshape_user"], leading_dim=ev)
    b.layer(L.Concat, ["reshape_user", "reshape_reduce_item_his", "reduce_ih", "FusedReshapeConcat_item"],
            ["concat_din_i"])
    b.layer(L.InnerProduct, ["concat_din_i"], ["fc_din_i1"], num_output=200)
    b.layer(L.PReLU_Dice, ["fc_din_i1"], ["dice_1"], elu_alpha=0.2, eps=1e-8)
    b.layer(L.InnerProduct, ["dice_1"], ["fc_din_i2"], num_output=80)
    b.layer(L.PReLU_Dice, ["fc_din_i2"], ["dice_2"], elu_alpha=0.2, eps=1e-8)
    b.layer(L.InnerProduct, ["dice_2"], ["fc3"], num_output=1, act_type=hugectr.Activation_t.Non)
    b.layer(L.BinaryCrossEntropyLoss, ["fc3", "label"], ["loss"])


def _bst(b: _Builder, variant) -> None:
    """bst.py:33-220: a MultiHeadAttention + LayerNorm block over the
    history, masked by SequenceMask, mean pooled, into a Dice MLP."""
    L = hugectr.Layer_t
    b.input([("UserID", 1, True, 1), ("GoodID", 1, True, SEQ), ("Target_Good", 1, True, 1),
             ("CateID", 1, True, SEQ), ("Target_Cate", 1, True, 1)], dense_dim=1)
    for name, bottom, slots, ev, mb in (("sparse_embedding_user", "UserID", [USER_VOCAB], 18, 84),
                                        ("sparse_embedding_good", "GoodID", [GOOD_VOCAB] * SEQ, 16, 72),
                                        ("sparse_embedding_item_good", "Target_Good", [GOOD_VOCAB], 16, 8),
                                        ("sparse_embedding_cate", "CateID", [CATE_VOCAB] * SEQ, 16, 30),
                                        ("sparse_embedding_item_cate", "Target_Cate", [CATE_VOCAB], 16, 4)):
        b.embedding(name, bottom, slots, ev, mb)
    b.layer(L.SequenceMask, ["dense", "dense"], ["sequence_mask"], max_sequence_len_from=SEQ,
            max_sequence_len_to=SEQ)
    b.layer(L.Concat, ["sparse_embedding_cate", "sparse_embedding_good"], ["hist_emb_list"], axis=2)
    for proj in ("query_emb", "key_emb", "value_emb"):
        b.layer(L.InnerProduct, ["hist_emb_list"], [proj], num_output=32)
    b.layer(L.MultiHeadAttention, ["query_emb", "key_emb", "value_emb", "sequence_mask"], ["attention_out"],
            num_attention_heads=4)
    b.layer(L.Add, ["attention_out", "query_emb"], ["attention_add_shortcut"])
    b.layer(L.LayerNorm, ["attention_add_shortcut"], ["attention_layer_norm"])
    b.layer(L.InnerProduct, ["attention_layer_norm"], ["attention_ffn1"], num_output=128)
    b.layer(L.InnerProduct, ["attention_ffn1"], ["attention_ffn2"], num_output=32)
    b.layer(L.Add, ["attention_ffn2", "attention_layer_norm"], ["attention_ffn_shortcut"])
    b.layer(L.LayerNorm, ["attention_ffn_shortcut"], ["attention_ffn_layer_norm"])
    b.layer(L.ReduceMean, ["attention_ffn_layer_norm"], ["reduce_attention_ffn_layer_norm"], axis=1)
    b.layer(L.Reshape, ["reduce_attention_ffn_layer_norm"], ["reshape_attention_out"], leading_dim=32)
    for emb, dim in (("sparse_embedding_user", 18), ("sparse_embedding_item_good", 16),
                     ("sparse_embedding_item_cate", 16)):
        b.layer(L.Reshape, [emb], [f"reshape_{emb}"], leading_dim=dim)
    b.layer(L.Concat, ["reshape_sparse_embedding_user", "reshape_sparse_embedding_item_good",
                       "reshape_sparse_embedding_item_cate", "reshape_attention_out"], ["dnn_input"])
    prev = "dnn_input"
    for i, width in enumerate((256, 128, 64), start=1):
        b.layer(L.InnerProduct, [prev], [f"fc_bst_i{i}"], num_output=width)
        b.layer(L.PReLU_Dice, [f"fc_bst_i{i}"], [f"dice_{i}"], elu_alpha=0.2, eps=1e-8)
        prev = f"dice_{i}"
    b.layer(L.InnerProduct, [prev], ["logit"], num_output=1, act_type=hugectr.Activation_t.Non)
    b.layer(L.BinaryCrossEntropyLoss, ["logit", "label"], ["loss"])


# name: (graph, optimizer arguments, solver lr, max_eval_batches)
_SAMPLES = {
    "criteo_parquet": (_criteo_parquet, dict(optimizer_type=hugectr.Optimizer_t.Adam), None, 100),
    "wdl": (_wdl, dict(optimizer_type=hugectr.Optimizer_t.Adam, beta1=0.9, beta2=0.999, epsilon=1e-7), None, 100),
    "dcn": (_dcn, dict(optimizer_type=hugectr.Optimizer_t.Adam), None, 100),
    "deepfm": (_deepfm, dict(optimizer_type=hugectr.Optimizer_t.Adam), None, 100),
    "ncf": (_ncf, dict(optimizer_type=hugectr.Optimizer_t.Adam, beta1=0.25, beta2=0.5, epsilon=1e-8), 0.0045, 100),
    "mmoe": (_mmoe, dict(optimizer_type=hugectr.Optimizer_t.SGD, atomic_update=True), None, 100),
    "din": (_din, dict(optimizer_type=hugectr.Optimizer_t.Adam, beta1=0.9, beta2=0.999, epsilon=1e-9), None, 70),
    "bst": (_bst, dict(optimizer_type=hugectr.Optimizer_t.Adam, beta1=0.9, beta2=0.999, epsilon=1e-9), None, 70),
}


def build_sample(name: str, rm, batchsize: int = 2048, variant: Optional[str] = None, slot_cap: int = 0,
                 dropout_rate: Optional[float] = None, synthetic_batches: int = 64,
                 synthetic_learnable: bool = False, reader=None, lr: float = 0.001, compile_model: bool = True,
                 **solver_kwargs):
    """The graph of `samples/<name>.py` (`variant` for ncf and mmoe) on
    `rm.device` over `rm.num_devices` ranks, compiled unless
    `compile_model` is False (the sample scripts compile under `__main__`).
    The solver is the sample's (`CreateSolver` at its lines 14-26: `lr`, the
    `--lr` flag, default 0.001, which ncf fixes at 0.0045), with
    `solver_kwargs` (`Solver` fields) added; `reader` (a
    `DataReaderParams`, e.g. the sample's own `make_reader`'s Parquet files)
    replaces the synthetic reader."""
    graph, opt_kw, fixed_lr, max_eval = _SAMPLES[name]
    variant = variant or DEFAULT_VARIANT.get(name)
    solver_kwargs.setdefault("max_eval_batches", max_eval)
    solver = hugectr.CreateSolver(batchsize_eval=batchsize, batchsize=batchsize, lr=fixed_lr or lr,
                                  repeat_dataset=True, **solver_kwargs)
    reader = reader or hugectr.DataReaderParams(data_reader_type=DataReaderType_t.Synthetic,
                                      synthetic_num_batches=synthetic_batches, synthetic_alpha=1.05,
                                      synthetic_learnable=synthetic_learnable)
    model = hugectr.Model(solver, reader, hugectr.CreateOptimizer(**opt_kw), resource_manager=rm)
    graph(_Builder(model, slot_cap, dropout_rate), variant)
    if compile_model:
        model.compile()
    return model


def build_tiny_sample(name: str, rm, variant: Optional[str] = None, **kwargs):
    """A sample at the tests' size (`TINY_SAMPLE`)."""
    return build_sample(name, rm, variant=variant, **dict(TINY_SAMPLE, **kwargs))
