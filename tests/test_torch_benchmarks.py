"""The port's benchmark suite (`hugectr_tpu_torch/benchmarks/`) and the
one-hot groups of more than 48 lookups it needs, on the CPU.

- `embedding_collection.train` prints one JSON line with the JAX runner's
  keys for every case, at a tiny cap; the 7-table case (split, with a
  superhot tier) and the 200-table case (190 lookups in one group) train
  as the JAX runner builds them (train.py:86-150) from carried state.
- A one-hot group of 100 lookups (the 510-table case's group of its 100
  one-row-hot tables, at a tiny width) forwards as the JAX package's, in
  ceil(100 / 48) = 3 calls, unweighted and weighted.
- `weighted_bench` and `host_spill_bench` run at tiny sizes;
  `dense_exchange_bytes` over 8 gloo ranks measures the bytes the JAX
  script's formula gives for the same caps.
- The JAX samples share one data directory (a fault of the reference):
  another sample's reader over it fails; the port's samples do not share.

Tolerances: the mixed-precision models' losses rtol 1e-5 at step 1 (1e-3
for the 1,528-wide top MLP input of the 200-table case) and 5e-3 after
(bf16 products summed in another order, as tests/test_torch_bench.py);
their embedding tops rtol 1e-5 / atol 1e-6; tables rtol 1e-3 / atol 5e-4
(a tenth of lr) after 2 steps: AdaGrad's second step moves an element by lr
x g2 / sqrt(g1^2 + g2^2), and the bf16 products perturb small gradients by
a few percent; a sign flip would be 2 lr. One-hot forwards rtol 1e-5 /
atol 1e-6 (float32 sums in another order).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import hugectr_tpu as jh
from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.core.types import Combiner_t as JComb
from hugectr_tpu.core.types import Optimizer_t as JOpt
from hugectr_tpu.embedding.collection import EmbeddingCollection as JEC
from hugectr_tpu.optim.params import OptParams as JOptParams
from hugectr_tpu.parallel import plan as jplan

from hugectr_tpu_torch import ops
from hugectr_tpu_torch.benchmarks import dense_exchange_bytes as dxb
from hugectr_tpu_torch.benchmarks import host_spill_bench, weighted_bench
from hugectr_tpu_torch.benchmarks.embedding_collection import configs, train
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Combiner_t as TComb
from hugectr_tpu_torch.core.types import Optimizer_t as TOpt
from hugectr_tpu_torch.embedding.collection import EmbeddingCollection as TEC
from hugectr_tpu_torch.ops import onehot_matmul as oh
from hugectr_tpu_torch.optim.params import OptParams as TOptParams
from hugectr_tpu_torch.parallel import plan as tplan
from hugectr_tpu_torch.tools.carry import load_jax_state

torch.set_num_threads(1)
CPU = ResourceManager.create(device="cpu")
JAX_KEYS = ("case", "examples_per_sec", "sec_per_iter", "batchsize", "vocab_cap", "ev_size", "hotness_total",
            "devices", "skips")
SKIPS = ("SKIP_EMBEDDING", "SKIP_EMBEDDING_UPDATE", "SKIP_DENSE_LAYERS", "SKIP_BOTTOM_MLP", "SKIP_TOP_MLP")


@pytest.fixture
def no_skips(monkeypatch):
    for k in SKIPS:
        monkeypatch.delenv(k, raising=False)


def test_cases_are_the_jax_tuples():
    import benchmarks.embedding_collection.configs as jconfigs

    assert configs.CASES == jconfigs.CASES
    for case in configs.CASES:
        assert configs.expand(case, 64) == jconfigs.expand(case, 64)
    assert len(configs.expand("180table_70B_hotness80")[0]) == 177
    assert len(configs.expand("200table_100B_hotness20")[0]) == 190


@pytest.mark.parametrize("case", train.CASE_NAMES)
def test_train_prints_one_json_line_for_each_case(capsys, no_skips, case):
    argv = ["--device", "cpu", "--case", case, "--batchsize", "16", "--vocab_cap", "64", "--ev_size", "8",
            "--iters", "2", "--warmup", "1"]
    assert train.main(argv) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(JAX_KEYS) <= set(rec) and rec["device"] == "cpu"
    assert (rec["case"], rec["batchsize"], rec["vocab_cap"], rec["ev_size"], rec["devices"]) == (case, 16, 64, 8, 1)
    hot = 253 if case == "dcnv2" else sum(configs.expand(case)[1])
    assert rec["hotness_total"] == hot and rec["examples_per_sec"] > 0 and rec["skips"] == []


def test_skip_env_maps_the_mlp_flags():
    env = {"SKIP_BOTTOM_MLP": "1", "SKIP_TOP_MLP": "1", "SKIP_DENSE_LAYERS": "x"}
    train.skip_env(env)
    assert env["SKIP_DENSE_LAYERS"] == "x,mlp1,mlp2,m2"
    env = {"SKIP_TOP_MLP": "1"}
    train.skip_env(env)
    assert env["SKIP_DENSE_LAYERS"] == "mlp2,m2"


def test_dcnv2_case_keeps_the_jax_caps(no_skips):
    """The default cap 1,000,000 caps dcnv2 too; only 0 gives 2,000,000."""
    args = train.parser().parse_args(["--case", "dcnv2", "--device", "cpu"])
    assert args.vocab_cap == 1_000_000 and args.optimizer == "adagrad" and args.batchsize == 8192
    assert (args.vocab_cap or 2_000_000) == 1_000_000
    assert (train.parser().parse_args(["--vocab_cap", "0"]).vocab_cap or 2_000_000) == 2_000_000


def _jax_synthetic(rm, case, batch, cap, ev, alpha=1.1, optimizer="adagrad"):
    """benchmarks/embedding_collection/train.py:86-150 in the JAX package."""
    sizes, hots = configs.expand(case, cap)
    solver = jh.CreateSolver(max_eval_batches=4, batchsize_eval=batch, batchsize=batch, lr=0.005,
                             use_mixed_precision=True, repeat_dataset=True)
    reader = jh.DataReaderParams(data_reader_type=jh.DataReaderType_t.Synthetic, synthetic_num_batches=16,
                                 synthetic_alpha=alpha)
    opt = jh.CreateOptimizer(optimizer_type=jh.Optimizer_t(optimizer), initial_accu_value=0.0)
    model = jh.Model(solver, reader, opt, resource_manager=rm)
    model.add(jh.Input(label_dim=1, label_name="label", dense_dim=13, dense_name="dense",
                       data_reader_sparse_param_array=[jh.DataReaderSparseParam(f"data{i}", hots[i], True, 1)
                                                       for i in range(len(sizes))]))
    tables = [jh.EmbeddingTableConfig(name=str(i), max_vocabulary_size=sizes[i], ev_size=ev)
              for i in range(len(sizes))]
    ebc = jh.EmbeddingCollectionConfig()
    ebc.embedding_lookup(table_config=tables, bottom_name=[f"data{i}" for i in range(len(sizes))], top_name="emb",
                         combiner=["sum"] * len(sizes))
    names = [str(i) for i in range(len(sizes))]
    ebc.shard(shard_matrix=[names] * rm.num_devices, shard_strategy=[("mp", names)])
    model.add(ebc)
    model.add(jh.DenseLayer(layer_type=jh.Layer_t.MLP, bottom_names=["dense"], top_names=["mlp1"],
                            num_outputs=[512, 256, ev]))
    model.add(jh.DenseLayer(layer_type=jh.Layer_t.Concat, bottom_names=["emb", "mlp1"], top_names=["c"]))
    model.add(jh.DenseLayer(layer_type=jh.Layer_t.MLP, bottom_names=["c"], top_names=["m2"],
                            num_outputs=[1024, 512, 256, 1],
                            activations=[jh.Activation_t.Relu] * 3 + [jh.Activation_t.Non]))
    model.add(jh.DenseLayer(layer_type=jh.Layer_t.BinaryCrossEntropyLoss, bottom_names=["m2", "label"],
                            top_names=["loss"]))
    model.compile()
    return model


# (cap, the JAX variables, the port's Solver fields): the 7-table case
# split at 2,048 rows with a 64-row superhot tier (the README's tiered row,
# scaled down); the 200-table case with the one-hot engine off (its 190
# lookups in one rowop group: JAX compiles a 190-lookup one-hot group for
# half a minute; the port's chunked one-hot forward is held against JAX
# below, at the 510-table case's 100-lookup group)
SYNTH = {
    "7table_470B_hotness20": (20000, dict(HCTR_TPU_HOT_ROWS="2048", HCTR_TPU_SUPERHOT_ROWS="64",
                                          HCTR_TPU_SPLIT_VOCAB="4096"),
                              dict(hot_rows=2048, superhot_rows=64, split_vocab=4096)),
    "200table_100B_hotness20": (64, {"HCTR_TPU_ONEHOT_VOCAB": "0"}, dict(onehot_vocab=0)),
}


@pytest.mark.parametrize("case", sorted(SYNTH))
def test_synthetic_case_trains_as_jax(monkeypatch, no_skips, case):
    cap, env, port = SYNTH[case]
    base = {"HCTR_TPU_ONEHOT_VOCAB": "8192", "HCTR_TPU_DENSE_UPDATE_ROWS": "262144",
            "HCTR_TPU_DENSE_KEY_RATIO": "0.3", "HCTR_TPU_HOT_ROWS": "0", "HCTR_TPU_SEGSUM": "xla"}
    for k, v in {**base, **env}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("HCTR_TPU_EMB_DTYPE", raising=False)
    batch, ev = 16, 8
    jm = _jax_synthetic(JaxResourceManager.create(num_devices=1), case, batch, cap, ev)
    tm = train.build_synthetic(CPU, case, batch, cap, ev, 1.1, "adagrad", **port)
    assert [(g.name, g.compute_kind) for g in tm.ec.plan.groups] == [(g.name, g.compute_kind) for g in jm.ec.plan.groups]
    if case.startswith("200"):
        (g,) = tm.ec.plan.groups
        assert g.compute_kind == "rowop" and len(g.lookups) == 190
    else:
        assert tm.ec.plan.table_splits == jm.ec.plan.table_splits and tm.ec.plan.table_splits
    load_jax_state(tm, jax.device_get(jm.state))
    # the embedding tops of the first batch: float32, as JAX's
    first = next(iter(tm.train_reader))
    np.testing.assert_allclose(tm.check_out_tensor("emb", first), jm.check_out_tensor("emb", first),
                               rtol=1e-5, atol=1e-6)
    # step 1's loss: the top MLP's bf16 products over rows of 8 + 7 x 8 or
    # 8 + 190 x 8 inputs, summed in float32 in another order, then rounded
    # to bf16; over 1,528 inputs more of them round the other way
    rtol1 = 1e-5 if case.startswith("7") else 1e-3
    for step in range(2):
        jl, tl = jm.train(), tm.train()
        np.testing.assert_allclose(tl, jl, rtol=rtol1 if step == 0 else 5e-3, err_msg=f"loss at step {step + 1}")
    s = jax.device_get(jm.state)
    for name in ("0", "3", "6") if case.startswith("7") else ("0", "95", "189"):
        np.testing.assert_allclose(tm.ec.export_table(tm.tables, name), jm.ec.export_table(s["emb_tables"], name),
                                   rtol=1e-3, atol=5e-4, err_msg=f"table {name}")
    tm._close_readers()


def _group100(pkg, comb, weighted):
    """The 510-table case's first 100 tables (1,000 rows, hotness 1) at a
    tiny width, one Sum lookup each, every 7th a Mean."""
    return [
        pkg.LookupConfig(i, pkg.EmbeddingTableConfig(str(i), 1000, 4), f"f{i}", f"e{i}",
                         comb.Mean if i % 7 == 0 else comb.Sum, 1 + (i % 3),
                         **({"sp_weight_name": f"w{i}"} if weighted else {}))
        for i in range(100)
    ]


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_onehot_group_of_100_lookups_matches_jax(monkeypatch, weighted):
    monkeypatch.setenv("HCTR_TPU_ONEHOT_VOCAB", "8192")
    monkeypatch.setenv("HCTR_TPU_HOT_ROWS", "0")
    rng = np.random.default_rng(16)
    b = 24
    lks = _group100(tplan, TComb, weighted)
    feats = {lk.bottom_name: rng.integers(-1, 1200, (b, lk.max_hotness)).astype(np.int32) for lk in lks}
    fw = ({lk.sp_weight_name: rng.random((b, lk.max_hotness)).astype(np.float32) for lk in lks}
          if weighted else None)
    jpl = jplan.compile_plan(_group100(jplan, JComb, weighted), jplan.ShardingPlan([]), 1)
    tpl = tplan.compile_plan(lks, tplan.ShardingPlan([]), 1)
    assert [(g.compute_kind, len(g.lookups)) for g in tpl.groups] == [
        (g.compute_kind, len(g.lookups)) for g in jpl.groups] == [("onehot", 100)]
    jec = JEC(jpl, JaxResourceManager.create(num_devices=1), JOptParams(JOpt.AdaGrad))
    jt = jec.init(jax.random.key(0))
    tec = TEC(tpl, CPU, TOptParams(TOpt.AdaGrad))
    tt = tec.init(CPU.generator(0))
    for i in range(100):
        tt = tec.import_table(tt, str(i), np.asarray(jec.export_table(jt, str(i))))
    jout = jec.forward(jt, feats, feature_weights=fw)
    ops.reset_counts()
    tout = tec.forward(tt, {k: torch.from_numpy(v) for k, v in feats.items()},
                       {k: torch.from_numpy(v) for k, v in fw.items()} if fw else None)
    assert ops.plain_counts()["onehot_fwd"] == 3 and oh.MAX_GROUP_LOOKUPS == 48
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_chunked_forward_equals_one_plain_call():
    """`onehot_fwd_chunked` at 49, 96 and 100 lookups writes every lookup's
    columns, as one plain call over the whole group does."""
    rng = np.random.default_rng(3)
    for n in (49, 96, 100):
        lookups = [oh.GroupLookup(10 * i, 10, 4 * i, i % 5 == 0) for i in range(n)]
        keys = [torch.from_numpy(rng.integers(-1, 15, (8, 1 + i % 4)).astype(np.int32)) for i in range(n)]
        table = torch.from_numpy(rng.normal(size=(10 * n, 4)).astype(np.float32))
        ws = [torch.rand(k.shape) for k in keys]
        for w in (None, ws):
            ops.reset_counts()
            got = oh.onehot_fwd_chunked(keys, lookups, table, 4 * n, w)
            assert ops.plain_counts()["onehot_fwd"] == -(-n // 48)
            assert torch.equal(got, oh.onehot_fwd_group_plain(keys, lookups, table, 4 * n, w))
    with pytest.raises(ValueError, match="out must be"):
        oh.onehot_fwd_group(keys[:2], lookups[:2], table, 4 * n, out=torch.zeros(8, 3))


def test_weighted_and_host_spill_benches_run_on_cpu():
    out = weighted_bench.run_case(CPU, False, steps=2, warmup=1, batch=64, vocab=5000)
    rec = out["record"]
    assert rec["device"] == "cpu" and rec["examples_per_sec"] > 0 and len(rec["step_ms"]) == 2
    out = host_spill_bench.run(CPU, batch=64, capacity=1024, ev=8, hotness=5, steps=3, warm_spill=2)
    rec = out["record"]
    out["model"]._close_readers()
    assert rec["warmup_steps"] == [5, 12] and rec["host_size"] > 0 and np.isfinite(rec["losses"]).all()


def test_dense_exchange_bytes_over_8_ranks_meet_the_jax_formula():
    """At 8 gloo ranks the forward's all_to_all moves the formula's half of
    the unique bytes exactly, and the update's float32 sums twice the
    other half (the formula counts them as bf16; both packages send f32)."""
    name, hot, vocab = dxb.CASES[2]
    rec = dxb.run_case(name, hot, vocab, batch=64, world=8)
    f = dxb.formula(64, hot, rec["cap"], 8)
    assert rec["exchange_ran"] and rec["finite"] and rec["all_ranks_alike"]
    assert rec["formula_unique_bytes"] == f["unique"]
    assert rec["measured_fwd_ring_bytes"] == f["unique"] / 2
    assert rec["measured_bwd_ring_bytes"] == f["unique"]
    assert rec["cap"] == dxb.least_cap(dxb.case_keys(np.random.default_rng(dxb.SEED), 64, hot, vocab), 8)


def test_jax_samples_share_one_data_dir_and_the_port_does_not(monkeypatch, tmp_path):
    """samples/common.py:51 sends every JAX sample to ./_sample_data: after
    one sample (26 slots) wrote its set there, another sample's (2 slots)
    reader over it raises (hugectr_tpu/data/reader.py:367). The port writes
    ./_sample_data_torch/<sample> (hugectr_tpu_torch/samples/common.py:69)."""
    import argparse
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "samples"))
    import common as jcommon
    from hugectr_tpu.data.reader import BatchSpec as JSpec, ParquetReader as JReader, SparseFeatureSpec as JSparse

    from hugectr_tpu_torch.data.reader import BatchSpec as TSpec, ParquetReader as TReader
    from hugectr_tpu_torch.data.reader import SparseFeatureSpec as TSparse
    from hugectr_tpu_torch.samples import common as tcommon

    monkeypatch.chdir(tmp_path)
    small = dict(num_samples_per_file=64, num_files=2)

    def spec(cls, sparse, slots):
        return cls(batch_size=16, label_dims=(1,), label_names=("label",), dense_dim=13, dense_name="dense",
                   sparse=(sparse("data1", (1,) * slots),))

    args = argparse.Namespace(data_dir="")
    jcommon.make_reader(args, [100] * 26, **small)
    ncf = jcommon.make_reader(args, [100, 50], **small)
    with pytest.raises(ValueError, match="dataset has 26 cat columns, model wants 2"):
        JReader(ncf.source[0], spec(JSpec, JSparse, 2))
    tcommon.make_reader(argparse.Namespace(data_dir="", sample="dcn"), [100] * 26, **small)
    tncf = tcommon.make_reader(argparse.Namespace(data_dir="", sample="ncf"), [100, 50], **small)
    reader = TReader(tncf.source[0], spec(TSpec, TSparse, 2))
    assert os.path.dirname(tncf.source[0]).endswith(os.path.join("_sample_data_torch", "ncf"))
    del reader
