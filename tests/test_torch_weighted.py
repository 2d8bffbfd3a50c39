"""The port's weighted lookups (`sp_weight_name`) against the JAX package
(tests/test_weighted_lookup.py's cases the port can run): per-key weights on
the one-hot, dense-sweep and sorted routes, the split with and without a
superhot tier, the Model's weight features; W = 2 over a spawned gloo
group against JAX's 2-device CPU mesh (the owner-partitioned forward with
the weights riding its sort, the unique-key dense exchange) is
tests/test_torch_weighted_ranks.py, and the weighted update on each route
tests/test_torch_weighted_update.py. The JAX side
reaches the one-hot engine through its XLA counts path (the path its
weighted groups take, collection.py:1318-1320), which these tests hold the
port's plain kernels against.

Tolerances: float32 forward outputs rtol 1e-6 / atol 1e-6 (the same
products summed in another order: JAX's one-hot counts matmul divides the
counts by a Mean's sum of weights before the product, the port divides the
sum); tables and optimizer state rtol 1e-4 / atol 1e-5 (updates summed in
another order), as the other collection tests hold them. bf16 at W = 2:
forward outputs bitwise (both packages multiply each row by its weight in
bf16 and add the owned rows in the same order with a rounding after every
add, then sum the ranks' pools in float32 rounded once), tables and state
within one bf16 ulp at the tables' scale (rtol 2^-7, atol 2^-7 x 0.1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.core.types import INVALID_KEY
from hugectr_tpu.core.types import Combiner_t as JComb
from hugectr_tpu.core.types import Optimizer_t as JOpt
from hugectr_tpu.embedding.collection import EmbeddingCollection as JEC
from hugectr_tpu.optim.params import OptParams as JOptParams
from hugectr_tpu.parallel import plan as jplan

import hugectr_tpu_torch as thugectr
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Combiner_t as TComb
from hugectr_tpu_torch.core.types import Optimizer_t as TOpt
from hugectr_tpu_torch.embedding.collection import EmbeddingCollection as TEC
from hugectr_tpu_torch.ops import onehot_matmul as oh
from hugectr_tpu_torch.ops import ordered_pool as op
from hugectr_tpu_torch.optim.params import OptParams as TOptParams
from hugectr_tpu_torch.parallel import plan as tplan

torch.set_num_threads(1)
CPU = ResourceManager.create(device="cpu")
FWD_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_ULP = 2.0**-7
BF16_TOL = dict(rtol=BF16_ULP, atol=BF16_ULP * 0.1)
E = 8

# the engine of each route: (the port's settings, the JAX package's variables)
ROUTES = {
    "dense": (dict(onehot_vocab=0, dense_update_rows=1000),
              {"HCTR_TPU_ONEHOT_VOCAB": "0", "HCTR_TPU_DENSE_UPDATE_ROWS": "1000"}),
    "sorted": (dict(onehot_vocab=0, dense_update_rows=0),
               {"HCTR_TPU_ONEHOT_VOCAB": "0", "HCTR_TPU_DENSE_UPDATE_ROWS": "0"}),
    "onehot": (dict(onehot_vocab=128, dense_update_rows=0),
               {"HCTR_TPU_ONEHOT_VOCAB": "128", "HCTR_TPU_DENSE_UPDATE_ROWS": "0"}),
}
STRATEGIES = {"all_mp": [("mp", ["t0", "t1", "t2"])], "all_dp": [("dp", ["t0", "t1", "t2"])],
              "mixed": [("mp", ["t0"]), ("dp", ["t1", "t2"])]}


def _lookups(pkg, comb):
    """tests/test_weighted_lookup.py:24-34: weighted Sum, Mean and Concat
    lookups and an unweighted Sum lookup sharing t0's group."""
    t0 = pkg.EmbeddingTableConfig("t0", 100, E)
    t1 = pkg.EmbeddingTableConfig("t1", 57, E)
    t2 = pkg.EmbeddingTableConfig("t2", 31, E)
    return [pkg.LookupConfig(0, t0, "f0", "e0", comb.Sum, 4, sp_weight_name="w0"),
            pkg.LookupConfig(1, t1, "f1", "e1", comb.Mean, 3, sp_weight_name="w1"),
            pkg.LookupConfig(2, t0, "f2", "e2", comb.Sum, 2),
            pkg.LookupConfig(3, t2, "f3", "e3", comb.Concat, 2, sp_weight_name="w3")]


def _keys(rng, b, h, vocab, pad=0.3):
    k = rng.integers(0, vocab, size=(b, h)).astype(np.int32)
    m = rng.random((b, h)) < pad
    m[:, 0] = False
    k[m] = INVALID_KEY
    return k


def _data(rng, b=32):
    """tests/test_weighted_lookup.py:95-111: mixed-sign weights, a Mean
    lookup's row 0 all 0 (the zero-sum guard); and each top's cotangents."""
    feats = {"f0": _keys(rng, b, 4, 100), "f1": _keys(rng, b, 3, 57), "f2": _keys(rng, b, 2, 100, 0.0),
             "f3": _keys(rng, b, 2, 31, 0.0)}
    weights = {"w0": rng.normal(size=(b, 4)).astype(np.float32),
               "w1": (rng.random((b, 3)) + 0.1).astype(np.float32),
               "w3": rng.normal(size=(b, 2)).astype(np.float32)}
    weights["w1"][0] = 0.0
    d = {"e0": rng.normal(size=(b, E)), "e1": rng.normal(size=(b, E)), "e2": rng.normal(size=(b, E)),
         "e3": rng.normal(size=(b, 2 * E))}
    return feats, weights, {k: v.astype(np.float32) for k, v in d.items()}


class Pair:
    """One collection in each package over the same tables, on one device."""

    def __init__(self, monkeypatch, lookups_of, strategy, route="sorted", opt="sgd", split=None):
        engine, env = ROUTES[route]
        split = split or {}
        if "onehot_vocab" in split:  # the split's own one-hot threshold
            engine = dict(engine, onehot_vocab=split["onehot_vocab"])
            env = dict(env, HCTR_TPU_ONEHOT_VOCAB=str(split["onehot_vocab"]))
        for k, v in {**env, "HCTR_TPU_DENSE_KEY_RATIO": "0", "HCTR_TPU_SEGSUM": "xla", "HCTR_TPU_ONEHOT_KERNEL": "xla",
                     "HCTR_TPU_HOT_ROWS": str(split.get("hot_rows", 0)),
                     "HCTR_TPU_SUPERHOT_ROWS": str(split.get("superhot_rows", 0)),
                     "HCTR_TPU_SPLIT_VOCAB": "0"}.items():
            monkeypatch.setenv(k, v)
        jpl = jplan.compile_plan(lookups_of(jplan, JComb), jplan.ShardingPlan(strategy), 1)
        tpl = tplan.compile_plan(lookups_of(tplan, TComb), tplan.ShardingPlan(strategy), 1,
                                 onehot_vocab=engine["onehot_vocab"], split_vocab=0,
                                 hot_rows=split.get("hot_rows", 0), superhot_rows=split.get("superhot_rows", 0))
        assert [(g.name, g.compute_kind, g.has_weights) for g in tpl.groups] == \
            [(g.name, g.compute_kind, g.has_weights) for g in jpl.groups]
        self.tplan = tpl
        hyper = dict(lr=0.1, initial_accu_value=0.1, epsilon=1e-7)
        self.jec = JEC(jpl, JaxResourceManager.create(num_devices=1), JOptParams(JOpt(opt), **hyper))
        self.tec = TEC(tpl, CPU, TOptParams(TOpt(opt), **hyper), dense_update_rows=engine["dense_update_rows"],
                       dense_key_ratio=0.0)
        jt = self.jec.init(jax.random.key(0))
        self.tt = self.tec.init(CPU.generator(0))
        rng = np.random.default_rng(17)
        self.names = sorted({lk.table.name for lk in tpl.lookups})
        for n in self.names:
            values = rng.normal(size=(int(self.jec.export_table(jt, n).shape[0]), E)).astype(np.float32)
            jt = self.jec.import_table(jt, n, values)
            self.tec.import_table(self.tt, n, values)
        self.jt, self.js = jt, self.jec.init_optimizer(jt)
        self.ts = self.tec.init_optimizer(self.tt)

    def forward(self, feats, weights):
        jout = jax.jit(self.jec.forward)(self.jt, feats, weights)
        tout = self.tec.forward(self.tt, _t(feats), _t(weights))
        assert sorted(jout) == sorted(tout)
        for k in jout:
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), **FWD_TOL, err_msg=k)
        return {k: v.numpy() for k, v in tout.items()}

    def step(self, feats, weights, d, lr=0.1):
        self.jt, self.js = jax.jit(self.jec.backward_and_update)(
            self.jt, self.js, feats, d, jnp.asarray(lr), jnp.asarray(1), weights)
        self.tec.backward_and_update(self.tt, self.ts, _t(feats), _t(d), torch.tensor(lr), 1, _t(weights))
        for n in self.names:
            np.testing.assert_allclose(self.tec.export_table(self.tt, n), self.jec.export_table(self.jt, n), **TOL,
                                       err_msg=n)
        for g in self.tplan.groups:
            for k, v in self.ts[g.name].items():
                np.testing.assert_allclose(v.numpy(), np.asarray(self.js[g.name][k]), **TOL, err_msg=f"{g.name} {k}")


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()} if tree is not None else None


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_weighted_forward_matches_jax(monkeypatch, strategy, route):
    """tests/test_weighted_lookup.py:119 on one device, on each route: the
    one-hot route's weighted lookups go through the kernel's plain version
    (per-key weights, a Mean divided by the sum of weights, 1 where it is
    0), the rowop groups through the weighted gather and pool."""
    p = Pair(monkeypatch, _lookups, STRATEGIES[strategy], route)
    if route == "onehot":
        assert [g.compute_kind for g in p.tplan.groups] == ["onehot", "rowop"]
    feats, weights, _d = _data(np.random.default_rng(7))
    p.forward(feats, weights)


def test_all_ones_weights_match_unweighted():
    """tests/test_weighted_lookup.py:239: weights of 1 reproduce the
    unweighted collection (forward and an AdaGrad step) on every route."""
    rng = np.random.default_rng(11)
    b = 16
    feats = {"f0": _keys(rng, b, 4, 64), "f1": _keys(rng, b, 3, 64)}
    d = {"e0": torch.from_numpy(rng.normal(size=(b, E)).astype(np.float32)),
         "e1": torch.from_numpy(rng.normal(size=(b, E)).astype(np.float32))}
    dense = rng.normal(size=(64, E)).astype(np.float32)
    ones = {"w0": torch.ones((b, 4)), "w1": torch.ones((b, 3))}
    for route in ROUTES:
        engine = ROUTES[route][0]
        got = {}
        for wname in ("w0", ""):
            t0 = tplan.EmbeddingTableConfig("t0", 64, E)
            lks = [tplan.LookupConfig(0, t0, "f0", "e0", TComb.Sum, 4, sp_weight_name=wname),
                   tplan.LookupConfig(1, t0, "f1", "e1", TComb.Mean, 3, sp_weight_name=wname and "w1")]
            pl = tplan.compile_plan(lks, tplan.ShardingPlan([("mp", ["t0"])]), 1, onehot_vocab=engine["onehot_vocab"])
            ec = TEC(pl, CPU, TOptParams(TOpt.AdaGrad, lr=0.1), dense_update_rows=engine["dense_update_rows"],
                     dense_key_ratio=0.0)
            tables = ec.init(CPU.generator(0))
            ec.import_table(tables, "t0", dense)
            state = ec.init_optimizer(tables)
            fw = ones if wname else None
            outs = ec.forward(tables, _t(feats), fw)
            ec.backward_and_update(tables, state, _t(feats), d, torch.tensor(0.1), 1, fw)
            got[wname] = ({k: v.numpy() for k, v in outs.items()}, ec.export_table(tables, "t0"))
        for k in got[""][0]:
            np.testing.assert_allclose(got["w0"][0][k], got[""][0][k], rtol=1e-6, atol=1e-6, err_msg=route)
        np.testing.assert_allclose(got["w0"][1], got[""][1], rtol=1e-6, atol=1e-6, err_msg=route)


def test_config_api_plumbs_sp_weight():
    """tests/test_weighted_lookup.py:297: `embedding_lookup(sp_weight_name=)`
    reaches the plan: the lookup config, its group's `has_weights`, the
    lookup meta, and a split's merge."""
    t = tplan.EmbeddingTableConfig("t0", 50, E)
    cfg = thugectr.EmbeddingCollectionConfig()
    cfg.embedding_lookup([t, t], ["f0", "f1"], "emb", "sum", sp_weight_name=["w0", ""])
    lks = cfg.build_lookup_configs()
    assert [lk.sp_weight_name for lk in lks] == ["w0", ""]
    (g,) = tplan.compile_plan(lks, cfg.sharding_plan(), 1).groups
    assert g.has_weights and g.lookups[0].sp_weight_name == "w0" and not g.lookups[1].sp_weight_name
    big = tplan.EmbeddingTableConfig("big", 400, E)
    pl = tplan.compile_plan([tplan.LookupConfig(0, big, "f", "e", TComb.Mean, 3, sp_weight_name="w")],
                            tplan.ShardingPlan([]), 1, hot_rows=16, superhot_rows=8, onehot_vocab=8)
    (m,) = pl.merges
    assert m.sp_weight_name == "w" and all(g.has_weights for g in pl.groups)


def _model_pair(rm_jax, b=8):
    """The JAX package's tests/test_weighted_lookup.py:317 model and the
    port's, t0's rows carried from JAX's."""
    import hugectr_tpu as jh
    from hugectr_tpu.core.types import DataReaderType_t as JDRT

    models = []
    # the port's Solver field of the JAX package's HCTR_TPU_ONEHOT_VOCAB=0 (tests/conftest.py)
    for h, rm, kw in ((jh, rm_jax, {}), (thugectr, CPU, {"onehot_vocab": 0})):
        solver = h.CreateSolver(max_eval_batches=1, batchsize_eval=b, batchsize=b, lr=0.01, **kw)
        drt = JDRT.Synthetic if h is jh else h.DataReaderType_t.Synthetic
        reader = h.DataReaderParams(data_reader_type=drt, synthetic_num_batches=2)
        model = h.Model(solver, reader, h.CreateOptimizer(optimizer_type=h.Optimizer_t.SGD), resource_manager=rm)
        model.add(h.Input(label_dim=1, label_name="label", dense_dim=2, dense_name="dense",
                          data_reader_sparse_param_array=[h.DataReaderSparseParam("d0", 3, True, 1)]))
        t = h.EmbeddingTableConfig(name="t0", max_vocabulary_size=40, ev_size=E)
        ebc = h.EmbeddingCollectionConfig()
        ebc.embedding_lookup([t], ["d0"], "emb", ["sum"], sp_weight_name=["w0"])
        ebc.shard(shard_matrix=[["t0"]], shard_strategy=[("mp", ["t0"])])
        model.add(ebc)
        model.add(h.DenseLayer(layer_type=h.Layer_t.Concat, bottom_names=["emb", "dense"], top_names=["c"]))
        model.add(h.DenseLayer(layer_type=h.Layer_t.InnerProduct, bottom_names=["c"], top_names=["out"],
                               num_output=1))
        model.add(h.DenseLayer(layer_type=h.Layer_t.BinaryCrossEntropyLoss, bottom_names=["out", "label"],
                               top_names=["loss"]))
        model.compile()
        models.append(model)
    jm, tm = models
    tm.ec.import_table(tm.tables, "t0", jm.ec.export_table(jm.state["emb_tables"], "t0"))
    return jm, tm


def test_model_level_weighted_lookup(mesh1):
    """tests/test_weighted_lookup.py:317: the Model takes a lookup's weights
    from the batch feature its `sp_weight_name` names: `check_out_tensor`
    of the weighted top equals JAX's and sum_h w x row; a batch without the
    feature raises KeyError naming it, in both packages."""
    jm, tm = _model_pair(mesh1)
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 40, (8, 3)).astype(np.int32)
    w = rng.normal(size=(8, 3)).astype(np.float32)
    batch = {"label": np.zeros((8, 1), np.float32), "dense": np.zeros((8, 2), np.float32), "d0": keys, "w0": w}
    got = np.asarray(tm.check_out_tensor("emb", dict(batch)))
    np.testing.assert_allclose(got, np.asarray(jm.check_out_tensor("emb", dict(batch))), **FWD_TOL)
    tab = tm.ec.export_table(tm.tables, "t0")
    np.testing.assert_allclose(got, (tab[keys] * w[..., None]).sum(1), rtol=1e-5, atol=1e-5)
    bad = {k: v for k, v in batch.items() if k != "w0"}
    for m in (jm, tm):
        with pytest.raises(KeyError, match="w0"):
            m.check_out_tensor("emb", dict(bad))


def test_model_weighted_train_step_matches_jax(mesh1):
    """The Model's weighted training step (`train_step` hands the batch's
    weights to the forward and to the backward): from the same state, one
    step on one batch gives JAX's loss, table and dense weights."""
    import jax.random as jr

    from hugectr_tpu_torch.tools import carry

    jm, tm = _model_pair(mesh1)
    carry.load_jax_state(tm, jax.device_get(jm.state))
    rng = np.random.default_rng(4)
    batch = {"label": rng.integers(0, 2, (8, 1)).astype(np.float32),
             "dense": rng.normal(size=(8, 2)).astype(np.float32),
             "d0": rng.integers(0, 40, (8, 3)).astype(np.int32), "w0": rng.normal(size=(8, 3)).astype(np.float32)}
    jm.start_data_reading()
    jm._rng, sub = jr.split(jm._rng)
    jm.state, jloss = jm._train_step(jm.state, jm._put_batch(dict(batch)), sub)
    tloss = tm.train_step(tm._put_now(dict(batch)))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tm.ec.export_table(tm.tables, "t0"), jm.ec.export_table(jm.state["emb_tables"], "t0"),
                               **TOL)
    tm._close_readers()


def _split_lookups(pkg, comb):
    t0 = pkg.EmbeddingTableConfig("t0", 100, E)
    return [pkg.LookupConfig(0, t0, "f0", "e0", comb.Sum, 4, sp_weight_name="w0"),
            pkg.LookupConfig(1, t0, "f1", "e1", comb.Mean, 3, sp_weight_name="w1")]


@pytest.mark.parametrize("superhot", [0, 8])
def test_weighted_split_matches_jax(monkeypatch, superhot):
    """tests/test_weighted_lookup.py:410: weighted Sum and Mean lookups of a
    split table (hot 16, with and without a superhot tier of 8 rows in the
    one-hot group, which takes its keys' weights in the kernel): the merge
    sums the tiers and a Mean divides by the raw sum of weights; forward,
    one SGD step, forward."""
    p = Pair(monkeypatch, _split_lookups, [("mp", ["t0"])], "sorted", "sgd",
             split=dict(hot_rows=16, superhot_rows=superhot, onehot_vocab=8 if superhot else 0))
    assert p.tplan.merges and all(m.sp_weight_name for m in p.tplan.merges)
    assert any(g.compute_kind == "onehot" for g in p.tplan.groups) == bool(superhot)
    rng = np.random.default_rng(11)
    feats = {"f0": _keys(rng, 32, 4, 100), "f1": _keys(rng, 32, 3, 100)}
    weights = {"w0": rng.normal(size=(32, 4)).astype(np.float32),
               "w1": (rng.random((32, 3)) + 0.1).astype(np.float32)}
    weights["w1"][0] = 0.0
    d = {"e0": rng.normal(size=(32, E)).astype(np.float32), "e1": rng.normal(size=(32, E)).astype(np.float32)}
    p.forward(feats, weights)
    p.step(feats, weights, d)
    p.forward(feats, weights)


def test_weighted_onehot_cross_sample_weight_cancel():
    """tests/test_weighted_lookup.py:493: weights +1 and -1 on one key in two
    samples: the row's gradient is d0 - d1 and it is updated, although its
    weights sum to 0 (the touch counts sum |w|)."""
    t0 = tplan.EmbeddingTableConfig("t0", 16, 4)
    pl = tplan.compile_plan([tplan.LookupConfig(0, t0, "f0", "e0", TComb.Sum, 1, sp_weight_name="w0")],
                            tplan.ShardingPlan([("dp", ["t0"])]), 1, onehot_vocab=64)
    assert pl.groups[0].compute_kind == "onehot"
    ec = TEC(pl, CPU, TOptParams(TOpt.SGD, lr=1.0))
    tables = ec.init(CPU.generator(0))
    state = ec.init_optimizer(tables)
    before = ec.export_table(tables, "t0")
    feats = {"f0": torch.tensor([[5], [5]], dtype=torch.int32)}
    weights = {"w0": torch.tensor([[1.0], [-1.0]])}
    d = {"e0": torch.tensor([[1.0, 0, 0, 0], [0, 0, 0, 0]])}
    ec.backward_and_update(tables, state, feats, d, torch.tensor(1.0), 1, weights)
    after = ec.export_table(tables, "t0")
    np.testing.assert_allclose(after[5], before[5] - np.array([1, 0, 0, 0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.delete(after, 5, 0), np.delete(before, 5, 0))
    # the touch count of row 5 is |1| + |-1|
    k = torch.tensor([[5], [5]], dtype=torch.int32)
    _g, cnt = oh.onehot_matmul_bwd(k, d["e0"], 16, torch.float32, weights=weights["w0"])
    assert float(cnt[5]) == 2.0 and float(cnt.sum()) == 2.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_onehot_plain_matches_jax_counts(mesh1, monkeypatch, dtype):
    """The one-hot kernels' plain versions with weights against the JAX
    package's XLA counts path (`_onehot_fwd`, `_onehot_grad` with
    weights): the pooled forward, the gradient and the touched rows. bf16:
    JAX rounds to bf16 up to six times on the way (each weight, the sum of a
    sample's duplicate keys' weights in its counts, a Mean's sum of weights
    and the quotient, the product's output) at 2^-9 each, the port once at
    the output, so the bf16 forward is held within 2^-6 of the sum of |w x
    row| (divided by |sum of w| for a Mean) per output, and the gradient
    within 2^-6 of the sum of |w x d| per row (measured: 0.0098 and 0.0081
    of them)."""
    monkeypatch.setenv("HCTR_TPU_ONEHOT_VOCAB", "128")
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    lks = _split_lookups(jplan, JComb)
    jpl = jplan.compile_plan(lks, jplan.ShardingPlan([("dp", ["t0"])]), 1)
    jec = JEC(jpl, mesh1, JOptParams(JOpt.SGD, lr=0.1), dtype=jdt)
    g = jpl.groups[0]
    assert g.compute_kind == "onehot"
    tpl = tplan.compile_plan(_split_lookups(tplan, TComb), tplan.ShardingPlan([("dp", ["t0"])]), 1, onehot_vocab=128)
    tec = TEC(tpl, CPU, TOptParams(TOpt.SGD, lr=0.1), dtype=tdt)
    rng = np.random.default_rng(21)
    table = rng.normal(size=(100, E)).astype(np.float32)
    feats = {"f0": _keys(rng, 64, 4, 100), "f1": _keys(rng, 64, 3, 100)}
    feats["f0"][3] = [7, 7, 7, -1]  # duplicate keys in one sample
    w = {"w0": rng.normal(size=(64, 4)).astype(np.float32), "w1": (rng.random((64, 3)) + 0.1).astype(np.float32)}
    w["w1"][2] = 0.0
    d = rng.normal(size=(64, 2 * E)).astype(np.float32)
    keys = np.concatenate([feats["f0"], feats["f1"]], axis=1)
    wg = np.concatenate([w["w0"], w["w1"]], axis=1) * (keys != INVALID_KEY)
    jtab = jnp.asarray(table, jdt)
    jout = np.asarray(jec._onehot_fwd(g.name, jtab, jnp.asarray(keys), weights=jnp.asarray(wg)).astype(jnp.float32))
    jgrad, jcol = jec._onehot_grad(g.name, jdt, jnp.asarray(keys), jnp.asarray(d, jdt), weights=jnp.asarray(wg))
    ttab = torch.from_numpy(table).to(tdt)
    tout = tec._onehot_fwd(g.name, ttab, [torch.from_numpy(feats["f0"]), torch.from_numpy(feats["f1"])],
                           [torch.from_numpy(w["w0"]), torch.from_numpy(w["w1"])]).float().numpy()
    tgrad, tcol = tec._onehot_grad(g.name, tdt, torch.from_numpy(keys), torch.from_numpy(d).to(tdt),
                                   torch.from_numpy(wg))
    np.testing.assert_array_equal(tcol.numpy() > 0, np.asarray(jcol) > 0)
    if dtype == "float32":
        np.testing.assert_allclose(tout, jout, **FWD_TOL)
        np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-5)
        return
    tabs = np.abs(table.astype(np.float32))
    scale = np.concatenate([(np.abs(np.where(keys[:, :4, None] >= 0, tabs[np.maximum(keys[:, :4], 0)], 0)
                                    * wg[:, :4, None])).sum(1),
                            (np.abs(np.where(keys[:, 4:, None] >= 0, tabs[np.maximum(keys[:, 4:], 0)], 0)
                                    * wg[:, 4:, None])).sum(1)], axis=1)
    den1 = np.where(wg[:, 4:].sum(1, keepdims=True) == 0, 1.0, wg[:, 4:].sum(1, keepdims=True))
    scale[:, E:] /= np.abs(den1)
    assert (np.abs(tout - jout) <= 2.0**-6 * scale + 1e-6).all()
    gscale = np.asarray(jec._onehot_grad(g.name, jnp.float32, jnp.asarray(keys), jnp.abs(jnp.asarray(d)),
                                         weights=jnp.abs(jnp.asarray(wg)))[0])
    assert (np.abs(tgrad.numpy() - np.asarray(jgrad.astype(jnp.float32))) <= 2.0**-6 * gscale + 1e-6).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_ordered_pool_plain_matches_jax(dtype):
    """The ordered pool's plain version with weights against the JAX
    package's pool of the owner-partitioned forward (collection.py:881-902):
    (row, slot, w) sorted by row, stable, then rows x w in the table's type
    scatter-added in that type. Bitwise, with duplicate rows in a slot
    whose weights differ and keys of another shard."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(5)
    b, h, rows, e = 64, 6, 40, 8
    idx = rng.integers(0, rows + 8, size=(b, h))
    idx[idx >= rows] = rows  # another shard's keys: the sentinel
    idx[:, 1] = idx[:, 0]  # repeated rows in a slot
    w = rng.normal(size=(b, h)).astype(np.float32)
    table = (rng.normal(size=(rows, e)) * np.exp2(rng.integers(-6, 3, size=(rows, 1)))).astype(np.float32)
    src = np.repeat(np.arange(b), h)  # one Sum slot a sample
    sidx, ssrc, sw = jax.lax.sort((jnp.asarray(idx.reshape(-1), jnp.int32), jnp.asarray(src, jnp.int32),
                                   jnp.asarray(w.reshape(-1))), num_keys=1)
    jt = jnp.asarray(table, jdt)
    got_rows = jt.at[sidx].get(mode="fill", fill_value=0) * sw[:, None].astype(jdt)
    want = np.asarray(jnp.zeros((b, e), jdt).at[ssrc].add(got_rows).astype(jnp.float32))
    r, offsets, ws = op.segments(torch.from_numpy(idx.reshape(-1)), torch.from_numpy(src), b, rows,
                                 torch.from_numpy(w.reshape(-1)))
    got = op.ordered_pool(torch.from_numpy(table).to(tdt), r, offsets, ws).float().numpy()
    np.testing.assert_array_equal(got, want)
