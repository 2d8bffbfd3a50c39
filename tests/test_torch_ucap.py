"""The measured unique-row caps (HCTR_TPU_UCAP_FACTOR=auto, the port's
`unique_cap_factor="auto"`) and the unique-row windows against the JAX
package on the CPU, each case run in both packages in the test.

- The tiny bench-configured DLRM-DCNv2 with bench.py's settings (auto,
  headroom 1.05): the caps of every group equal JAX's exactly; every
  group's update route is the one JAX's rule picks (`_opt_knobs` and
  `apply_sparse`'s dense/sorted test, collection.py:1962-1994,
  sparse_optimizer.py:428-447); the compact forward of each group with a
  valid cap equals JAX's bitwise (bf16: the same adds in the same order).
  The three steps from carried state are tests/test_torch_bench.py's
  "auto" case.
- The weighted bench's tiered collection (tools/weighted.py) scaled down,
  with its caps: the caps and routes equal JAX's, the compact forward of
  both rowop tiers (weights rounded to bf16, bf16 products added in XLA's
  order) bitwise, one update of those tiers bitwise.
- A batch that overflows the windows measured on an earlier batch: the
  update equals the port's with the windows off bitwise, and JAX's (which
  takes its exact fallback) within float32 rtol 1e-5 / atol 1e-6 (segment
  sums in another order); the forward within the same.
- The drop mode (factor 0.5): the update equals JAX's dropped one within
  float32 rtol 1e-5 / atol 1e-6, and a row past the window keeps its value
  bitwise in both packages.
- Over W = 2 gloo ranks: an all-Concat group opens the dense exchange from
  the measured caps, which equal the JAX collection's on its 2-device mesh,
  and its all_to_all moves the bytes of JAX's exchange shapes; the tiny
  bench model measures, on its two ranks, the caps of the JAX Model on a
  2-device mesh for the same global batch.
"""
import json

import jax
import jax.numpy as jnp
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
from hugectr_tpu.tools import flagship as jflagship
from hugectr_tpu_torch import ops
from hugectr_tpu_torch.benchmarks import dense_exchange_bytes as dxb
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Combiner_t as TComb
from hugectr_tpu_torch.core.types import Optimizer_t as TOpt
from hugectr_tpu_torch.embedding.collection import EmbeddingCollection as TEC
from hugectr_tpu_torch.optim.params import OptParams as TOptParams
from hugectr_tpu_torch.parallel import plan as tplan
from hugectr_tpu_torch.tools import flagship as tflagship
from hugectr_tpu_torch.tools import hybrid
from hugectr_tpu_torch.tools.carry import load_jax_state

import torch_rank_fns as fns
from test_embedding_collection import random_keys
from test_torch_bench import JAX_ENV as BENCH_ENV
from test_torch_bench import SPLIT as BENCH_SPLIT
from test_torch_bench import TINY as BENCH_TINY

torch.set_num_threads(1)
CPU = ResourceManager.create(device="cpu")
AUTO_ENV = dict(BENCH_ENV, HCTR_TPU_UCAP_FACTOR="auto", HCTR_TPU_UCAP_HEADROOM="1.05")
CAPS = ("unique_caps", "valid_caps", "dense_exchange_caps")
F32_TOL = dict(rtol=1e-5, atol=1e-6)


def _caps(ec) -> list:
    return [dict(getattr(ec, c)) for c in CAPS]


def jax_route(jec, g, k: int) -> str:
    """The route the JAX package's update takes for group `g` with a k-key
    list: its `_opt_knobs` and `apply_sparse`'s test (sparse_optimizer.py:
    428-447)."""
    if g.compute_kind == "onehot":
        return "onehot"
    kn = jec._opt_knobs(g.name)
    rows = g.total_storage_rows
    vcap = kn["valid_cap"]
    k_eff = vcap if 0 < vcap < k else k
    ratio = kn["dense_ratio"]
    kind = jec.group_opt[g.name].optimizer
    if kind == JOpt.SGD:
        return "scatter"
    ratio_dense = ratio > 0 and rows > 0 and k_eff >= rows * ratio and kind in (JOpt.AdaGrad, JOpt.RowWiseAdaGrad)
    dense = not kn["packed"] and ((0 < rows <= kn["dense_rows"]) or ratio_dense)
    return "dense" if dense else "sorted"


def test_tiny_bench_caps_routes_and_compact_forward_match_jax(monkeypatch):
    """bench.py's caps on the tiny bench model: the caps, the routes and the
    compact forward, from the same state on the same first batch."""
    for k, v in AUTO_ENV.items():
        monkeypatch.setenv(k, v)
    reader = jh.DataReaderParams(data_reader_type="synthetic", synthetic_num_batches=3, synthetic_alpha=1.05,
                                 synthetic_learnable=True)
    jm = jflagship.build_dlrm_dcnv2(JaxResourceManager.create(num_devices=1), reader=reader, **BENCH_TINY)
    kw = dict(tflagship.bench_settings(), **BENCH_TINY, **BENCH_SPLIT)
    tm = tflagship.build_dlrm_dcnv2(CPU, onehot_vocab=64, synthetic_learnable=True, **kw)
    assert tm.ec.ucap_auto and (tm.ec.ucap_headroom, jm.ec.knob_ucap_headroom) == (1.05, 1.05)
    state0 = jax.tree_util.tree_map(lambda x: np.array(x, copy=True), jax.device_get(jm.state))
    load_jax_state(tm, state0)
    seen = {}
    step = tm.train_step

    def recording(batch):
        seen.setdefault("keys", {k: v.clone() for k, v in tm._feature_keys(tm._decode_batch(batch)).items()})
        return step(batch)

    tm.train_step = recording
    assert not tm.ec.ucap_measured
    jm.train(), tm.train()
    assert tm.ec.ucap_measured and jm.ec.ucap_measured
    assert _caps(tm.ec) == _caps(jm.ec)
    assert tm.ec.valid_caps == {"mp_ev16": 6656, "mp_ev16_19::cold": 512, "mp_ev16_20::cold": 2048,
                                "mp_ev16_21::cold": 512}
    assert len(tm.ec.unique_caps) == 19 and not tm.ec.dense_exchange_caps
    keys = seen["keys"]
    routes = {}
    for g in jm.ec.plan.groups:
        k = sum(keys[lm.bottom_name].shape[0] * lm.hotness for lm in g.lookups)
        routes[g.name] = jax_route(jm.ec, g, k)
    assert tm.ec.group_routes == routes
    # the measured keys moved two groups to the dense sweep
    assert routes["mp_ev16"] == routes["mp_ev16_20::cold"] == "dense"
    # the compact forward, from the step-0 state on the first batch, bitwise
    jt = {k: jnp.asarray(v) for k, v in state0["emb_tables"].items()}
    load_jax_state(tm, state0)
    jkeys = {k: jnp.asarray(v.numpy()) for k, v in keys.items()}
    ops.reset_counts()
    for gname in jm.ec.valid_caps:
        g = next(g for g in jm.ec.plan.groups if g.name == gname)
        want = jm.ec._dp_fwd(gname, jt[gname], jm.ec._group_keys(g, jkeys), None, feature_keys=jkeys)
        got = tm.ec._mp_fwd_partitioned(gname, tm.tables[gname], tm.ec._group_keys(g, keys), cut=False)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32), err_msg=gname)
    assert ops.plain_counts()["ordered_pool"] == len(jm.ec.valid_caps)


# tools/weighted.py's collection scaled down: one weighted Sum lookup of
# hotness 20 over a 20,000-row table, ev 16, batch 256, bf16, rowwise
# AdaGrad at lr 0.01, power-law keys; tiers a sixty-fourth of the bench's
# (hot 2,048 / split vocab 1,024 / superhot 64, which joins a one-hot group
# of at most 128 rows), the hot tier's 1,984 rows on the dense sweep
# (dense_update_rows 4,096) and the cold tier on the sorted route
W_VOCAB, W_BATCH, W_EV = 20000, 256, 16
W_TIERS = dict(hot_rows=2048, split_vocab=1024, superhot_rows=64)
W_ENGINE = dict(onehot_vocab=128, dense_update_rows=4096, dense_key_ratio=0.3)
BF16_TOL = dict(rtol=2.0**-7, atol=2.0**-8)  # one bf16 ulp at the tables' scale


def test_weighted_tiered_caps_and_compact_forward_match_jax(monkeypatch):
    """The weighted bench's tiered collection with its caps (auto, headroom
    1.05, weighted_bench.py:12-13, :69) on its batch: the caps and routes
    equal JAX's; the compact forward of each group with a valid cap (both
    tiers: the weights rounded to bf16 and multiplied in bf16, the rows
    added in bf16 in XLA's order, equal rows in slot order) equals JAX's
    `_dp_fwd_compact` bitwise, the whole forward within one bf16 ulp (the
    one-hot tier's sums); one update from the same tables: the rowop tiers
    bitwise, the one-hot tier within one bf16 ulp."""
    from hugectr_tpu_torch.tools import weighted as wt

    for k, v in {"HCTR_TPU_UCAP_FACTOR": "auto", "HCTR_TPU_UCAP_HEADROOM": "1.05", "HCTR_TPU_SEGSUM": "xla",
                 "HCTR_TPU_ONEHOT_KERNEL": "xla", "HCTR_TPU_HOT_ROWS": "2048", "HCTR_TPU_SPLIT_VOCAB": "1024",
                 "HCTR_TPU_SUPERHOT_ROWS": "64", "HCTR_TPU_ONEHOT_VOCAB": "128",
                 "HCTR_TPU_DENSE_UPDATE_ROWS": "4096", "HCTR_TPU_DENSE_KEY_RATIO": "0.3"}.items():
        monkeypatch.setenv(k, v)

    def lookups(pkg, comb):
        t = pkg.EmbeddingTableConfig(name="t", max_vocabulary_size=W_VOCAB, ev_size=W_EV)
        return [pkg.LookupConfig(0, t, "f", "e", comb.Sum, wt.HOT, sp_weight_name="w")]

    strategy = [("mp", ["t"])]
    jec = JEC(jplan.compile_plan(lookups(jplan, JComb), jplan.ShardingPlan(strategy=strategy), 1),
              JaxResourceManager.create(num_devices=1), JOptParams(JOpt.RowWiseAdaGrad, lr=0.01),
              dtype=jnp.bfloat16)
    tplan_ = tplan.compile_plan(lookups(tplan, TComb), tplan.ShardingPlan(strategy=strategy), 1,
                                onehot_vocab=W_ENGINE["onehot_vocab"], **W_TIERS)
    tec = TEC(tplan_, CPU, TOptParams(TOpt.RowWiseAdaGrad, lr=0.01), dtype=torch.bfloat16,
              dense_update_rows=W_ENGINE["dense_update_rows"], dense_key_ratio=W_ENGINE["dense_key_ratio"],
              **wt.BENCH_UCAP)
    assert [(g.name, g.compute_kind) for g in tplan_.groups] == [(g.name, g.compute_kind) for g in jec.plan.groups]
    assert [g.compute_kind for g in tplan_.groups] == ["onehot", "rowop", "rowop"]
    keys, w, d = wt.weighted_batch(0, batch=W_BATCH, vocab=W_VOCAB, ev=W_EV)
    jec.auto_unique_caps({"f": keys})
    tec.auto_unique_caps({"f": torch.from_numpy(keys)})
    assert _caps(tec) == _caps(jec)
    assert sorted(tec.valid_caps) == ["mp_ev16_t::cold", "mp_ev16_t::hot"]
    assert max(tec.valid_caps.values()) < W_BATCH * wt.HOT
    jt = jec.init(jax.random.key(0))
    tt = tec.init(CPU.generator(0))
    tec.import_table(tt, "t", np.asarray(jec.export_table(jt, "t")).astype(np.float32))
    for g in jec.plan.groups:
        np.testing.assert_array_equal(tt[g.name].float().numpy(), np.asarray(jt[g.name]).astype(np.float32))
    jf, jw = {"f": jnp.asarray(keys)}, {"w": jnp.asarray(w)}
    tf, tw = {"f": torch.from_numpy(keys)}, {"w": torch.from_numpy(w)}
    ops.reset_counts()
    for gname in jec.valid_caps:
        g = next(g for g in jec.plan.groups if g.name == gname)
        jk = jec._group_keys(g, jf)
        want = jec._dp_fwd(gname, jt[gname], jk, None, feature_keys=jf, weights=jec._group_weights(g, jw))
        tk = tec._group_keys(g, tf)
        got = tec._mp_fwd_partitioned(gname, tt[gname], tk, weights=tec._group_weights(g, tw, tk), cut=False)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32), err_msg=gname)
    assert ops.plain_counts()["ordered_pool"] == 2
    # the whole forward: the superhot tier's one-hot pool sums its products
    # in float32 in another order than JAX's counts matmul, so it and the
    # tiers' bf16 sum stand one bf16 ulp apart at the output's scale
    want = np.asarray(jax.jit(jec.forward)(jt, jf, jw)["e"]).astype(np.float32)
    got = tec.forward(tt, tf, tw)["e"].float().numpy()
    np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=2.0**-7 * float(np.abs(want).max()))
    jt, js = jax.jit(jec.backward_and_update)(jt, jec.init_optimizer(jt), jf, {"e": jnp.asarray(d)},
                                              jnp.asarray(0.01), jnp.asarray(1), jw)
    ts = tec.init_optimizer(tt)
    tec.backward_and_update(tt, ts, tf, {"e": torch.from_numpy(d)}, torch.tensor(0.01), 1, tw)
    routes = {g.name: jax_route(jec, g, W_BATCH * wt.HOT) for g in jec.plan.groups}
    assert tec.group_routes == routes == {"onehot_ev16": "onehot", "mp_ev16_t::hot": "dense",
                                          "mp_ev16_t::cold": "sorted"}
    # the rowop tiers' updates bitwise; the one-hot tier's within one bf16 ulp
    for g in jec.plan.groups:
        got, want = tt[g.name].float().numpy(), np.asarray(jt[g.name]).astype(np.float32)
        if g.compute_kind == "onehot":
            np.testing.assert_allclose(got, want, **BF16_TOL, err_msg=g.name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=g.name)


def _collection_pair(mesh1, monkeypatch, jenv: dict, port: dict, opt=(JOpt.AdaGrad, TOpt.AdaGrad)):
    """JAX's and the port's float32 collection of three model-parallel
    tables (Sum, Mean and Concat lookups) on the sorted route, the
    unique-cap settings `jenv` / `port`, from the same tables."""
    for k, v in dict({"HCTR_TPU_DENSE_UPDATE_ROWS": "0", "HCTR_TPU_ONEHOT_VOCAB": "0", "HCTR_TPU_SEGSUM": "xla",
                      "HCTR_TPU_DENSE_KEY_RATIO": "0", "HCTR_TPU_UCAP_FACTOR": "0"}, **jenv).items():
        monkeypatch.setenv(k, v)

    def lookups(pkg, comb):
        ts = [pkg.EmbeddingTableConfig(name=f"t{i}", max_vocabulary_size=v, ev_size=8)
              for i, v in enumerate((3000, 2000, 500))]
        return [pkg.LookupConfig(0, ts[0], "f0", "e0", comb.Sum, 8),
                pkg.LookupConfig(1, ts[1], "f1", "e1", comb.Mean, 4),
                pkg.LookupConfig(2, ts[2], "f2", "e2", comb.Concat, 2)]

    strategy = [("mp", ["t0", "t1", "t2"])]
    jec = JEC(jplan.compile_plan(lookups(jplan, JComb), jplan.ShardingPlan(strategy=strategy), 1), mesh1,
              JOptParams(opt[0], lr=0.3, initial_accu_value=0.0, epsilon=1e-7))
    tec = TEC(tplan.compile_plan(lookups(tplan, TComb), tplan.ShardingPlan(strategy=strategy), 1, onehot_vocab=0),
              CPU, TOptParams(opt[1], lr=0.3, initial_accu_value=0.0, epsilon=1e-7), dense_update_rows=0,
              dense_key_ratio=0.0, **port)
    rng = np.random.default_rng(5)
    values = {f"t{i}": (rng.normal(size=(v, 8)) * 0.5).astype(np.float32) for i, v in enumerate((3000, 2000, 500))}
    jt, tt = jec.init(jax.random.key(0)), tec.init(CPU.generator(0))
    for n, v in values.items():
        jt = jec.import_table(jt, n, v)
        tec.import_table(tt, n, v)
    return jec, jt, jec.init_optimizer(jt), tec, tt, tec.init_optimizer(tt)


def _batch(rng, b: int, vocab: tuple, pad: float):
    feats = {f"f{i}": random_keys(rng, b, h, v, pad_prob=pad) for i, (h, v) in enumerate(zip((8, 4, 2), vocab))}
    d = {f"e{i}": rng.normal(size=(b, w)).astype(np.float32) for i, w in enumerate((8, 8, 16))}
    return feats, d


def _step(jec, jt, js, tec, tt, ts, feats, d, step=1):
    """One forward and update in both packages; (JAX forward, port forward,
    JAX tables and state)."""
    jout = jax.jit(jec.forward)(jt, feats)
    tf = {k: torch.from_numpy(v) for k, v in feats.items()}
    tout = tec.forward(tt, tf)
    jt, js = jax.jit(jec.backward_and_update)(jt, js, feats, {k: jnp.asarray(v) for k, v in d.items()},
                                              jnp.asarray(0.3), jnp.asarray(step))
    tec.backward_and_update(tt, ts, tf, {k: torch.from_numpy(v) for k, v in d.items()}, torch.tensor(0.3), step)
    return jout, tout, jt, js


def test_batch_overflowing_the_windows_equals_windows_off(mesh1, monkeypatch):
    """Caps measured on a sparse batch (30 % valid keys from 8 rows), then
    a batch past every window (all keys valid, hundreds of distinct rows):
    the update equals the port's with the windows off bitwise and JAX's
    (its exact fallback) within float32 tolerances."""
    rng = np.random.default_rng(11)
    small, _ = _batch(rng, 128, (8, 8, 8), pad=0.7)
    big, d = _batch(rng, 128, (3000, 2000, 500), pad=0.0)
    jec, jt, js, tec, tt, ts = _collection_pair(mesh1, monkeypatch, {"HCTR_TPU_UCAP_FACTOR": "auto"},
                                                dict(unique_cap_factor="auto"))
    jec.auto_unique_caps(small)
    tec.auto_unique_caps(small)
    assert _caps(tec) == _caps(jec) and tec.valid_caps and tec.unique_caps
    g = tec.plan.groups[0]
    assert sum((big[f"f{i}"] >= 0).sum() for i in range(3)) > tec.valid_caps[g.name]
    assert len(np.unique(big["f0"])) > tec.unique_caps[g.name]
    _c, _j, _js, off, ott, ots = _collection_pair(mesh1, monkeypatch, {}, {})
    jout, tout, jt, js = _step(jec, jt, js, tec, tt, ts, big, d)
    ops.reset_counts()
    oout = off.forward(ott, {k: torch.from_numpy(v) for k, v in big.items()})
    off.backward_and_update(ott, ots, {k: torch.from_numpy(v) for k, v in big.items()},
                            {k: torch.from_numpy(v) for k, v in d.items()}, torch.tensor(0.3), 1)
    assert ops.plain_counts()["ordered_pool"] == 0 and tec.group_routes == off.group_routes == {g.name: "sorted"}
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), **F32_TOL, err_msg=k)
        np.testing.assert_allclose(tout[k].numpy(), oout[k].numpy(), **F32_TOL, err_msg=k)
    assert torch.equal(tt[g.name], ott[g.name]) and torch.equal(ts[g.name]["accum"], ots[g.name]["accum"])
    np.testing.assert_allclose(tt[g.name].numpy(), np.asarray(jt[g.name]), **F32_TOL)
    np.testing.assert_allclose(ts[g.name]["accum"].numpy(), np.asarray(js[g.name]["accum"]), **F32_TOL)


@pytest.mark.parametrize("opt", ["adagrad", "rowwise_adagrad"])
def test_ucap_drop_matches_jax(mesh1, monkeypatch, opt):
    """HCTR_TPU_UCAP_FACTOR=0.5 with HCTR_TPU_UCAP_DROP: the update keeps
    the first ceil512(K / 2) sorted unique rows; the rows past them lose
    their gradients in both packages."""
    pair = dict(adagrad=(JOpt.AdaGrad, TOpt.AdaGrad), rowwise_adagrad=(JOpt.RowWiseAdaGrad, TOpt.RowWiseAdaGrad))
    jec, jt, js, tec, tt, ts = _collection_pair(
        mesh1, monkeypatch, {"HCTR_TPU_UCAP_FACTOR": "0.5", "HCTR_TPU_UCAP_DROP": "1"},
        dict(unique_cap_factor=0.5, ucap_drop=True), opt=pair[opt])
    assert jec.knob_ucap_drop and tec.ucap_drop and tec.ucap_factor == jec.knob_ucap_factor == 0.5
    rng = np.random.default_rng(12)
    feats, d = _batch(rng, 256, (3000, 2000, 500), pad=0.1)
    g = tec.plan.groups[0]
    before = tt[g.name].clone()
    jout, tout, jt, js = _step(jec, jt, js, tec, tt, ts, feats, d)
    # the group's sorted unique rows and the window: K = B x H = 3,584 keys
    rows = set()
    for i, (h, off) in enumerate(zip((8, 4, 2), (int(x) for x in g.local_offsets))):
        k = feats[f"f{i}"]
        rows |= {off + int(x) for x in k[k >= 0]}
    rows = sorted(rows)
    ucap = min(256 * 14, ((int(256 * 14 * 0.5) + 511) // 512) * 512)
    assert len(rows) > ucap and tec.ucap_stats["ucap_dropped"] == len(rows) - ucap
    kept, lost = rows[:ucap], rows[ucap:]
    after = tt[g.name]
    assert torch.equal(after[lost], before[lost])
    np.testing.assert_array_equal(np.asarray(jt[g.name])[lost], before[lost].numpy())
    assert not torch.equal(after[kept], before[kept])
    np.testing.assert_allclose(after.numpy(), np.asarray(jt[g.name]), **F32_TOL)
    np.testing.assert_allclose(ts[g.name]["accum"].numpy(), np.asarray(js[g.name]["accum"]), **F32_TOL)


def test_measured_caps_over_two_ranks_match_jax(monkeypatch):
    """W = 2 gloo ranks. (1) One model-parallel Concat lookup with no
    explicit cap: every rank measures the cap of the whole batch, which
    opens the dense exchange; the cap is the JAX collection's on its
    2-device mesh, and the forward's and the update's all_to_all move the
    bytes of JAX's exchange shapes ([W, C, E] bf16 rows, [f C, E] float32
    sums, collection.py:1080-1086, :1148-1156). (2) The tiny bench model
    (bench.py's caps) from JAX's state: the caps its two ranks measure from
    their first batches are the JAX Model's on a 2-device mesh."""
    name, hot, vocab = dxb.CASES[2]
    keys = dxb.case_keys(np.random.default_rng(dxb.SEED), 64, hot, vocab)
    rec = dxb.run_case(name, hot, vocab, batch=64, world=2, keys=keys)
    monkeypatch.setenv("HCTR_TPU_UCAP_FACTOR", "auto")
    mesh2 = JaxResourceManager.create(num_devices=2)
    t = jplan.EmbeddingTableConfig(name="t", max_vocabulary_size=vocab, ev_size=dxb.EV)
    plan = jplan.compile_plan([jplan.LookupConfig(0, t, "f", "e", JComb.Concat, hot)],
                              jplan.ShardingPlan(strategy=[("mp", ["t"])]), num_shards=2)
    jec = JEC(plan, mesh2, JOptParams(JOpt.SGD, lr=0.1), dtype=jnp.bfloat16)
    jec.auto_unique_caps({"f": keys})
    (g,) = jec.plan.groups
    cap = jec.dense_exchange_caps[g.name]
    assert jec._dense_exchange_ok(g) and rec["cap"] == cap and rec["cap_measured"] and rec["gate_open"]
    assert rec["exchange_ran"] and rec["all_ranks_alike"] and rec["caps_alike"]
    a2a = {p: rec["collective_bytes_rank0"][p]["all_to_all"] for p in ("fwd", "bwd")}
    assert a2a == {"fwd": 2 * cap * dxb.EV * 2, "bwd": 2 * cap * dxb.EV * 4}

    for k, v in AUTO_ENV.items():
        monkeypatch.setenv(k, v)
    reader = jh.DataReaderParams(data_reader_type="synthetic", synthetic_num_batches=3, synthetic_alpha=1.05,
                                 synthetic_learnable=True)
    jm = jflagship.build_dlrm_dcnv2(JaxResourceManager.create(num_devices=2), reader=reader, **BENCH_TINY)
    s0 = jax.device_get(jm.state)
    state = {k: jax.tree_util.tree_map(lambda x: np.asarray(x).astype(np.float32)
                                       if np.asarray(x).dtype.name == "bfloat16" else np.asarray(x), s0[k])
             for k in ("emb_tables", "eopt", "dense_params", "dopt", "step")}
    jl = jm.train()
    kw = dict(tflagship.bench_settings(), **BENCH_TINY, **BENCH_SPLIT, onehot_vocab=64, synthetic_learnable=True,
              metrics_spec={"auc": 0.80275, "average_loss": 0.0})
    cfg = dict(builder="build_dlrm_dcnv2", kwargs=kw, steps=1, eval=False, export=False)
    res = hybrid.run(fns.several, 2, {"bench": {"config": json.dumps(cfg), "state": state},
                                      "calls": json.dumps({"bench": "train_model"})}, device="cpu")
    want = dict(unique=jm.ec.unique_caps, valid=jm.ec.valid_caps, dense_exchange=jm.ec.dense_exchange_caps)
    # (an empty dict does not come back from the ranks)
    assert want["valid"] and all({k: r["bench"]["caps"].get(k, {}) for k in want} == want for r in res)
    np.testing.assert_allclose(res[0]["bench"]["losses"][0], jl, rtol=1e-5)


@pytest.mark.parametrize("packed", [False, True])
def test_growth_keeps_the_caps_and_packed_rows(packed):
    """`grow_dynamic_capacity` (collection.py:2593-2604) carries the caps of
    the groups that remain and a packed group's whole rows (weights and
    accumulators); the port alone, as the JAX package's growth test does
    not pack."""
    lookups = [tplan.LookupConfig(0, tplan.EmbeddingTableConfig("st", 500, 8), "f0", "e0", TComb.Sum, 2),
               tplan.LookupConfig(1, tplan.EmbeddingTableConfig("dyn", -1, 8, dynamic_capacity=64), "f1", "e1",
                                  TComb.Sum, 2)]
    plan = tplan.compile_plan(lookups, tplan.ShardingPlan([("mp", ["st"]), ("mp", ["dyn"])]), 1, onehot_vocab=0,
                              split_vocab=100)
    ec = TEC(plan, CPU, TOptParams(TOpt.AdaGrad, lr=0.1), dense_update_rows=0, unique_cap_factor="auto",
             packed_state=packed)
    tables = ec.init(CPU.generator(0))
    state = ec.init_optimizer(tables)
    rng = np.random.default_rng(3)
    feats = {"f0": torch.from_numpy(random_keys(rng, 64, 2, 500)),
             "f1": torch.from_numpy(rng.integers(0, 10**6, size=(64, 2)).astype(np.int32))}
    ec.auto_unique_caps({k: v.numpy() for k, v in feats.items()})
    out = ec.forward(tables, feats)
    ec.backward_and_update(tables, state, feats, {k: torch.ones_like(v) for k, v in out.items()}, torch.tensor(0.1))
    (st,) = [g.name for g in plan.groups if not g.slot_is_dynamic.any()]
    assert ec.unique_caps and set(ec.unique_caps) == {st} and (st in ec.packed_groups) == packed
    new_ec, new_tables, _state = ec.grow_dynamic_capacity(tables, state, "dyn", 128)
    assert new_ec.measured_caps() == ec.measured_caps() and new_ec.ucap_measured
    # (the dynamic table's group takes another name at the new capacity)
    assert st in new_ec.packed_groups if packed else not new_ec.packed_groups
    assert len(new_ec.packed_groups) == len(ec.packed_groups)
    assert torch.equal(new_ec.export_rows(new_tables, "st", full=True), ec.export_rows(tables, "st", full=True))
