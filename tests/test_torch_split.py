"""The hot/cold/superhot split of the PyTorch port against the JAX package,
at small widths: the plan, the windowed one-hot forward and the split
collection's forward and update in float32 and in bfloat16.

Tolerances: plan fields are exact. float32: rtol 1e-4 / atol 1e-5 (sums in
another order, as tests/test_torch_modules.py). bfloat16 tables and state:
each value within one bfloat16 ulp (2^-7 relative, 2^-7 x 0.1 absolute at
the tables' scale of 0.1): both packages sum in float32 and round once to
bfloat16, in another order, so a result next to a rounding boundary may
land on the neighbouring value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugectr_tpu.core.types import Combiner_t as JComb
from hugectr_tpu.core.types import Optimizer_t as JOpt
from hugectr_tpu.embedding.collection import EmbeddingCollection as JEC
from hugectr_tpu.optim.params import OptParams as JOptParams
from hugectr_tpu.parallel import plan as jplan
from hugectr_tpu.tools.flagship import MLPERF_MULTI_HOT_SIZES, MLPERF_TABLE_SIZES

from hugectr_tpu_torch import ops
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Combiner_t as TComb
from hugectr_tpu_torch.core.types import Optimizer_t as TOpt
from hugectr_tpu_torch.embedding.collection import EmbeddingCollection as TEC
from hugectr_tpu_torch.ops import onehot_matmul as oh
from hugectr_tpu_torch.optim.params import OptParams as TOptParams
from hugectr_tpu_torch.parallel import plan as tplan

torch.set_num_threads(1)
CPU = ResourceManager.create(device="cpu")
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_ULP = 2.0**-7


def _env(monkeypatch, **kv):
    for k, v in kv.items():
        monkeypatch.setenv(k, str(v))


# ------------------------------------------------------------------ plan
def _flagship_lookups(pkg, comb, cap):
    return [
        pkg.LookupConfig(
            i, pkg.EmbeddingTableConfig(str(i), min(v, cap), 128),
            f"data{i}", f"sparse_embedding:{i}", comb.Sum, MLPERF_MULTI_HOT_SIZES[i],
        )
        for i, v in enumerate(MLPERF_TABLE_SIZES)
    ]


PLAN_CASES = {
    # bench.py's split of the flagship: 7 tables in 3 tiers, the superhot
    # tiers in the one-hot group (20 lookups)
    "bench": dict(cap=2_000_000, onehot=8192, split=16384, hot=131072, shot=1024, warm=0),
    # a warm tier, and a superhot size the one-hot threshold refuses
    "warm_no_shot": dict(cap=2_000_000, onehot=512, split=16384, hot=65536, shot=1024, warm=262144),
    # the split off: the plan is the unsplit one
    "off": dict(cap=2_000_000, onehot=8192, split=16384, hot=0, shot=1024, warm=0),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_split_plan_matches_jax(monkeypatch, case):
    c = PLAN_CASES[case]
    _env(monkeypatch, HCTR_TPU_ONEHOT_VOCAB=c["onehot"], HCTR_TPU_SPLIT_VOCAB=c["split"],
         HCTR_TPU_HOT_ROWS=c["hot"], HCTR_TPU_SUPERHOT_ROWS=c["shot"], HCTR_TPU_WARM_ROWS=c["warm"])
    names = [str(i) for i in range(26)]
    counts = {n: 1 for n in names}
    jp = jplan.compile_plan(_flagship_lookups(jplan, JComb, c["cap"]), jplan.ShardingPlan([("mp", names)]),
                            1, counts)
    tp = tplan.compile_plan(
        _flagship_lookups(tplan, TComb, c["cap"]), tplan.ShardingPlan([("mp", names)]), 1, counts,
        onehot_vocab=c["onehot"], split_vocab=c["split"], hot_rows=c["hot"], superhot_rows=c["shot"],
        warm_rows=c["warm"],
    )
    assert [g.name for g in tp.groups] == [g.name for g in jp.groups]
    for jg, tg in zip(jp.groups, tp.groups):
        assert (tg.compute_kind, tg.placement.value) == (jg.compute_kind, jg.placement.value)
        assert [(t.name, t.vocabulary_size) for t in tg.tables] == [
            (t.name, t.vocabulary_size) for t in jg.tables]
        for f in ("total_local_rows", "hotness_total", "out_width"):
            assert getattr(tg, f) == getattr(jg, f), f
        for f in ("table_vocab", "local_offsets", "slot_table", "slot_local_offset", "slot_vocab"):
            np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f), err_msg=f)
        for jl, tl in zip(jg.lookups, tg.lookups):
            for f in ("lookup_id", "table_index", "combiner", "slot_begin", "slot_end", "out_begin",
                      "out_end", "top_name", "bottom_name", "key_lo", "key_hi", "key_shift"):
                assert getattr(tl, f) == getattr(jl, f), f
    assert [(m.top_name, m.sub_tops, m.combiner.value, m.bottom_name) for m in tp.merges] == [
        (m.top_name, m.sub_tops, m.combiner.value, m.bottom_name) for m in jp.merges]
    assert tp.table_splits == jp.table_splits
    if case == "bench":
        onehot = tp.groups[0]
        assert onehot.compute_kind == "onehot" and len(onehot.lookups) == 20
        assert sum(lm.windowed for lm in onehot.lookups) == 7
        assert len(tp.table_splits) == 7


# -------------------------------------------------- windowed one-hot forward
def _window_lookups(pkg, comb, split: bool):
    """A table of 3,000 rows read by a Sum and a Mean lookup; split, its
    superhot tier [0, 64) joins the one-hot group beside a small table."""
    big = pkg.EmbeddingTableConfig("big", 3000, 8)
    small = pkg.EmbeddingTableConfig("small", 57, 8)
    return [
        pkg.LookupConfig(0, big, "f0", "e0", comb.Sum, 5),
        pkg.LookupConfig(1, small, "f1", "e1", comb.Sum, 3),
        pkg.LookupConfig(2, big, "f2", "e2", comb.Mean, 2),
    ]


def _window_keys(rng, b, hot, vocab_of):
    """Keys with -1 padding, keys < -1, keys >= V and the window edges
    (lo - 1, lo, hi - 1, hi of the superhot tier [0, 64) and the hot tier
    [64, 256)); sample 0 all padding."""
    feats = {}
    for f, h in hot.items():
        v = vocab_of[f]
        k = rng.integers(0, v, size=(b, h)).astype(np.int32)
        r = rng.random((b, h))
        k[r < 0.15] = -1
        neg = (r >= 0.15) & (r < 0.25)
        k[neg] = -rng.integers(2, 3 * v, size=int(neg.sum()))
        big = (r >= 0.25) & (r < 0.35)
        k[big] = v + rng.integers(0, 3 * v, size=int(big.sum()))
        low = (r >= 0.35) & (r < 0.6)
        k[low] = rng.integers(0, 300, size=int(low.sum()))  # the hot tiers
        edges = np.array([-1, 0, 63, 64, 255, 256, v - 1, v, v + 1, -2], np.int32)
        k[1 : 1 + len(edges), 0] = edges
        k[0] = -1
        feats[f] = k
    return feats


@pytest.mark.parametrize("split", [True, False], ids=["split_drops", "unsplit_wraps"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_onehot_forward_matches_jax(mesh1, monkeypatch, split, dtype):
    """The one-hot group's plain forward (and the wrapper, one call) on the
    raw keys against the JAX package's `_onehot_fwd` on `_group_keys`:
    split, the superhot tier drops every key outside [0, 64); unsplit, the
    big table is not in the group and the small table wraps keys >= V and
    keys < -1."""
    _env(monkeypatch, HCTR_TPU_ONEHOT_VOCAB=128, HCTR_TPU_HOT_ROWS=256 if split else 0,
         HCTR_TPU_SUPERHOT_ROWS=64, HCTR_TPU_SPLIT_VOCAB=1024)
    kw = dict(onehot_vocab=128, split_vocab=1024, hot_rows=256 if split else 0, superhot_rows=64)
    rng = np.random.default_rng(41)
    feats = _window_keys(rng, 64, {"f0": 5, "f1": 3, "f2": 2}, {"f0": 3000, "f1": 57, "f2": 3000})
    jpl = jplan.compile_plan(_window_lookups(jplan, JComb, split), jplan.ShardingPlan([]), 1)
    tpl = tplan.compile_plan(_window_lookups(tplan, TComb, split), tplan.ShardingPlan([]), 1, **kw)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jec = JEC(jpl, mesh1, JOptParams(JOpt.RowWiseAdaGrad), dtype=jdt)
    tec = TEC(tpl, CPU, TOptParams(TOpt.RowWiseAdaGrad), dtype=tdt)
    jg = next(g for g in jpl.groups if g.compute_kind == "onehot")
    tg = next(g for g in tpl.groups if g.compute_kind == "onehot")
    assert [(lm.key_lo, lm.key_hi) for lm in tg.lookups] == (
        [(0, 64), (0, -1), (0, 64)] if split else [(0, -1)])
    table = (rng.normal(size=(tg.total_storage_rows, 8)) * 0.1).astype(np.float32)
    want = np.asarray(jec._onehot_fwd(
        jg.name, jnp.asarray(table, jdt), jec._group_keys(jg, {k: jnp.asarray(v) for k, v in feats.items()})
    ).astype(jnp.float32))
    tkeys = tec._lookup_keys(tg, {k: torch.from_numpy(v) for k, v in feats.items()})
    ttable = torch.from_numpy(table).to(tdt)
    got = oh.onehot_fwd_group_plain(tkeys, tec._meta[tg.name].fwd_lookups, ttable, tg.out_width)
    ops.reset_counts()
    got2 = oh.onehot_fwd_group(tkeys, tec._meta[tg.name].fwd_lookups, ttable, tg.out_width)
    assert ops.plain_counts()["onehot_fwd"] == 1
    assert torch.equal(got, got2)
    tol = F32_TOL if dtype == "float32" else dict(rtol=BF16_ULP, atol=BF16_ULP * 0.1)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    np.testing.assert_array_equal(got.float().numpy()[0], 0.0)
    # the window's edges, on the plain version's placement: in the split
    # group, keys 63 -> row 63, 64 and -2 and >= V -> padding
    wk = oh.window_keys(torch.tensor([-2, -1, 0, 63, 64, 3000, 5000]), 0, 64 if split else -1)
    assert wk.tolist() == ([-1, -1, 0, 63, -1, -1, -1] if split else [-2, -1, 0, 63, 64, 3000, 5000])


# -------------------------------------------------------- split collection
def _split_lookups(pkg, comb, combiner):
    big = pkg.EmbeddingTableConfig("big", 3000, 8)
    small = pkg.EmbeddingTableConfig("small", 57, 8)
    mid = pkg.EmbeddingTableConfig("mid", 700, 8)
    c = getattr(comb, combiner)
    return [
        pkg.LookupConfig(0, big, "f0", "e0", c, 6),
        pkg.LookupConfig(1, small, "f1", "e1", comb.Sum, 3),
        pkg.LookupConfig(2, mid, "f2", "e2", comb.Sum, 2),
        pkg.LookupConfig(3, big, "f3", "e3", c, 2),
    ]


SPLIT_HOT = {"f0": 6, "f1": 3, "f2": 2, "f3": 2}
SPLIT_VOCAB = {"f0": 3000, "f1": 57, "f2": 700, "f3": 3000}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("combiner", ["Sum", "Mean"])
def test_split_collection_forward_and_update_match_jax(mesh1, monkeypatch, combiner, dtype):
    """forward + backward_and_update of a collection whose 3,000-row table
    is split into superhot [0, 64) (one-hot group), hot [64, 256) (dense
    sweep) and cold [256, 3000) (sorted route) tiers, Sum and Mean merges:
    outputs, the table put back together, and the optimizer state; bf16
    tables with bf16 state against the JAX package with the same settings
    (its segment_sum route, as bench.py sets it)."""
    _env(monkeypatch, HCTR_TPU_ONEHOT_VOCAB=128, HCTR_TPU_HOT_ROWS=256, HCTR_TPU_SUPERHOT_ROWS=64,
         HCTR_TPU_SPLIT_VOCAB=1024, HCTR_TPU_SEGSUM="xla", HCTR_TPU_UCAP_FACTOR="0",
         HCTR_TPU_DENSE_UPDATE_ROWS=1000, HCTR_TPU_DENSE_KEY_RATIO=0.3,
         HCTR_TPU_EMB_STATE_DTYPE=dtype)
    rng = np.random.default_rng(43)
    b = 48
    feats = _window_keys(rng, b, SPLIT_HOT, SPLIT_VOCAB)
    values = {n: (rng.normal(size=(v, 8)) * 0.1).astype(np.float32)
              for n, v in (("big", 3000), ("small", 57), ("mid", 700))}
    d_outs = {f"e{i}": rng.normal(size=(b, 8)).astype(np.float32) for i in range(4)}
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    jpl = jplan.compile_plan(_split_lookups(jplan, JComb, combiner), jplan.ShardingPlan([]), 1)
    jec = JEC(jpl, mesh1, JOptParams(JOpt.RowWiseAdaGrad, initial_accu_value=0.0), dtype=jdt)
    jt = jec.init(jax.random.key(0))
    for n, v in values.items():
        jt = jec.import_table(jt, n, v)
    js = jec.init_optimizer(jt)
    jout = jax.jit(jec.forward)(jt, feats)
    jt, js = jax.jit(jec.backward_and_update)(
        jt, js, feats, {k: jnp.asarray(v, jdt) for k, v in d_outs.items()}, jnp.asarray(0.3),
        jnp.asarray(1))

    tpl = tplan.compile_plan(_split_lookups(tplan, TComb, combiner), tplan.ShardingPlan([]), 1,
                             onehot_vocab=128, split_vocab=1024, hot_rows=256, superhot_rows=64)
    tec = TEC(tpl, CPU, TOptParams(TOpt.RowWiseAdaGrad, initial_accu_value=0.0), dtype=tdt,
              dense_update_rows=1000, dense_key_ratio=0.3, state_dtype=tdt)
    tt = tec.init(CPU.generator(0))
    for n, v in values.items():
        tt = tec.import_table(tt, n, v)
    ts = tec.init_optimizer(tt)
    tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    ops.reset_counts()
    tout = tec.forward(tt, tfeats)
    assert sorted(tout) == sorted(jout) == ["e0", "e1", "e2", "e3"]
    tec.backward_and_update(tt, ts, tfeats, {k: torch.from_numpy(v).to(tdt) for k, v in d_outs.items()},
                            torch.tensor(0.3))
    assert tec.group_routes == {"onehot_ev8": "onehot", "mp_ev8": "dense",
                                "mp_ev8_big::cold": "sorted"}
    counts = ops.plain_counts()
    assert counts["onehot_fwd"] == 1 and counts["onehot_bwd"] == 1 and counts["segscan"] == 1
    if dtype == "float32":
        tol = F32_TOL
    else:
        tol = dict(rtol=BF16_ULP, atol=BF16_ULP * 0.1)
    for k in jout:
        np.testing.assert_allclose(tout[k].float().numpy(), np.asarray(jout[k].astype(jnp.float32)),
                                   **tol, err_msg=k)
    for n in values:
        got, want = tec.export_table(tt, n), np.asarray(jec.export_table(jt, n)).astype(np.float32)
        assert got.shape == want.shape == values[n].shape
        np.testing.assert_allclose(got, want, **tol, err_msg=n)
    for g in ts:
        assert ts[g]["accum"].dtype == tdt
        np.testing.assert_allclose(ts[g]["accum"].float().numpy(),
                                   np.asarray(js[g]["accum"]).astype(np.float32),
                                   rtol=tol["rtol"], atol=1e-7, err_msg=g)
