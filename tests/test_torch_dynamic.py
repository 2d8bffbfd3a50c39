"""The port's exact dynamic tables against the JAX package's
(collection.py `_hash_mix` :53, `_dynamic_probe` :468, `_dynamic_insert`
:497): the murmur3 finalizer, placement and the scatter-min insert on the
backward, and a dynamic collection's training steps.

Key stores are compared bit for bit (the insert is exact integer work, and
its `amin` arbitration does not depend on the order of the writes). Tables,
optimizer state and forward outputs: float32 rtol 1e-4 / atol 1e-5 (sums in
another order). FTRL's weights are 0 where |z| <= lambda1; elements of w
with ||z| - lambda1| <= 1e-6 are left out of the comparison, counted and
required to be few (see test_torch_optimizers.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugectr_tpu.core.types import INVALID_KEY
from hugectr_tpu.core.types import Combiner_t as JComb
from hugectr_tpu.core.types import Optimizer_t as JOpt
from hugectr_tpu.embedding.collection import EmbeddingCollection as JEC
from hugectr_tpu.embedding.collection import _hash_mix, _hash_mix_np
from hugectr_tpu.optim.params import OptParams as JOptParams
from hugectr_tpu.parallel import plan as jplan

from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Combiner_t as TComb
from hugectr_tpu_torch.core.types import Optimizer_t as TOpt
from hugectr_tpu_torch.embedding import collection as tcollection
from hugectr_tpu_torch.embedding.collection import EmbeddingCollection as TEC
from hugectr_tpu_torch.optim.params import OptParams as TOptParams
from hugectr_tpu_torch.parallel import plan as tplan

from test_torch_optimizers import assert_ftrl_close

torch.set_num_threads(1)
CPU = ResourceManager.create(device="cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
E = 8
EMPTY = 2**31 - 1
HYPER = dict(initial_accu_value=0.1, epsilon=1e-7, lambda1=0.05, lambda2=0.01, ftrl_beta=0.0)


def test_hash_mix_matches_jax():
    """The int64 form of the finalizer on int32 keys (negative keys, 0,
    +-2^31 edges, the EMPTY marker) equals the JAX package's uint32 form and
    its numpy mirror `_hash_mix_np`, bit for bit."""
    rng = np.random.default_rng(0)
    keys = np.concatenate([
        rng.integers(-(2**31), 2**31, 5000),
        [0, 1, -1, 2**31 - 1, 2**31 - 2, -(2**31), 7, 9],
    ]).astype(np.int32)
    want = _hash_mix_np(keys)
    np.testing.assert_array_equal(np.asarray(_hash_mix(jnp.asarray(keys))), want)
    got = tcollection.hash_mix(torch.from_numpy(keys))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _lookups(pkg, comb, capacity):
    """A dynamic table read by a Sum lookup (hotness 3) and a Mean lookup
    (hotness 2), beside a static table in the same group."""
    dyn = pkg.EmbeddingTableConfig("dyn", -1, E, dynamic_capacity=capacity)
    st = pkg.EmbeddingTableConfig("st", 50, E)
    return [pkg.LookupConfig(0, dyn, "f0", "e0", comb.Sum, 3), pkg.LookupConfig(1, dyn, "f1", "e1", comb.Mean, 2),
            pkg.LookupConfig(2, st, "f2", "e2", comb.Sum, 2)]


class Pair:
    """One collection in each package from the same tables (zero-filled
    dynamic rows: a fresh row's value depends on the layout, ROADMAP)."""

    def __init__(self, mesh1, monkeypatch, kind="sgd", capacity=64, route="dense"):
        dense_rows = "262144" if route == "dense" else "0"
        for k, v in {"HCTR_TPU_DENSE_UPDATE_ROWS": dense_rows, "HCTR_TPU_DENSE_KEY_RATIO": "0",
                     "HCTR_TPU_SEGSUM": "scan", "HCTR_TPU_ONEHOT_VOCAB": "0"}.items():
            monkeypatch.setenv(k, v)
        self.kind = kind
        jpl = jplan.compile_plan(_lookups(jplan, JComb, capacity), jplan.ShardingPlan([("mp", ["dyn", "st"])]), 1)
        tpl = tplan.compile_plan(_lookups(tplan, TComb, capacity), tplan.ShardingPlan([("mp", ["dyn", "st"])]), 1,
                                 onehot_vocab=0)
        self.jec = JEC(jpl, mesh1, JOptParams(JOpt(kind), **HYPER))
        self.jfwd, self.jbwd = jax.jit(self.jec.forward), jax.jit(self.jec.backward_and_update)
        self.tec = TEC(tpl, CPU, TOptParams(TOpt(kind), **HYPER), dense_update_rows=int(dense_rows),
                       dense_key_ratio=0.0)
        assert [g.name for g in tpl.groups] == [g.name for g in jpl.groups] == ["mp_ev8"]
        self.g = tpl.groups[0].name
        assert tpl.groups[0].slot_is_dynamic.tolist() == [True] * 5 + [False] * 2
        jt = self.jec.init(jax.random.key(0))
        values = np.random.default_rng(1).normal(size=(50, E)).astype(np.float32)
        jt[self.g] = jnp.zeros_like(jt[self.g])
        jt = self.jec.import_table(jt, "st", values)
        self.jt, self.js = jt, self.jec.init_optimizer(jt)
        self.tt = self.tec.init(CPU.generator(0))
        self.tt[self.g].zero_()
        self.tec.import_table(self.tt, "st", values)
        self.ts = self.tec.init_optimizer(self.tt)
        assert self.tt[f"{self.g}#keys"].dtype == torch.int32
        self.check()
        self.step_no = 0

    def forward(self, feats):
        jout = self.jfwd(self.jt, feats)
        tout = self.tec.forward(self.tt, {k: torch.from_numpy(v) for k, v in feats.items()})
        for k in jout:
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), **TOL, err_msg=k)
        return {k: v.numpy() for k, v in tout.items()}

    def step(self, feats, d):
        self.step_no += 1
        self.jt, self.js = self.jbwd(
            self.jt, self.js, feats, d, jnp.asarray(0.5), jnp.asarray(self.step_no))
        self.tec.backward_and_update(self.tt, self.ts, {k: torch.from_numpy(v) for k, v in feats.items()},
                                     {k: torch.from_numpy(v) for k, v in d.items()}, torch.tensor(0.5),
                                     self.step_no)
        self.check()

    def store(self):
        return self.tt[f"{self.g}#keys"].numpy()

    def check(self):
        np.testing.assert_array_equal(self.store(), np.asarray(self.jt[f"{self.g}#keys"]))
        what = f"{self.kind} step {getattr(self, 'step_no', 0)}"
        jz = np.asarray(self.js[self.g]["z"]) if self.kind == "ftrl" else None
        if jz is not None:
            assert_ftrl_close(self.tt[self.g].numpy(), np.asarray(self.jt[self.g]), jz, HYPER["lambda1"], TOL, what)
        else:
            np.testing.assert_allclose(self.tt[self.g].numpy(), np.asarray(self.jt[self.g]), **TOL, err_msg=what)
        for k, v in self.ts[self.g].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(self.js[self.g][k]), **TOL, err_msg=f"{what} {k}")


def _feats(rng, b, hi, pad=0.2):
    out = {}
    for f, h, v in (("f0", 3, hi), ("f1", 2, hi), ("f2", 2, 50)):
        k = rng.integers(0, v, size=(b, h)).astype(np.int32)
        k[rng.random((b, h)) < pad] = INVALID_KEY
        out[f] = k
    return out


def _grads(rng, b):
    return {f"e{i}": rng.normal(size=(b, E)).astype(np.float32) for i in range(3)}


def _colliding_keys(capacity, n):
    """n keys whose first probe is the same table row."""
    base = _hash_mix_np(np.arange(100_000, dtype=np.int32)) % capacity
    slot = np.bincount(base).argmax()
    return np.where(base == slot)[0][:n].astype(np.int32)


def test_colliding_keys_and_repeats_match_jax(mesh1, monkeypatch):
    """Nine keys with one first probe, each repeated in the batch and in
    both lookups: the store holds eight of them in consecutive rows with the
    smallest keys winning each round, the ninth is dropped after
    NUM_PROBES rounds and reads as padding; tables and stores agree with
    the JAX package's after the insert and after a second step."""
    cap = 64
    p = Pair(mesh1, monkeypatch, capacity=cap)
    ks = _colliding_keys(cap, 9)[::-1].copy()  # largest first: arbitration, not order, decides
    b = 9
    feats = {"f0": np.stack([ks, ks, np.full(b, INVALID_KEY, np.int32)], 1),
             "f1": np.stack([ks[::-1], ks], 1), "f2": np.zeros((b, 2), np.int32)}
    rng = np.random.default_rng(2)
    p.step(feats, _grads(rng, b))
    store = p.store()
    held = store[store != EMPTY]
    assert sorted(held.tolist()) == sorted(ks.tolist())[:8]
    dropped = max(ks)
    out = p.forward(feats)
    row = int(np.where(ks == dropped)[0][0])
    np.testing.assert_array_equal(out["e0"][row], 0.0)  # dropped: padding twice over
    p.step(feats, _grads(rng, b))


def test_forward_miss_then_hit_matches_jax(mesh1, monkeypatch):
    """Before the insert a dynamic key reads as padding (a Mean lookup still
    divides by its raw valid keys); after one backward it reads its row."""
    p = Pair(mesh1, monkeypatch, kind="adagrad")
    feats = {"f0": np.array([[7, 9, INVALID_KEY]], np.int32), "f1": np.array([[7, 11]], np.int32),
             "f2": np.array([[3, INVALID_KEY]], np.int32)}
    out0 = p.forward(feats)
    np.testing.assert_array_equal(out0["e0"], 0.0)
    np.testing.assert_array_equal(out0["e1"], 0.0)
    p.step(feats, _grads(np.random.default_rng(3), 1))
    out1 = p.forward(feats)
    assert np.abs(out1["e0"]).sum() > 0 and np.abs(out1["e1"]).sum() > 0
    assert sorted(p.store()[p.store() != EMPTY].tolist()) == [7, 9, 11]


def test_reserved_key_folds_like_jax(mesh1, monkeypatch):
    """2^31 - 1 is the store's EMPTY marker: as a key it behaves as
    2^31 - 2, so the two share one row; the store holds 2^31 - 2."""
    p = Pair(mesh1, monkeypatch)
    feats = {"f0": np.array([[EMPTY, EMPTY - 1, 5]], np.int32), "f1": np.array([[EMPTY, INVALID_KEY]], np.int32),
             "f2": np.array([[1, 2]], np.int32)}
    p.step(feats, _grads(np.random.default_rng(4), 1))
    assert sorted(p.store()[p.store() != EMPTY].tolist()) == [5, EMPTY - 1]
    p.forward(feats)


@pytest.mark.parametrize("route", ["dense", "sorted"])
def test_capacity_pressure_matches_jax(mesh1, monkeypatch, route):
    """A 24-row table offered 150 distinct keys over three steps: the store
    fills, keys that find no empty row in NUM_PROBES rounds are dropped and
    read as padding, and the JAX package drops the same keys (Momentum on
    the dense sweep or the sorted route)."""
    p = Pair(mesh1, monkeypatch, kind="momentum_sgd", capacity=24, route=route)
    rng = np.random.default_rng(5)
    for _ in range(3):
        feats = _feats(rng, 16, 150, pad=0.1)
        p.step(feats, _grads(rng, 16))
        p.forward(feats)
    fill = int((p.store() != EMPTY).sum())
    assert 16 <= fill <= 24
    assert p.tec.group_routes == {p.g: route}


@pytest.mark.parametrize("route", ["dense", "sorted"])
@pytest.mark.parametrize("kind", ["ftrl", "adagrad"])
def test_dynamic_collection_three_steps_match_jax(mesh1, monkeypatch, kind, route):
    """Three steps of forward + backward_and_update of the dynamic group
    (keys below 80 into 64 rows, -1 padding, repeats) with FTRL or AdaGrad
    on the dense sweep or the sorted route: forward outputs, the table, the
    optimizer state and the key store."""
    p = Pair(mesh1, monkeypatch, kind=kind, route=route)
    rng = np.random.default_rng(6)
    for _ in range(3):
        feats = _feats(rng, 16, 80)
        p.forward(feats)
        p.step(feats, _grads(rng, 16))
    assert p.tec.group_routes == {p.g: route}
    assert (p.store() != EMPTY).sum() > 30


def test_dynamic_tables_never_take_onehot_or_split():
    """A small dynamic table stays off the one-hot engine and the split, and
    a data-parallel dynamic table is refused (plan.py:368, :551, :612)."""
    t = tplan.EmbeddingTableConfig("dyn", -1, E, dynamic_capacity=64)
    assert t.is_dynamic and t.vocabulary_size == 64
    lk = [tplan.LookupConfig(0, t, "f", "e", TComb.Sum, 1)]
    pl = tplan.compile_plan(lk, tplan.ShardingPlan([("mp", ["dyn"])]), 1, onehot_vocab=8192, split_vocab=16,
                            hot_rows=8)
    assert [g.compute_kind for g in pl.groups] == ["rowop"] and not pl.table_splits
    with pytest.raises(ValueError):
        tplan.compile_plan(lk, tplan.ShardingPlan([("dp", ["dyn"])]), 1)


@pytest.mark.parametrize("what", ["export_key_store", "import_key_store", "evict", "grow_dynamic_capacity"])
def test_dynamic_upkeep_not_ported(what):
    tec = TEC(tplan.compile_plan(_lookups(tplan, TComb, 16), tplan.ShardingPlan([]), 1), CPU,
              TOptParams(TOpt.SGD))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(tec, what)(*([None] * (getattr(tec, what).__code__.co_argcount - 1)))
