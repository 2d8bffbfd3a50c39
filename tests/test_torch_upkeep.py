"""Dynamic-table upkeep, `evict` and `grow_dynamic_capacity`, against the
JAX package on one device (tests/test_dynamic_table.py's cases, each run by
both packages from the same tables and keys): key stores bit for bit, the
rows and optimizer state of the keys bit for bit where they are carried or
zeroed, tables after further steps within rtol 1e-4 / atol 1e-5 (sums in
another order). A dynamic table's rows that no key holds start from each
package's own init, so those rows are not compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.core.types import Combiner_t as JComb
from hugectr_tpu.core.types import Optimizer_t as JOpt
from hugectr_tpu.embedding.collection import EmbeddingCollection as JEC
from hugectr_tpu.embedding.collection import _hash_mix
from hugectr_tpu.optim.params import OptParams as JOptParams
from hugectr_tpu.parallel import plan as jplan

from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Combiner_t as TComb
from hugectr_tpu_torch.core.types import Optimizer_t as TOpt
from hugectr_tpu_torch.embedding.collection import EMPTY_KEY
from hugectr_tpu_torch.embedding.collection import EmbeddingCollection as TEC
from hugectr_tpu_torch.optim.params import OptParams as TOptParams
from hugectr_tpu_torch.parallel import plan as tplan

torch.set_num_threads(1)
CPU = ResourceManager.create(device="cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
E = 8
HYPER = dict(lr=0.5, initial_accu_value=0.0, epsilon=1e-7)


def _single(pkg, comb, capacity):
    t = pkg.EmbeddingTableConfig("dyn", -1, E, dynamic_capacity=capacity)
    return [pkg.LookupConfig(0, t, "f", "e", comb.Sum, 2)]


def _siblings(pkg, comb, capacity):
    """tests/test_dynamic_table.py:247: two dynamic tables and a static one
    in one model-parallel group."""
    td = pkg.EmbeddingTableConfig("dyn", -1, E, dynamic_capacity=capacity)
    td2 = pkg.EmbeddingTableConfig("dyn2", -1, E, dynamic_capacity=capacity)
    ts = pkg.EmbeddingTableConfig("stat", 40, E)
    return [pkg.LookupConfig(0, td, "f0", "e0", comb.Sum, 2), pkg.LookupConfig(1, td2, "f1", "e1", comb.Sum, 2),
            pkg.LookupConfig(2, ts, "f2", "e2", comb.Sum, 2)]


def _split(pkg, comb, capacity):
    """A split static table (hot 16) beside a dynamic one."""
    big = pkg.EmbeddingTableConfig("big", 200, E)
    td = pkg.EmbeddingTableConfig("dyn", -1, E, dynamic_capacity=capacity)
    return [pkg.LookupConfig(0, big, "f0", "e0", comb.Sum, 3), pkg.LookupConfig(1, td, "f1", "e1", comb.Sum, 2)]


class Pair:
    """The same collection in each package, zero-filled dynamic rows and
    the same static rows; `step` runs both on the same keys and
    cotangents, `check` compares stores bitwise and the resident rows."""

    def __init__(self, monkeypatch, lookups_of, capacity=32, opt="adagrad", route="sorted", hot_rows=0):
        dense_rows = 0 if route == "sorted" else 10000
        for k, v in {"HCTR_TPU_DENSE_UPDATE_ROWS": str(dense_rows), "HCTR_TPU_DENSE_KEY_RATIO": "0",
                     "HCTR_TPU_SEGSUM": "xla", "HCTR_TPU_ONEHOT_VOCAB": "0", "HCTR_TPU_HOT_ROWS": str(hot_rows),
                     "HCTR_TPU_SPLIT_VOCAB": "0", "HCTR_TPU_SUPERHOT_ROWS": "0"}.items():
            monkeypatch.setenv(k, v)
        self.lookups_of, self.capacity = lookups_of, capacity
        jpl = jplan.compile_plan(lookups_of(jplan, JComb, capacity), jplan.ShardingPlan([]), 1)
        tpl = tplan.compile_plan(lookups_of(tplan, TComb, capacity), tplan.ShardingPlan([]), 1, onehot_vocab=0,
                                 split_vocab=0, hot_rows=hot_rows)
        assert [g.name for g in tpl.groups] == [g.name for g in jpl.groups]
        self.jec = JEC(jpl, JaxResourceManager.create(num_devices=1), JOptParams(JOpt(opt), **HYPER))
        self.tec = TEC(tpl, CPU, TOptParams(TOpt(opt), **HYPER), dense_update_rows=dense_rows, dense_key_ratio=0.0)
        jt, tt = self.jec.init(jax.random.key(0)), self.tec.init(CPU.generator(0))
        rng = np.random.default_rng(3)
        for g in tpl.groups:
            if g.slot_is_dynamic.any():
                jt[g.name] = jnp.zeros_like(jt[g.name])
                tt[g.name].zero_()
        self.static = [lk.table.name for lk in lookups_of(tplan, TComb, capacity) if not lk.table.is_dynamic]
        for n in self.static:
            values = rng.normal(size=(self.jec.export_table(jt, n).shape[0], E)).astype(np.float32)
            jt = self.jec.import_table(jt, n, values)
            self.tec.import_table(tt, n, values)
        self.jt, self.js, self.tt, self.ts = jt, self.jec.init_optimizer(jt), tt, self.tec.init_optimizer(tt)
        self.n = 0

    def step(self, feats, d):
        self.n += 1
        self.jt, self.js = jax.jit(self.jec.backward_and_update)(self.jt, self.js, feats, d, jnp.asarray(0.5),
                                                                 jnp.asarray(self.n))
        self.tec.backward_and_update(self.tt, self.ts, _t(feats), _t(d), torch.tensor(0.5), self.n)
        self.check()

    def check(self):
        """Stores bitwise; each store row that holds a key: its table and
        state rows; static tables by key."""
        for g in self.tec.plan.groups:
            tol = TOL
            rows = slice(None)
            if f"{g.name}#keys" in self.tt:
                ks = self.tt[f"{g.name}#keys"].numpy()
                np.testing.assert_array_equal(ks, np.asarray(self.jt[f"{g.name}#keys"]), err_msg=g.name)
                rows = ks != EMPTY_KEY
            np.testing.assert_allclose(self.tt[g.name].numpy()[rows], np.asarray(self.jt[g.name])[rows], **tol,
                                       err_msg=g.name)
            for k, v in self.ts[g.name].items():
                np.testing.assert_allclose(v.numpy()[rows], np.asarray(self.js[g.name][k])[rows], **tol,
                                           err_msg=f"{g.name} {k}")
        for n in self.static:
            np.testing.assert_allclose(self.tec.export_table(self.tt, n), self.jec.export_table(self.jt, n), **TOL)

    def _arrays(self):
        return {g.name: [self.tt[g.name].clone(), *(v.clone() for v in self.ts[g.name].values())]
                for g in self.tec.plan.groups}

    def evict(self, table, keys):
        """Both packages evict; the port's rows and state that changed are
        exactly those its store freed (or a static table's keys' rows), now
        all 0, every other row bitwise as before."""
        before = self._arrays()
        stores = {k: v.clone() for k, v in self.tt.items() if k.endswith("#keys")}
        dynamic = table not in self.tec.plan.table_splits and self.tec._key_store(self.tt, table) is not None
        self.jt, self.js = self.jec.evict(self.jt, self.js, table, keys)
        out = self.tec.evict(self.tt, self.ts, table, keys)
        assert out[0] is self.tt and out[1] is self.ts  # in place
        for g in self.tec.plan.groups:
            for old, new in zip(before[g.name], [self.tt[g.name], *self.ts[g.name].values()]):
                changed = (old != new).reshape(old.shape[0], -1).any(1)
                assert (new[changed] == 0).all(), g.name
                assert int(changed.sum()) <= len(keys)
                if f"{g.name}#keys" in stores:
                    freed = stores[f"{g.name}#keys"] != self.tt[f"{g.name}#keys"]
                    assert (self.tt[f"{g.name}#keys"][freed] == EMPTY_KEY).all() and (new[freed] == 0).all()
                    if dynamic:
                        assert not (changed & ~freed).any()
        self.check()

    def grow(self, table, cap):
        """Both packages grow; every key the port's old stores held keeps
        its row and state bitwise."""
        old = {}
        for g in self.tec.plan.groups:
            for ti, t in enumerate(g.tables):
                if t.is_dynamic:
                    keys, vals, st = self.tec._collect_dynamic_entries(self.tt, self.ts, g, ti)
                    old[t.name] = dict(zip(keys.tolist(), zip(vals, *st.values())))
        self.jec, self.jt, self.js = self.jec.grow_dynamic_capacity(self.jt, self.js, table, cap)
        self.tec, self.tt, self.ts = self.tec.grow_dynamic_capacity(self.tt, self.ts, table, cap)
        assert [g.name for g in self.tec.plan.groups] == [g.name for g in self.jec.plan.groups]
        g, ti = self.tec._find_table(table)
        assert int(g.table_vocab[ti]) == cap
        # a fresh row of a dynamic table starts from each package's own init:
        # zero them in both, as at the start
        for g in self.tec.plan.groups:
            if f"{g.name}#keys" not in self.tt:
                continue
            free = np.zeros(g.total_local_rows, bool)
            for ti, t in enumerate(g.tables):
                if t.is_dynamic:
                    off = int(g.local_offsets[ti])
                    free[off : off + int(g.rows_per_shard[ti])] = True
            free &= self.tt[f"{g.name}#keys"].numpy() == EMPTY_KEY
            self.tt[g.name][torch.from_numpy(free)] = 0
            self.jt[g.name] = self.jt[g.name].at[np.nonzero(free)[0]].set(0)
        for name, rows in old.items():
            g, ti = self.tec._find_table(name)
            keys, vals, st = self.tec._collect_dynamic_entries(self.tt, self.ts, g, ti)
            assert sorted(keys.tolist()) == sorted(rows), name
            for k, *arrs in zip(keys.tolist(), vals, *st.values()):
                for a, b in zip(arrs, rows[k]):
                    assert torch.equal(a, b), (name, k)
        self.check()


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _feats(rng, spec, b=8):
    return {f: rng.integers(0, v, size=(b, 2)).astype(np.int32) for f, v in spec.items()}


def _grads(rng, tops, b=8):
    return {t: rng.normal(size=(b, E)).astype(np.float32) for t in tops}


def test_exact_evict_does_not_clobber(monkeypatch):
    """tests/test_dynamic_table.py:150: evicting key 3 zeroes its row and
    frees its store row; key 11's row is untouched (bitwise, both packages)."""
    p = Pair(monkeypatch, _single, capacity=32, opt="sgd")
    p.step({"f": np.array([[3, 11]], np.int32)}, {"e": np.ones((1, E), np.float32)})
    before = p.tt[p.tec.plan.groups[0].name].clone()
    p.evict("dyn", np.array([3]))
    g = p.tec.plan.groups[0]
    ks = p.tt[f"{g.name}#keys"].numpy()
    assert 3 not in ks and 11 in ks
    s11 = int(np.nonzero(ks == 11)[0][0])
    assert torch.equal(p.tt[g.name][s11], before[s11])
    p.check()


@pytest.mark.parametrize("opt", ["adagrad", "rowwise_adagrad", "adam", "ftrl"])
def test_evict_then_reinsert_matches_jax(monkeypatch, opt):
    """Train, evict resident keys (and absent ones, and -1), train again on
    keys that include the evicted ones: they insert again from zeroed rows
    and state, with every optimizer's state (bitwise at the evict, then
    within the update tolerance)."""
    p = Pair(monkeypatch, _siblings, capacity=32, opt=opt)
    rng = np.random.default_rng(5)
    spec = {"f0": 60, "f1": 60, "f2": 40}
    tops = ("e0", "e1", "e2")
    for _ in range(2):
        p.step(_feats(rng, spec), _grads(rng, tops))
    ks = p.tt[f"{p.tec.plan.groups[0].name}#keys"].numpy()
    resident = ks[ks != EMPTY_KEY][:5]
    p.evict("dyn", np.concatenate([resident, [999, -1]]))
    p.check()
    p.evict("stat", np.array([1, 7, 39, 41]))  # a static table: rows and state zeroed (41 wraps to 1)
    p.check()
    for _ in range(2):
        p.step(_feats(rng, spec), _grads(rng, tops))


def test_evict_split_table_matches_jax(monkeypatch):
    """A split table evicts each key from the tier whose window holds it
    (collection.py:2228-2237)."""
    p = Pair(monkeypatch, _split, capacity=32, opt="adagrad", hot_rows=16)
    assert p.tec.plan.table_splits
    rng = np.random.default_rng(6)
    p.step(_feats(rng, {"f0": 200, "f1": 50}, 16) | {"f0": rng.integers(0, 200, (16, 3)).astype(np.int32)},
           _grads(rng, ("e0", "e1"), 16))
    p.evict("big", np.array([0, 5, 15, 16, 100, 199]))
    p.check()
    np.testing.assert_array_equal(p.tec.export_table(p.tt, "big")[[0, 5, 15, 16, 100, 199]], 0.0)


def test_no_reinsert_into_evict_hole(monkeypatch):
    """tests/test_dynamic_table.py:440: k2 sits at a later probe row than
    k1's; after evicting k1, training k2 updates its own row and never
    inserts into the hole."""
    cap = 16
    h = np.asarray(_hash_mix(jnp.arange(10_000))).astype(np.uint64) % cap
    k1, k2 = next((int(a[0]), int(a[1])) for a in (np.nonzero(h == s)[0] for s in range(cap)) if len(a) >= 2)
    p = Pair(monkeypatch, _single, capacity=cap, opt="sgd")
    p.step({"f": np.array([[k1, -1], [k2, -1]], np.int32)}, {"e": np.ones((2, E), np.float32)})
    g = p.tec.plan.groups[0]
    slot2 = int(np.nonzero(p.tt[f"{g.name}#keys"].numpy() == k2)[0][0])
    p.evict("dyn", np.array([k1]))
    p.step({"f": np.array([[k2, -1]], np.int32)}, {"e": np.ones((1, E), np.float32)})
    ks = p.tt[f"{g.name}#keys"].numpy()
    assert np.nonzero(ks == k2)[0].tolist() == [slot2] and k1 not in ks
