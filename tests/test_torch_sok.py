"""The port's SOK API (`hugectr_tpu_torch.sok`) against the JAX package's
(`hugectr_tpu.sok`, tests/test_sok.py's cases): engines and variables of
both packages hold the same rows (the port's imported from JAX's), take the
same keys, cotangents and weights, and are compared after each call; the
dynamic variables' stores bit for bit. One device; the case over W = 2 (a
spawned gloo group against JAX's 2-device mesh) is
tests/test_torch_sok_ranks.py.

The port's engines take the engine settings tests/conftest.py gives the
JAX package (no one-hot engine, the sorted route, no key-ratio rule).
Tolerances: lookups rtol 1e-6 / atol 1e-6 (the same rows summed in another
order), updated tables rtol 1e-4 / atol 1e-5; round trips (dump / load,
assign / export, spill / stage) bitwise.
"""
import jax
import numpy as np
import pytest
import torch

import hugectr_tpu.sok as jsok
from hugectr_tpu.core.types import Optimizer_t as JOpt
from hugectr_tpu.optim.params import OptParams as JOptParams
from hugectr_tpu.parallel.plan import EmbeddingTableConfig as JTable

import hugectr_tpu_torch.sok as sok
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Optimizer_t
from hugectr_tpu_torch.optim.params import OptParams
from hugectr_tpu_torch.parallel.plan import EmbeddingTableConfig

torch.set_num_threads(1)
CPU = ResourceManager.create(device="cpu")
SETTINGS = dict(onehot_vocab=0, dense_update_rows=0, dense_key_ratio=0.0)
FWD_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _fresh_sok():
    """sok.init binds module state: each test starts and ends without it."""
    sok._RM = jsok._RM = None
    yield
    sok._RM = jsok._RM = None


def _engines(mesh, rm=CPU, dp=(), opt="sgd", **kw):
    """tests/test_sok.py:15's engine (tables a and b, hotness 3 and 2, Sum
    and Mean) in each package, the port's rows imported from JAX's."""
    jsok.init(mesh)
    sok.init(rm)
    je = jsok.LookupEngine([JTable("a", 100, 8), JTable("b", 50, 8)], hotness=[3, 2], combiners=["sum", "mean"],
                           opt=JOptParams(JOpt(opt), lr=0.1), rm=mesh, dp_tables=dp, **kw)
    te = sok.LookupEngine([EmbeddingTableConfig("a", 100, 8), EmbeddingTableConfig("b", 50, 8)], hotness=[3, 2],
                          combiners=["sum", "mean"], opt=OptParams(Optimizer_t(opt), lr=0.1), dp_tables=dp, **kw,
                          **SETTINGS)
    jt = je.init(jax.random.key(0))
    tt = te.init(0)
    for n in ("a", "b"):
        te.ec.import_table(tt, n, je.ec.export_table(jt, n))
    return je, jt, te, tt


def _keys(rng, b=16):
    k0 = rng.integers(0, 100, (b, 3)).astype(np.int32)
    k1 = rng.integers(0, 50, (b, 2)).astype(np.int32)
    k0[0, 2] = -1
    return k0, k1


@pytest.mark.parametrize("dp", [(), ("b",)])
def test_lookup_matches_jax(mesh1, dp):
    """tests/test_sok.py:30: the fused two-table lookup (padding, Sum and
    Mean), model-parallel and with b data-parallel."""
    je, jt, te, tt = _engines(mesh1, dp=dp)
    k0, k1 = _keys(np.random.default_rng(0))
    jo = je.lookup(jt, [k0, k1])
    to = sok.lookup_sparse(te, tt, [k0, k1])
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD_TOL)


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "rowwise_adagrad"])
def test_optimizer_wrapper_and_dump_load(mesh1, tmp_path, opt):
    """tests/test_sok.py:53: `OptimizerWrapper` updates as JAX's does, and
    `dump` / `load` into fresh tables round-trips bitwise."""
    je, jt, te, tt = _engines(mesh1, opt=opt)
    jw, tw = jsok.OptimizerWrapper(je), sok.OptimizerWrapper(te)
    js, ts = jw.initialize(jt), tw.initialize(tt)
    rng = np.random.default_rng(1)
    keys = [rng.integers(0, v, (16, h)).astype(np.int32) for v, h in ((100, 3), (50, 2))]
    d = [rng.normal(size=(16, 8)).astype(np.float32) for _ in range(2)]
    jt, js = jw.apply_gradients(jt, js, keys, d, 0.1, 1)
    tw.apply_gradients(tt, ts, keys, d, 0.1, 1)
    for n in ("a", "b"):
        np.testing.assert_allclose(te.ec.export_table(tt, n), je.ec.export_table(jt, n), **TOL, err_msg=n)
    sok.dump(str(tmp_path), te, tt)
    tt2 = sok.load(str(tmp_path), te, te.init(7))
    for n in ("a", "b"):
        np.testing.assert_array_equal(te.ec.export_table(tt2, n), te.ec.export_table(tt, n))


def test_all2all_dense_embedding(mesh1):
    """tests/test_sok.py:87: [B] keys -> [B, ev] rows."""
    sok.init(CPU)
    eng = sok.LookupEngine([EmbeddingTableConfig("d", 64, 16)], [1], ["sum"], OptParams(Optimizer_t.SGD, lr=0.1),
                           **SETTINGS)
    tables = eng.init(3)
    out = sok.all2all_dense_embedding(eng, tables, np.arange(16, dtype=np.int32))
    np.testing.assert_array_equal(out.numpy(), eng.ec.export_table(tables, "d")[:16])


def test_evict_and_incremental_dump(mesh1):
    """tests/test_sok.py:102: `evict` of a static table's keys zeroes their
    rows (as JAX's), the others unchanged; `incremental_model_dump` of
    named keys."""
    je, jt, te, tt = _engines(mesh1)
    js, ts = je.ec.init_optimizer(jt), te.ec.init_optimizer(tt)
    before = te.ec.export_table(tt, "a")
    jt, js = je.ec.evict(jt, js, "a", np.asarray([7, 13]))
    te.ec.evict(tt, ts, "a", np.asarray([7, 13]))
    after = te.ec.export_table(tt, "a")
    np.testing.assert_array_equal(after, je.ec.export_table(jt, "a"))
    np.testing.assert_array_equal(after[[7, 13]], 0.0)
    np.testing.assert_array_equal(np.delete(after, [7, 13], 0), np.delete(before, [7, 13], 0))
    inc = sok.incremental_model_dump(te, tt, {"a": np.asarray([5, 7, 100])})
    jinc = jsok.incremental_model_dump(je, jt, {"a": np.asarray([5, 7, 100])})
    np.testing.assert_array_equal(inc["a"]["keys"], jinc["a"]["keys"])
    np.testing.assert_array_equal(inc["a"]["values"], jinc["a"]["values"])


def test_variable_create_and_train():
    """tests/test_sok.py:120: `Variable` lookup, update, assign and
    to_numpy."""
    sok.init(CPU)
    v = sok.Variable.create(rows=64, ev=8, key=3, name="v0", max_hotness=2,
                            opt_params=OptParams(Optimizer_t.SGD, lr=0.5), **SETTINGS)
    assert v.shape == (64, 8)
    dense = np.random.default_rng(5).normal(size=(64, 8)).astype(np.float32)
    v.assign(dense)
    np.testing.assert_array_equal(v.to_numpy(), dense)
    keys = np.full((16, 2), -1, dtype=np.int32)
    keys[0] = [3, 9]
    keys[1] = [4, -1]
    out = v.lookup(keys).numpy()
    np.testing.assert_allclose(out[0], dense[3] + dense[9], rtol=1e-6)
    np.testing.assert_array_equal(out[1], dense[4])
    d = np.zeros((16, 8), dtype=np.float32)
    d[:2] = 1.0
    v.apply_gradients(keys, d, lr=0.5)
    after = v.to_numpy()
    np.testing.assert_allclose(after[3], dense[3] - 0.5, rtol=1e-6)
    np.testing.assert_array_equal(after[0], dense[0])


def test_localized_and_distributed_variables():
    """tests/test_sok.py:146 and :389: a localized variable is one shard (the
    whole table on every rank), a distributed one a shard a rank; both look
    up like `Variable(mode=...)`."""
    sok.init(ResourceManager(torch.device("cpu"), 0, 2))  # 2 ranks, no group: the plans only
    lv = sok.LocalizedVariable(40, 8, name="vloc", target_gpu=0, **SETTINGS)
    dv = sok.DistributedVariable(64, 8, name="dv", **SETTINGS)
    assert lv.engine.ec.plan.groups[0].num_shards == 1 and lv.engine.ec.plan.groups[0].num_replicas == 2
    assert dv.engine.ec.plan.groups[0].num_shards == 2
    sok.init(CPU)
    v = sok.Variable(rows=40, ev=8, key=1, name="vloc", mode="localized:0", **SETTINGS)
    dense = np.random.default_rng(2).normal(size=(40, 8)).astype(np.float32)
    v.assign(dense)
    k = np.full((8, 1), -1, dtype=np.int32)
    k[0, 0] = 7
    np.testing.assert_array_equal(v.lookup(k).numpy()[0], dense[7])
    assert sok.LocalizedVariable(64, 8, name="lv").lookup(np.arange(8, dtype=np.int32)).shape == (8, 8)


def _dyn_pair(mesh1, capacity=32, hotness=1, **kw):
    """A DynamicVariable in each package, zero rows (a fresh row's value is
    each package's own init)."""
    jsok.init(mesh1)
    sok.init(CPU)
    jv = jsok.DynamicVariable(dimension=8, initial_capacity=capacity, key=jax.random.key(0), max_hotness=hotness,
                              opt_params=JOptParams(JOpt.SGD, lr=0.5), **kw)
    tv = sok.DynamicVariable(dimension=8, initial_capacity=capacity, key=0, max_hotness=hotness,
                             opt_params=OptParams(Optimizer_t.SGD, lr=0.5), **kw, **SETTINGS)
    g = tv.engine.ec.plan.groups[0].name
    jv.tables[g] = jax.numpy.zeros_like(jv.tables[g])
    tv.tables[g].zero_()
    return jv, tv, g


def _same_store(jv, tv, g):
    np.testing.assert_array_equal(tv.tables[f"{g}#keys"].numpy(), np.asarray(jv.tables[f"{g}#keys"]))
    rows = tv.tables[f"{g}#keys"].numpy() != 2**31 - 1
    np.testing.assert_allclose(tv.tables[g].numpy()[rows], np.asarray(jv.tables[g])[rows], **TOL)


def test_dynamic_variable_full_lifecycle(mesh1):
    """tests/test_sok.py:162: size and capacity, a first lookup that misses,
    insert on the update, evict, `reserve` to 4x; the stores equal JAX's
    after each, the rows of the surviving keys bitwise through the growth."""
    jv, tv, g = _dyn_pair(mesh1, hotness=2)
    assert tv.capacity == 32 and tv.size == 0
    keys = np.array([[1000001, 7], [42, -1]], dtype=np.int32)
    np.testing.assert_array_equal(tv.lookup(keys).numpy(), 0.0)
    for v in (jv, tv):
        v.apply_gradients(keys, np.ones((2, 8), np.float32), lr=0.5)
    _same_store(jv, tv, g)
    assert tv.size == jv.size == 3
    out = tv.lookup(keys).numpy()
    assert np.abs(out).sum() > 0
    for v in (jv, tv):
        v.evict(np.array([42]))
    _same_store(jv, tv, g)
    assert tv.size == 2
    for v in (jv, tv):
        v.reserve(128)
    g2 = tv.engine.ec.plan.groups[0].name
    np.testing.assert_array_equal(tv.tables[f"{g2}#keys"].numpy(), np.asarray(jv.tables[f"{g2}#keys"]))
    assert tv.capacity == 128 and tv.size == 2
    np.testing.assert_array_equal(tv.lookup(keys).numpy()[0], out[0])


def test_dynamic_variable_hkv_host_spill():
    """tests/test_sok.py:188: backend="hkv": 90 keys over a 64-row working
    set spill to the host master and stage back with their rows bitwise; a
    second update accumulates; evict clears both tiers; a freed master row
    is never reused for a live key; a batch that crosses the watermark keeps
    its resident keys' rows."""
    sok.init(CPU)
    v = sok.DynamicVariable(dimension=4, initial_capacity=64, key=1, backend="hkv", spill_watermark=0.5,
                            opt_params=OptParams(Optimizer_t.SGD, lr=1.0), **SETTINGS)
    waves = [np.arange(w * 30, (w + 1) * 30, dtype=np.int32) for w in range(3)]
    trained = []
    for w, ks in enumerate(waves):
        keys = ks.reshape(-1, 1)
        v.lookup(keys)
        v.apply_gradients(keys, np.full((30, 4), float(w + 1), np.float32), lr=1.0)
        trained.append(v.lookup(keys).numpy().copy())
    assert v.total_size == 90 and v.host_size > 0
    for w, ks in enumerate(waves):
        np.testing.assert_array_equal(v.lookup(ks.reshape(-1, 1)).numpy(), trained[w])
    v.apply_gradients(waves[0].reshape(-1, 1), np.ones((30, 4), np.float32), lr=1.0)
    np.testing.assert_allclose(v.lookup(waves[0].reshape(-1, 1)).numpy(), trained[0] - 1.0, rtol=1e-6)
    v.evict(np.array([0, 1, 2]))
    assert v.total_size == 87
    merged = v.export_merged()
    assert len(merged) == 87 and 0 not in merged
    before = {k: np.array(val) for k, val in v.export_merged().items()}
    ks4 = np.arange(100, 130, dtype=np.int32).reshape(-1, 1)
    v.lookup(ks4)
    v.apply_gradients(ks4, np.full((30, 4), 7.0, np.float32), lr=1.0)
    after = v.export_merged()
    assert v.total_size == 117
    for k, val in before.items():
        np.testing.assert_array_equal(after[k], val, err_msg=f"key {k}")
    resident = ks4[:5]
    want = v.lookup(resident).numpy().copy()
    out = v.lookup(np.concatenate([resident, np.arange(500, 560, dtype=np.int32).reshape(-1, 1)])).numpy()
    np.testing.assert_array_equal(out[:5], want)


def test_lookup_sparse_sp_weights(mesh1):
    """tests/test_sok.py:255: `use_sp_weight`: Sum pools sum(w x e), Mean
    divides by sum(w), padding counts nothing, no weights degrade to the
    unweighted combiner; the SGD update of w-scaled cotangents; all against
    JAX's engine."""
    je, jt, te, tt = _engines(mesh1, use_sp_weight=True)
    rng = np.random.default_rng(3)
    k0, k1 = _keys(rng)
    w0 = rng.uniform(0.1, 2.0, (16, 3)).astype(np.float32)
    w1 = rng.uniform(0.1, 2.0, (16, 2)).astype(np.float32)
    for ws in ([w0, w1], None):
        jo = jsok.lookup_sparse(je, jt, [k0, k1], sp_weights=ws)
        to = sok.lookup_sparse(te, tt, [k0, k1], sp_weights=ws)
        for a, b in zip(to, jo):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD_TOL)
    with pytest.raises(ValueError):
        _engines(mesh1)[2].lookup(tt, [k0, k1], sp_weights=[w0, w1])
    d = [rng.normal(size=(16, 8)).astype(np.float32) for _ in range(2)]
    js, ts = je.init_optimizer(jt), te.init_optimizer(tt)
    jt, _ = je.apply_gradients(jt, js, [k0, k1], d, lr=0.1, step=1, sp_weights=[w0, w1])
    te.apply_gradients(tt, ts, [k0, k1], d, lr=0.1, step=1, sp_weights=[w0, w1])
    for n in ("a", "b"):
        np.testing.assert_allclose(te.ec.export_table(tt, n), je.ec.export_table(jt, n), **TOL, err_msg=n)


def test_dynamic_variable_to_static_roundtrip(mesh1):
    """tests/test_sok.py:347: to_static snapshots trained rows (an unseen
    key reads 0), static mode refuses lookups and updates, assign then
    to_dynamic writes back (inserting the unseen key); stores equal JAX's."""
    jv, tv, g = _dyn_pair(mesh1, capacity=64)
    keys = np.array([5, 900001, 13], dtype=np.int64)
    for v in (jv, tv):
        v.apply_gradients(keys.astype(np.int32).reshape(-1, 1), np.ones((3, 8), np.float32), lr=1.0)
    before = tv.lookup(keys.astype(np.int32).reshape(-1, 1)).numpy().copy()
    probe = np.array([5, 900001, 13, 777], dtype=np.int64)
    buf, jbuf = tv.to_static(probe), jv.to_static(probe)
    np.testing.assert_allclose(buf, np.asarray(jbuf), **TOL)
    np.testing.assert_array_equal(buf[:3], before)
    np.testing.assert_array_equal(buf[3], 0.0)
    assert tv.is_static()
    with pytest.raises(RuntimeError):
        tv.lookup(keys.astype(np.int32).reshape(-1, 1))
    with pytest.raises(RuntimeError):
        tv.apply_gradients(keys.astype(np.int32).reshape(-1, 1), np.ones((3, 8), np.float32), lr=1.0)
    with pytest.raises(RuntimeError):
        tv.to_static(keys)
    tv.assign(buf + 2.0)
    jv.assign(np.asarray(jbuf) + 2.0)
    for v in (jv, tv):
        v.to_dynamic()
    assert not tv.is_static()
    with pytest.raises(RuntimeError):
        tv.to_dynamic()
    _same_store(jv, tv, g)
    after = tv.lookup(np.array([[5], [900001], [13], [777]], np.int32)).numpy()
    np.testing.assert_array_equal(after[:3], before + 2.0)
    np.testing.assert_array_equal(after[3], np.full(8, 2.0, np.float32))
    assert tv.size == 4


def test_sok_export_assign_roundtrip(mesh1):
    """tests/test_sok.py:405: `assign` then `export` give the rows back
    bitwise, and the store equals JAX's after the same assign."""
    jv, tv, g = _dyn_pair(mesh1, capacity=64)
    keys = np.asarray([3, 77, 1000, 2**31 - 1], np.int64)
    vals = np.arange(16, dtype=np.float32).reshape(4, 4).repeat(2, axis=1)
    sok.assign(tv, keys, vals)
    jsok.assign(jv, keys, vals)
    _same_store(jv, tv, g)
    out_k, out_v = sok.export(tv)
    got = {int(k): out_v[i] for i, k in enumerate(out_k)}
    assert sorted(got) == sorted([3, 77, 1000, 2**31 - 2])  # the reserved key folds
    for i, k in enumerate([3, 77, 1000, 2**31 - 2]):
        np.testing.assert_array_equal(got[k], vals[i])


def test_sparse_read_and_evict():
    """tests/test_sok.py:420: hkv reads the rows, then moves them to the
    host master; the det backend refuses."""
    sok.init(CPU)
    v = sok.DynamicVariable(dimension=4, initial_capacity=32, name="sre_var", backend="hkv", **SETTINGS)
    keys = np.asarray([5, 9], np.int64)
    vals = np.asarray([[1, 1, 1, 1], [2, 2, 2, 2]], np.float32)
    sok.assign(v, keys, vals)
    np.testing.assert_array_equal(sok.sparse_read_and_evict(v, keys), vals)
    assert not set(keys.tolist()) & set(v._device_resident().tolist())
    assert set(keys.tolist()) <= set(v._host_index)
    det = sok.DynamicVariable(dimension=4, initial_capacity=32, name="det_var", **SETTINGS)
    with pytest.raises(TypeError):
        sok.sparse_read_and_evict(det, keys)
    with pytest.raises(TypeError):
        sok.export(sok.Variable(8, 4))


def test_sok_sgd_overrides_variable_optimizer():
    """tests/test_sok.py:440 and :455: `sok.SGD` scatter-subtracts lr x g on
    (values, indices) gradients, even on an Adam variable; a dense gradient
    updates every row; `filter_variables` sorts sok's objects out."""
    sok.init(CPU)
    v = sok.Variable(16, 4, name="adam_var", opt_params=OptParams(Optimizer_t.Adam, lr=0.5, beta1=0.9, beta2=0.999),
                     **SETTINGS)
    before = v.to_numpy().copy()
    keys = np.asarray([1, 5], np.int32)
    sok.SGD(lr=0.2).apply_gradients([((np.full((2, 4), 0.25, np.float32), keys), v)])
    after = v.to_numpy()
    np.testing.assert_allclose(after[[1, 5]], before[[1, 5]] - 0.2 * 0.25, rtol=1e-6)
    np.testing.assert_array_equal(np.delete(after, [1, 5], 0), np.delete(before, [1, 5], 0))
    v2 = sok.Variable(8, 4, name="dense_grad_var", **SETTINGS)
    b2 = v2.to_numpy().copy()
    sok.SGD(lr=0.1).apply_gradients([(np.full((8, 4), 1.0, np.float32), v2)])
    np.testing.assert_allclose(v2.to_numpy(), b2 - 0.1, rtol=1e-6)
    mine, others = sok.filter_variables([v, torch.zeros(2), v2.engine, "x"])
    assert mine == [v, v2.engine] and len(others) == 2
