"""The host tiers under a table, against the JAX package: the host-spill tier
of a dynamic table (`HostSpillTier`, tests/test_host_spill.py's cases) and
the embedding training cache (`EmbeddingTrainingCache`,
tests/test_training_cache.py's). Each case runs the JAX model and the port's
model from one carried state (`tools/carry.py`) through the same staging,
spills and steps.

Exact: the device key stores (bitwise after every staging, spill and step;
both packages place keys by the same host probe and the same scatter-min
insert), which keys the master holds, and each tier's own round trips
(a row spilled and staged back keeps its values and AdaGrad state bit for
bit, in either package). Within rtol 1e-4 / atol 1e-5: rows and state
against JAX's after steps (sums in another order), and the master's rows.
"""
import jax
import numpy as np
import pytest
import torch

import hugectr_tpu as jh
from hugectr_tpu.core.types import DataReaderType_t as JDRT
from hugectr_tpu.embedding.host_spill import HostSpillTier as JTier
from hugectr_tpu.embedding.training_cache import EmbeddingTrainingCache as JETC

import hugectr_tpu_torch as th
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.embedding.host_spill import HostSpillTier, _NpMap
from hugectr_tpu_torch.embedding.training_cache import EmbeddingTrainingCache
from hugectr_tpu_torch.tools import carry

torch.set_num_threads(1)
CPU = ResourceManager.create(device="cpu")
TOL = dict(rtol=1e-4, atol=1e-5)


def _model(h, rm, capacity=32, opt="adagrad", static=False, batch=8):
    """tests/test_host_spill.py:15's model in package `h` (a dynamic table
    of `capacity` rows, AdaGrad from 0, Concat + InnerProduct with no
    activation, BCE), or tests/test_training_cache.py:15's (`static`: a
    64-row table, SGD)."""
    kw = {"onehot_vocab": 0} if h is th else {}
    solver = h.CreateSolver(max_eval_batches=1, batchsize_eval=batch, batchsize=batch, lr=0.2 if not static else 0.1,
                            repeat_dataset=True, **kw)
    drt = JDRT.Synthetic if h is jh else th.DataReaderType_t.Synthetic
    reader = h.DataReaderParams(data_reader_type=drt, synthetic_num_batches=2)
    o = h.CreateOptimizer(optimizer_type=h.Optimizer_t.SGD) if opt == "sgd" else \
        h.CreateOptimizer(optimizer_type=h.Optimizer_t.AdaGrad, initial_accu_value=0.0)
    model = h.Model(solver, reader, o, resource_manager=rm)
    model.add(h.Input(label_dim=1, label_name="label", dense_dim=2, dense_name="dense",
                      data_reader_sparse_param_array=[h.DataReaderSparseParam("d0", 2, True, 1)]))
    t = (h.EmbeddingTableConfig(name="huge", max_vocabulary_size=capacity, ev_size=8) if static else
         h.EmbeddingTableConfig(name="dyn", max_vocabulary_size=-1, ev_size=8, dynamic_capacity=capacity))
    ebc = h.EmbeddingCollectionConfig()
    ebc.embedding_lookup([t], ["d0"], "emb", ["sum"])
    ebc.shard(shard_matrix=[[t.name]], shard_strategy=[("mp", [t.name])])
    model.add(ebc)
    bottom = "emb"
    if not static:
        model.add(h.DenseLayer(layer_type=h.Layer_t.Concat, bottom_names=["emb", "dense"], top_names=["c"]))
        bottom = "c"
    model.add(h.DenseLayer(layer_type=h.Layer_t.InnerProduct, bottom_names=[bottom], top_names=["out"], num_output=1,
                           act_type=h.Activation_t.Non))
    model.add(h.DenseLayer(layer_type=h.Layer_t.BinaryCrossEntropyLoss, bottom_names=["out", "label"],
                           top_names=["loss"]))
    model.compile()
    return model


class Pair:
    """The JAX model and the port's, the port's state carried from JAX's."""

    def __init__(self, mesh1, **kw):
        self.jm = _model(jh, mesh1, **kw)
        self.tm = _model(th, CPU, **kw)
        carry.load_jax_state(self.tm, jax.device_get(self.jm.state))
        self.jm.start_data_reading()
        self.tm.start_data_reading()

    def train(self, keys, labels=None, b=8):
        batch = {"label": np.random.default_rng(0).random((b, 1)).round().astype(np.float32)
                 if labels is None else labels,
                 "dense": np.zeros((b, 2), np.float32), "d0": np.asarray(keys, np.int32).reshape(b, 2)}
        self.jm._rng, sub = jax.random.split(self.jm._rng)
        self.jm.state, jloss = self.jm._train_step(self.jm.state, self.jm._put_batch(dict(batch)), sub)
        tloss = self.tm.train_step(self.tm._put_now(dict(batch)))
        assert np.isfinite(float(tloss))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
        self.check()

    def check(self):
        """Stores bitwise; the rows and state of the stored keys."""
        for gname, t in self.tm.tables.items():
            j = np.asarray(self.jm.state["emb_tables"][gname])
            if gname.endswith("#keys"):
                np.testing.assert_array_equal(t.numpy(), j, err_msg=gname)
                continue
            ks = self.tm.tables.get(f"{gname}#keys")
            rows = ks.numpy() != 2**31 - 1 if ks is not None else slice(None)
            np.testing.assert_allclose(t.numpy()[rows], j[rows], **TOL, err_msg=gname)
            for k, v in self.tm.eopt.get(gname, {}).items():
                np.testing.assert_allclose(v.numpy()[rows], np.asarray(self.jm.state["eopt"][gname][k])[rows],
                                           **TOL, err_msg=f"{gname} {k}")

    def close(self):
        self.tm._close_readers()


def _device_row(model, key):
    """(row, AdaGrad accumulator) of `key` in the port model's device
    working set, (None, None) if it is not there."""
    ec = model.ec
    g, ti = ec._find_table("dyn")
    slot = ec._dynamic_host_slots(ec._host_key_store(model.tables, g), g, ti, np.asarray([key]))[0]
    if slot < 0:
        return None, None
    return model.tables[g.name][slot].clone().numpy(), model.eopt[g.name]["accum"][slot].clone().numpy()


def _tiers(p, **kw):
    return JTier(p.jm, "dyn", **kw), HostSpillTier(p.tm, "dyn", **kw)


def _stage(p, tiers, keys):
    """Both tiers stage `keys`: the same count, the same stores."""
    n = [t.stage_batch(keys) for t in tiers]
    assert n[0] == n[1]
    p.check()
    return n[1]


def _masters_agree(tiers, keys):
    jt, tt = tiers
    assert jt.host_size == tt.host_size
    for k in keys:
        a, b = jt.lookup_host(int(k)), tt.lookup_host(int(k))
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b, a, **TOL)


def test_spill_and_stage_back_roundtrip(mesh1):
    """tests/test_host_spill.py:77: a full flush to the master, another
    working set trained, then key 3 staged back with its value and AdaGrad
    state bitwise (the port's own round trip), in step with JAX."""
    p = Pair(mesh1)
    tiers = _tiers(p, spill_watermark=0.75)
    keys_a = np.arange(16)
    _stage(p, tiers, keys_a)
    p.train(keys_a)
    vec3, acc3 = _device_row(p.tm, 3)
    assert vec3 is not None and np.abs(vec3).sum() > 0 and acc3.sum() > 0
    assert [t.spill(evict_frac=1.0) for t in tiers] == [16, 16]
    p.check()
    assert tiers[1].host_size == 16 and _device_row(p.tm, 3)[0] is None
    np.testing.assert_array_equal(tiers[1].lookup_host(3), vec3)
    keys_b = np.arange(100, 116)
    _stage(p, tiers, keys_b)
    p.train(keys_b)
    assert _device_row(p.tm, 3)[0] is None
    assert _stage(p, tiers, np.asarray([3] * 16)) == 1
    vec3b, acc3b = _device_row(p.tm, 3)
    np.testing.assert_array_equal(vec3b, vec3)
    np.testing.assert_array_equal(acc3b, acc3)
    _masters_agree(tiers, range(120))
    p.close()


def test_watermark_auto_spill(mesh1):
    """tests/test_host_spill.py:112: at watermark 0.5 of 32 rows the earlier
    working sets spill to the master; every trained key stays on the device
    or in the master, an untouched one with the value it was spilled with."""
    p = Pair(mesh1)
    tiers = _tiers(p, spill_watermark=0.5)
    seen = {}
    for lo in (0, 16, 32, 48):
        keys = np.arange(lo, lo + 16)
        _stage(p, tiers, keys)
        p.train(keys)
        seen[lo] = _device_row(p.tm, lo)[0]
    assert tiers[1].host_size >= 16
    for lo, vec in seen.items():
        dv, _ = _device_row(p.tm, lo)
        hv = tiers[1].lookup_host(lo)
        assert dv is not None or hv is not None
        if dv is None:
            np.testing.assert_array_equal(hv, vec)
    _masters_agree(tiers, range(64))
    p.close()


def test_static_table_rejected(mesh1):
    """tests/test_host_spill.py:133: an unknown table raises KeyError; a
    static table raises ValueError (the tier needs the key store)."""
    tm = _model(th, CPU)
    with pytest.raises(KeyError):
        HostSpillTier(tm, "nope")
    st = _model(th, CPU, static=True, opt="sgd", batch=32, capacity=64)
    with pytest.raises(ValueError, match="not a dynamic table"):
        HostSpillTier(st, "huge")


def test_lru_eviction_keeps_hot_keys(mesh1):
    """tests/test_host_spill.py:139: keys in every batch survive an LRU
    spill of half the working set on the device."""
    p = Pair(mesh1, capacity=64)
    tiers = _tiers(p, spill_watermark=0.9, evict_frac=0.5)
    hot = np.arange(8)
    for lo in (8, 16, 24, 32):
        keys = np.concatenate([hot, np.arange(lo, lo + 8)])
        _stage(p, tiers, keys)
        p.train(keys)
    evicted = [t.spill() for t in tiers]
    assert evicted[0] == evicted[1] > 0
    p.check()
    for k in hot:
        assert _device_row(p.tm, int(k))[0] is not None, f"hot key {k} was evicted before cold keys"
    p.close()


def test_steady_state_no_device_readback(mesh1, monkeypatch):
    """tests/test_host_spill.py:158: staging fresh keys below the watermark
    reads nothing back from the device: neither the resident keys nor the
    key store."""
    p = Pair(mesh1, capacity=256)
    tier = HostSpillTier(p.tm, "dyn", spill_watermark=0.9, resync_interval=10**9)
    calls = {"resident": 0, "store": 0}
    orig_res, orig_store = tier._device_resident, p.tm.ec._host_key_store

    def resident():
        calls["resident"] += 1
        return orig_res()

    def store(*a):
        calls["store"] += 1
        return orig_store(*a)

    monkeypatch.setattr(tier, "_device_resident", resident)
    monkeypatch.setattr(p.tm.ec, "_host_key_store", store)
    for t in range(6):
        keys = np.arange(t * 16, t * 16 + 16)
        tier.stage_batch(keys)
        p.tm.train_step(p.tm._put_now({"label": np.ones((8, 1), np.float32), "dense": np.zeros((8, 2), np.float32),
                                       "d0": keys.reshape(8, 2).astype(np.int32)}))
    assert calls == {"resident": 0, "store": 0}, f"steady-state staging read the device back: {calls}"
    p.close()


def test_vocab_4x_working_set_trains(mesh1):
    """tests/test_host_spill.py:182: 40 batches over a vocabulary 4x the
    working set, spilling as they go: most keys are touched, none lost, the
    master outgrows the working set, in step with JAX."""
    rng = np.random.default_rng(3)
    p = Pair(mesh1, capacity=64)
    tiers = _tiers(p, spill_watermark=0.75)
    vocab = 256
    for _ in range(40):
        keys = rng.integers(0, vocab, 16)
        _stage(p, tiers, keys)
        p.train(keys)
    touched = sum(_device_row(p.tm, k)[0] is not None or tiers[1].lookup_host(k) is not None for k in range(vocab))
    assert touched > vocab // 2 and tiers[1].host_size > 64
    _masters_agree(tiers, range(vocab))
    p.close()


def test_npmap_matches_jax():
    """The master's key -> row map (host_spill.py:72): the same rows as the
    JAX package's for the same upserts, through growth past 0.7 full."""
    from hugectr_tpu.embedding.host_spill import _NpMap as JMap

    rng = np.random.default_rng(4)
    a, b = _NpMap(), JMap()
    na = nb = 0
    for _ in range(5):
        keys = rng.integers(-5, 3000, 1500)
        keys = keys[keys >= 0]
        ra, na = a.upsert(keys, na)
        rb, nb = b.upsert(keys, nb)
        np.testing.assert_array_equal(ra, rb)
    assert a.size == b.size and na == nb
    probe = np.arange(4000)
    np.testing.assert_array_equal(a.get(probe), b.get(probe))


def _etc_pair(mesh1):
    jm = _model(jh, mesh1, static=True, opt="sgd", batch=32, capacity=64)
    tm = _model(th, CPU, static=True, opt="sgd", batch=32, capacity=64)
    carry.load_jax_state(tm, jax.device_get(jm.state))
    return jm, tm


def test_etc_pass_roundtrip(mesh1):
    """tests/test_training_cache.py:10: a pass stages rows of a 10,000-row
    master into the 64-row table, maps keys to staged rows, trains a step,
    flushes: touched master rows changed, others bitwise unchanged, the
    incremental model the pass's keys; the next pass restages. The master
    after the step agrees with JAX's."""
    jm, tm = _etc_pair(mesh1)
    host = np.random.default_rng(0).normal(size=(10_000, 8)).astype(np.float32)
    before = host.copy()
    jhost = host.copy()
    etc, jetc = EmbeddingTrainingCache(tm, "huge", host), JETC(jm, "huge", jhost)
    keyset = np.arange(9000, 9050)
    etc.update(keyset)
    jetc.update(keyset)
    np.testing.assert_array_equal(tm.ec.export_table(tm.tables, "huge")[:50], host[9000:9050])
    raw = np.array([[9000, 9049], [9010, 12345]], np.int64)
    assert etc.map_keys(raw).tolist() == jetc.map_keys(raw).tolist() == [[0, 49], [10, -1]]
    batch = {"label": np.ones((32, 1), np.float32), "dense": np.zeros((32, 2), np.float32),
             "d0": np.tile(etc.map_keys(raw)[:1], (32, 1)).astype(np.int32)}
    tm.start_data_reading()
    jm.start_data_reading()
    tloss = tm.train_step(tm._put_now(dict(batch)))
    jm._rng, sub = jax.random.split(jm._rng)
    jm.state, jloss = jm._train_step(jm.state, jm._put_batch(dict(batch)), sub)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    etc.flush()
    jetc.flush()
    assert not np.allclose(host[9000], before[9000])
    np.testing.assert_array_equal(host[0], before[0])
    np.testing.assert_array_equal(host[9020], before[9020])
    np.testing.assert_allclose(host, jhost, **TOL)
    assert etc.get_incremental_model()["keys"].tolist() == keyset.tolist()
    etc.update(np.arange(100, 120))
    np.testing.assert_array_equal(tm.ec.export_table(tm.tables, "huge")[:20], host[100:120])
    tm._close_readers()


def test_etc_capacity_guard():
    """tests/test_training_cache.py:112: a keyset larger than the staging
    table raises."""
    tm = _model(th, CPU, static=True, opt="sgd", batch=32, capacity=4)
    etc = EmbeddingTrainingCache(tm, "huge", np.zeros((100, 8), np.float32))
    with pytest.raises(ValueError, match="exceeds staging capacity"):
        etc.update(np.arange(10))
    with pytest.raises(ValueError, match="ev"):
        EmbeddingTrainingCache(tm, "huge", np.zeros((100, 4), np.float32))


def test_etc_stages_optimizer_state(mesh1, tmp_path):
    """The master's AdaGrad state rides with its rows: staged beside them,
    trained, flushed back, and `dump` writes the master. The JAX package's
    cache cannot stage state (it writes into `np.asarray` of a device array,
    which is read-only: ValueError, ROADMAP Queue 3), so its model gets the
    same staged state by hand, and the flushed rows and state are held
    against its table and state after the same step."""
    import jax.numpy as jnp

    jm = _model(jh, mesh1, static=True, opt="adagrad", batch=32, capacity=64)
    tm = _model(th, CPU, static=True, opt="adagrad", batch=32, capacity=64)
    carry.load_jax_state(tm, jax.device_get(jm.state))
    rng = np.random.default_rng(1)
    host = rng.normal(size=(500, 8)).astype(np.float32)
    acc = rng.random((500, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="read-only"):
        JETC(jm, "huge", host.copy(), {"accum": acc.copy()}).update(np.arange(200, 240))
    jhost = host.copy()
    etc = EmbeddingTrainingCache(tm, "huge", host, {"accum": acc})
    jetc = JETC(jm, "huge", jhost)
    keys = np.arange(200, 240)
    etc.update(keys)
    jetc.update(keys)
    g = tm.ec._find_table("huge")[0].name
    staged = np.zeros((64, 8), np.float32)
    staged[:40] = acc[200:240]
    np.testing.assert_array_equal(tm.ec.export_table({g: tm.eopt[g]["accum"]}, "huge"), staged)
    jm.state["eopt"][g]["accum"] = jnp.asarray(staged)  # one shard: storage row = key
    batch = {"label": np.ones((32, 1), np.float32), "dense": np.zeros((32, 2), np.float32),
             "d0": etc.map_keys(rng.integers(190, 250, (32, 2))).astype(np.int32)}
    tm.start_data_reading()
    jm.start_data_reading()
    tm.train_step(tm._put_now(dict(batch)))
    jm._rng, sub = jax.random.split(jm._rng)
    jm.state, _ = jm._train_step(jm.state, jm._put_batch(dict(batch)), sub)
    before = acc.copy()
    etc.dump(str(tmp_path / "t.npy"))
    jetc.flush()
    np.testing.assert_allclose(acc[200:240], np.asarray(jm.state["eopt"][g]["accum"])[:40], **TOL)
    np.testing.assert_allclose(host, jhost, **TOL)
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"), host)
    assert (acc[200:240] >= before[200:240]).all() and (acc[200:240] > before[200:240]).any()
    np.testing.assert_array_equal(acc[:200], before[:200])
    tm._close_readers()
