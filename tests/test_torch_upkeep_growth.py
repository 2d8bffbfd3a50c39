"""`grow_dynamic_capacity` and the host probes it and the host tiers build
on, against the JAX package on one device (tests/test_dynamic_table.py's
growth cases): the collections, harness and tolerances of
tests/test_torch_upkeep.py (`Pair.grow` holds every carried key's row and
state bitwise and the new stores bitwise equal to JAX's)."""
import numpy as np

from hugectr_tpu.core.types import INVALID_KEY
from hugectr_tpu.core.types import Optimizer_t as JOpt
from hugectr_tpu.optim.params import OptParams as JOptParams

from hugectr_tpu_torch.core.types import Optimizer_t as TOpt
from hugectr_tpu_torch.embedding.collection import EMPTY_KEY
from hugectr_tpu_torch.optim.params import OptParams as TOptParams
from test_torch_upkeep import E, Pair, _feats, _grads, _siblings, _single


def test_capacity_growth_preserves_rows(monkeypatch):
    """tests/test_dynamic_table.py:167: growth to 128 rows keeps every key's
    row and state bitwise, the new store bitwise equal to JAX's (keys
    re-inserted one by one in JAX's order), and the grown table keeps
    training."""
    p = Pair(monkeypatch, _single, capacity=32)
    keys = np.array([[1, 2], [3, INVALID_KEY]], np.int32)
    d = np.ones((2, E), np.float32)
    p.step({"f": keys}, {"e": d})
    p.grow("dyn", 128)
    p.check()
    ks = p.tt[f"{p.tec.plan.groups[0].name}#keys"].numpy()
    assert sorted(ks[ks != EMPTY_KEY].tolist()) == [1, 2, 3]
    p.step({"f": keys}, {"e": d})


def test_growth_preserves_sibling_tables(monkeypatch):
    """tests/test_dynamic_table.py:247: growing one dynamic table keeps the
    other dynamic table's entries and state and the static table's rows and
    state, bitwise; both stores equal JAX's."""
    p = Pair(monkeypatch, _siblings, capacity=32)
    rng = np.random.default_rng(7)
    spec = {"f0": 50, "f1": 50, "f2": 40}
    for _ in range(3):
        p.step(_feats(rng, spec), _grads(rng, ("e0", "e1", "e2")))
    stat = p.tec.export_table(p.tt, "stat")
    p.grow("dyn", 128)
    p.check()
    np.testing.assert_array_equal(p.tec.export_table(p.tt, "stat"), stat)
    p.step(_feats(rng, spec), _grads(rng, ("e0", "e1", "e2")))


def test_growth_of_a_full_store(monkeypatch):
    """A store that dropped keys (more keys than rows): growth to 4x the
    capacity carries the resident keys, and the dropped keys insert in the
    next steps, as in JAX."""
    p = Pair(monkeypatch, _single, capacity=16, opt="rowwise_adagrad")
    rng = np.random.default_rng(8)
    for _ in range(3):
        p.step({"f": rng.integers(0, 200, (16, 2)).astype(np.int32)}, {"e": rng.normal(size=(16, E)).astype(np.float32)})
    full = int((p.tt[f"{p.tec.plan.groups[0].name}#keys"] != EMPTY_KEY).sum())
    assert full >= 14
    p.grow("dyn", 64)
    for _ in range(2):
        p.step({"f": rng.integers(0, 200, (16, 2)).astype(np.int32)}, {"e": rng.normal(size=(16, E)).astype(np.float32)})
    assert int((p.tt[f"{p.tec.plan.groups[0].name}#keys"] != EMPTY_KEY).sum()) > full


def test_host_helpers_match_jax(monkeypatch):
    """The host probes the host-spill tier and SOK build on
    (collection.py:2292-2436): `_dynamic_host_slots` / `_host_find_keys`
    (every probe row, holes too), `_live_slots`, `_host_insert_keys` (a
    resident key keeps its row, duplicates in one call share one, a full
    probe run drops the key) and the fold of the reserved key 2^31 - 1."""
    p = Pair(monkeypatch, _single, capacity=16, opt="sgd")
    rng = np.random.default_rng(9)
    p.step({"f": rng.integers(0, 40, (8, 2)).astype(np.int32)}, {"e": rng.normal(size=(8, E)).astype(np.float32)})
    tg, ti = p.tec._find_table("dyn")
    jg, jti = p.jec._find_table("dyn")
    ks = p.tec._host_key_store(p.tt, tg)
    np.testing.assert_array_equal(ks, p.jec._host_key_store(p.jt, jg))
    probe = np.concatenate([np.arange(-2, 60), [2**31 - 1, 2**31 - 2]]).astype(np.int64)
    np.testing.assert_array_equal(p.tec._dynamic_host_slots(ks, tg, ti, probe),
                                  p.jec._dynamic_host_slots(ks, jg, jti, probe))
    np.testing.assert_array_equal(p.tec._dynamic_host_slots(ks, tg, ti, probe),
                                  p.jec._host_find_keys(ks, jg, jti, probe))
    for a, b in zip(p.tec._live_slots(ks, tg, ti), p.jec._live_slots(ks, jg, jti)):
        np.testing.assert_array_equal(a, b)
    ins = np.concatenate([np.arange(30, 90), [2**31 - 1, 33, 33]]).astype(np.int64)
    tks, jks = ks.copy(), ks.copy()
    np.testing.assert_array_equal(p.tec._host_insert_keys(tks, tg, ti, ins), p.jec._host_insert_keys(jks, jg, jti, ins))
    np.testing.assert_array_equal(tks, jks)
    assert (tks != EMPTY_KEY).sum() == 16  # full: the later keys drop


def test_growth_keeps_a_rebound_optimizer_where_the_reference_drops_it(monkeypatch):
    """A fault of the reference (ROADMAP "Faults of the reference"): SOK
    rebinds a group's optimizer (`OptimizerWrapper(engine, opt)` and
    `sok.SGD` set `ec.group_opt[group]`, hugectr_tpu/sok/__init__.py:616,
    788), and JAX's `grow_dynamic_capacity` builds the new collection from
    the engine's original optimizer without copying `group_opt`
    (collection.py:2566-2600), so the grown table trains with the old
    hyperparameters. The port's grown collection keeps the binding. Both
    bind AdaGrad at lr 0.05 over the collection's lr 0.5 (one state
    layout); after growth JAX's group is back at 0.5, the port's at 0.05."""
    p = Pair(monkeypatch, _single, capacity=32)
    gname = p.tec.plan.groups[0].name
    p.jec.group_opt[gname] = JOptParams(JOpt.AdaGrad, lr=0.05, initial_accu_value=0.0, epsilon=1e-7)
    p.tec.group_opt[gname] = TOptParams(TOpt.AdaGrad, lr=0.05, initial_accu_value=0.0, epsilon=1e-7)
    p.step({"f": np.array([[1, 2], [3, INVALID_KEY]], np.int32)}, {"e": np.ones((2, E), np.float32)})
    p.grow("dyn", 128)
    assert p.jec.group_opt[gname].lr == 0.5  # the reference's fault: the binding is gone
    assert p.tec.group_opt[gname].lr == 0.05 and p.tec.group_opt[gname].optimizer == TOpt.AdaGrad
