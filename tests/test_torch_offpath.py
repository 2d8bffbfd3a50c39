"""The port's off-path modules against the JAX package's: the planner
(`parallel/planner.py`) on the inputs of tests/test_planner.py and
tests/test_docs_walkthrough.py:57-67; the embedding cache
(`cache/embedding_cache.py`) after tests/test_cache.py's operation
sequences and after batches in which one key comes twice and keys of one
set collide, state bitwise equal (tags, values, stamps, clock; the JAX
tags are int32 with x64 off, the port's int64, compared by value); the
static and the host-backed table's answers and hit counts; `diagnose`'s
histogram, samples, dump and non-finite count; the logger's rank-0 rule,
its environment and the timer. Every comparison here is exact.
"""
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugectr_tpu.cache import embedding_cache as jc
from hugectr_tpu.parallel import planner as jp
from hugectr_tpu.utils import diagnose as jd

from hugectr_tpu_torch.cache import embedding_cache as tc
from hugectr_tpu_torch.core import logger as tlog
from hugectr_tpu_torch.parallel import planner as tp
from hugectr_tpu_torch.utils import diagnose as td

torch.set_num_threads(1)


# ---------------------------------------------------------------- planner
PLANS = {
    "round_robin_5x2": ("round_robin_plan", ([f"t{i}" for i in range(5)], 2), {}),
    "uniform_5x3": ("uniform_plan", ([f"t{i}" for i in range(5)], 3), {}),
    "auto_dp_split": ("auto_plan", (["big_hot", "big_cold", "tiny1", "tiny2"], [8e9, 8e9, 1e6, 2e6], [80, 5, 1, 1]),
                      dict(num_devices=4, cost_model="capacity_10e9", dp_threshold_bytes=1e7)),
    **{f"walkthrough_{kind}_{n}": ((f"{kind}_plan",) + (([f"t{i}" for i in range(4)], n), {}) if kind != "auto"
                                   else ("auto_plan", ([f"t{i}" for i in range(4)], [v * 8 * 4 for v in
                                                                                      (200, 96, 130, 50)], [1] * 4),
                                         dict(num_devices=n, dp_threshold_bytes=100 * 8 * 4)))
       for kind in ("round_robin", "uniform", "auto") for n in (1, 2, 4, 8)},
}


@pytest.mark.parametrize("case", list(PLANS))
def test_planner_matches_jax(case):
    fn, args, kw = PLANS[case]
    outs = []
    for mod in (jp, tp):
        k = dict(kw)
        if k.get("cost_model") == "capacity_10e9":
            k["cost_model"] = mod.PlannerCostModel(mem_capacity_bytes=10e9)
        outs.append(getattr(mod, fn)(*args, **k))
    assert outs[1] == outs[0]


def test_planner_oom_raises_as_jax():
    for mod in (jp, tp):
        with pytest.raises(MemoryError):
            mod.auto_plan(["huge"], [100e9], [10], num_devices=2,
                          cost_model=mod.PlannerCostModel(mem_capacity_bytes=1e9))


# ------------------------------------------------------------------ cache
def _same_state(t, j, what):
    np.testing.assert_array_equal(t["tags"].numpy(), np.asarray(j["tags"]).astype(np.int64), err_msg=f"{what} tags")
    np.testing.assert_array_equal(t["values"].numpy(), np.asarray(j["values"]), err_msg=f"{what} values")
    np.testing.assert_array_equal(t["stamps"].numpy(), np.asarray(j["stamps"]), err_msg=f"{what} stamps")
    assert int(t["clock"]) == int(j["clock"]), what


class CachePair:
    def __init__(self, num_sets, ways, ev):
        self.j = jc.EmbeddingCache(num_sets=num_sets, ways=ways, ev=ev)
        self.t = tc.EmbeddingCache(num_sets, ways, ev, device="cpu")
        self.js, self.ts = self.j.init(), self.t.init()
        _same_state(self.ts, self.js, "init")
        self.n = 0

    def op(self, name, keys, values=None):
        self.n += 1
        k = np.asarray(keys, np.int64)
        if name == "query":
            jv, jh, self.js = self.j.query(self.js, jnp.asarray(k))
            tv, th_, self.ts = self.t.query(self.ts, torch.from_numpy(k))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
            np.testing.assert_array_equal(th_.numpy(), np.asarray(jh))
        else:
            v = np.asarray(values, np.float32)
            self.js = getattr(self.j, name)(self.js, jnp.asarray(k), jnp.asarray(v))
            self.ts = getattr(self.t, name)(self.ts, torch.from_numpy(k), torch.from_numpy(v))
        _same_state(self.ts, self.js, f"op {self.n} {name}")


def _rows(keys, ev, scale=1.0):
    return np.stack([np.full(ev, float(k) * scale, np.float32) + np.arange(ev) for k in keys])


def test_cache_sequences_of_the_reference_tests():
    """tests/test_cache.py's query / replace / update sequence and its LRU
    eviction order, state after every call bitwise the JAX package's."""
    p = CachePair(16, 2, 4)
    p.op("query", [5, 9, 5])
    p.op("replace", [5, 9], _rows([5, 9], 4))
    p.op("query", [5, 9, 5])
    p.op("update", [5, 777], _rows([50, 7], 4))
    p.op("query", [5, 777])
    q = CachePair(1, 2, 2)
    for k in (11, 22):
        q.op("replace", [k], _rows([k], 2))
    q.op("query", [11])
    q.op("replace", [33], _rows([33], 2))
    for k in (11, 22, 33):
        q.op("query", [k])


@pytest.mark.parametrize("num_sets,ways", [(1, 2), (2, 4), (16, 2)])
def test_cache_batches_with_duplicates_and_collisions(num_sets, ways):
    """One `replace` batch that holds a key twice (other values) and more
    keys of a set than it has ways, an `update` with a repeated key and a
    miss, and queries between: the state bitwise JAX's (the last writer of
    a (set, way) in the batch wins, as XLA's scatter on the CPU leaves it)."""
    rng = np.random.default_rng(num_sets * 10 + ways)
    p = CachePair(num_sets, ways, 3)
    for _ in range(4):
        keys = rng.integers(0, 40, 12)
        keys[3] = keys[7]  # one key twice, with other values
        p.op("replace", keys, rng.normal(size=(12, 3)))
        p.op("query", rng.integers(0, 40, 9))
        upd = np.concatenate([keys[:3], keys[:1], [1000]])
        p.op("update", upd, rng.normal(size=(len(upd), 3)))
        p.op("query", keys)


def test_static_and_uvm_tables_match_jax():
    """StaticTable's probes and UvmTable's answers, hit and miss counts and
    cache state against the JAX package's, through tests/test_cache.py's
    sequence (write-through update included)."""
    rng = np.random.default_rng(0)
    keys = rng.choice(10_000, 500, replace=False).astype(np.int64)
    vals = rng.normal(size=(500, 8)).astype(np.float32)
    js, ts = jc.StaticTable(keys, vals), tc.StaticTable(keys, vals, device="cpu")
    assert (ts.capacity, ts.max_probe) == (js.capacity, js.max_probe)
    np.testing.assert_array_equal(ts.keys.numpy(), np.asarray(js.keys).astype(np.int64))
    q = np.concatenate([keys[:100], np.asarray([99999, 88888])])
    (jo, jf), (to, tf) = js.lookup(jnp.asarray(q)), ts.lookup(q)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    ukeys = np.arange(0, 10_000, 2, dtype=np.int64)
    uvals = rng.normal(size=(len(ukeys), 8)).astype(np.float32)
    ju = jc.UvmTable(ukeys, uvals, cache_capacity=256, ways=4)
    tu = tc.UvmTable(ukeys, uvals, cache_capacity=256, ways=4, device="cpu")
    for call, args in [("query", (np.array([0, 2, 4, 998, 3]),)), ("query", (np.array([0, 2, 4, 998]),)),
                       ("update", (np.array([2]), np.full((1, 8), 7.0, np.float32))),
                       ("query", (np.array([2]),)), ("query", (np.arange(0, 4000, 2),))]:
        jr, tr = getattr(ju, call)(*args), getattr(tu, call)(*args)
        if call == "query":
            for a, b in zip(tr, jr):
                np.testing.assert_array_equal(a, b)
        assert (tu.hits, tu.misses) == (ju.hits, ju.misses)
        _same_state(tu.state, ju.state, call)


def test_cache_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.EmbeddingCache(4, 2, 2)


# --------------------------------------------------------------- diagnose
def test_diagnose_matches_jax(tmp_path, caplog):
    """histogram's text, sample's values and dump's file equal the JAX
    package's for a tensor with non-finite values; count_nonfinite over a
    dict and list of tensors (bf16 and int ones too)."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(6, 5)).astype(np.float32)
    a[0, 0], a[1, 1] = np.nan, np.inf
    assert td.histogram("x", torch.from_numpy(a), bins=7) == jd.histogram("x", a, bins=7)
    assert td.histogram("nan", torch.full((3,), float("nan"))) == jd.histogram("nan", np.full(3, np.nan))
    np.testing.assert_array_equal(td.sample("x", torch.from_numpy(a), 7), jd.sample("x", a, 7))
    td.dump(str(tmp_path / "t.npy"), torch.from_numpy(a))
    jd.dump(str(tmp_path / "j.npy"), a)
    assert (tmp_path / "t.npy").read_bytes() == (tmp_path / "j.npy").read_bytes()
    tree = {"a": torch.from_numpy(a), "b": [torch.tensor([1.0, float("-inf")], dtype=torch.bfloat16),
                                          torch.tensor([1, 2])]}
    jtree = {"a": a, "b": [np.array([1.0, -np.inf], np.float32), np.array([1, 2])]}
    assert td.count_nonfinite(tree) == jd.count_nonfinite(jtree) == 3


# ----------------------------------------------------------------- logger
def test_logger_rank0_env_and_timer(tmp_path, monkeypatch):
    """HCTR_TPU_LOG_LEVEL and HCTR_TPU_LOG_TO_FILE configure the logger
    when it is first made, as in the JAX package; `info`, `warning` and
    `debug` log on rank 0 only; the timer sums its intervals."""
    logger = logging.getLogger("hugectr_tpu_torch")
    saved = (logger.handlers[:], logger.level)
    logger.handlers.clear()
    monkeypatch.setenv("HCTR_TPU_LOG_LEVEL", "warning")
    monkeypatch.setenv("HCTR_TPU_LOG_TO_FILE", str(tmp_path / "log.txt"))
    try:
        lg = tlog.get_logger()
        assert lg.level == logging.WARNING and isinstance(lg.handlers[0], logging.FileHandler)
        tlog.info("hidden %d", 1)
        tlog.warning("shown %d", 2)
        monkeypatch.setattr(tlog, "_process_index", lambda: 1)
        tlog.warning("rank 1 says nothing")
        lg.handlers[0].flush()
        text = (tmp_path / "log.txt").read_text()
        assert "shown 2" in text and "hidden" not in text and "rank 1" not in text
    finally:
        for h in logger.handlers:
            h.close()
        logger.handlers[:] = saved[0]
        logger.setLevel(saved[1])
    t = tlog.Timer().start()
    assert t.elapsed_seconds() >= 0.0
    t.stop()
    first = t.elapsed_seconds()
    t.start().stop()
    assert t.elapsed_seconds() >= first
    t.reset()
    assert t.elapsed_seconds() == 0.0
    assert os.environ["HCTR_TPU_LOG_LEVEL"] == "warning"
