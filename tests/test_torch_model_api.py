"""The Model's low-level training API against the JAX package
(hugectr_tpu/model/model.py:1897-2262, the callbacks at :67-80 and `fit`'s
events at :1455-1505), from the same carried state on the same batches.

Tolerances: the tiny f32 DLRM-DCNv2's (tests/test_torch_model.py): loss
rtol 1e-4, every table, optimizer state and dense parameter rtol 1e-4 /
atol 1e-5. The tiny bench-configured model's step 1 from carried state
(tests/test_torch_bench.py): loss rtol 1e-5, tables within one bf16 ulp at
their scale (rtol 2^-7, atol 2^-8). A frozen table or frozen dense weights
are held bitwise unchanged in both packages.
"""
import inspect
import logging

import jax
import numpy as np
import pytest
import torch

import hugectr_tpu as jh
from hugectr_tpu.core.logger import get_logger as jax_logger
import hugectr_tpu_torch as th
from hugectr_tpu_torch import ops
from hugectr_tpu_torch.tools.carry import load_jax_state
from hugectr_tpu_torch.tools.samples import build_tiny_sample

from test_torch_persistence import cpu, f32, jax_model, port_model
from test_torch_samples import host_state, jax_sample

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def pair(monkeypatch):
    """The tiny f32 DLRM-DCNv2 in both packages from the JAX model's state
    (one-hot group `onehot_ev16`, model-parallel group `mp_ev16` on the
    sorted route); the JAX environment stays set for the test."""
    jm = jax_model(monkeypatch, "f32")
    tm = port_model("f32")
    load_jax_state(tm, jax.device_get(jm.state))
    return jm, tm


def assert_close_to_jax(tm, jm, what: str) -> None:
    s = jax.device_get(jm.state)
    for g in jm.ec.plan.groups:
        for t in g.tables:
            np.testing.assert_allclose(tm.ec.export_table(tm.tables, t.name),
                                       f32(jm.ec.export_table(jm.state["emb_tables"], t.name)), **TOL,
                                       err_msg=f"{what}: table {t.name}")
    for g, st in s["eopt"].items():
        for k, arr in st.items():
            np.testing.assert_allclose(f32(tm.eopt[g][k]), f32(arr), **TOL, err_msg=f"{what}: {g}.{k}")
    params = tm.network.param_tree()
    for layer, ps in s["dense_params"].items():
        for k, arr in ps.items():
            np.testing.assert_allclose(f32(params[layer][k]), arr, **TOL, err_msg=f"{what}: {layer}/{k}")
            np.testing.assert_allclose(f32(tm.dopt["accum"][layer][k]), s["dopt"]["accum"][layer][k], **TOL,
                                       err_msg=f"{what}: accum {layer}/{k}")


def step_both(jm, tm, what: str, rtol: float = 1e-4) -> float:
    jl, tl = jm.train(), tm.train()
    np.testing.assert_allclose(tl, jl, rtol=rtol, err_msg=f"{what}: loss")
    return tl


def tables_of(model, names):
    """{table: key-order rows} of either package's model, as float32."""
    if hasattr(model, "state"):
        return {n: f32(model.ec.export_table(model.state["emb_tables"], n)) for n in names}
    return {n: model.ec.export_table(model.tables, n) for n in names}


def dense_of(model):
    if hasattr(model, "state"):
        return {f"{layer}/{k}": np.asarray(v) for layer, ps in jax.device_get(model.state["dense_params"]).items()
                for k, v in ps.items()}
    return {f"{layer}/{k}": p.detach().numpy().copy() for layer, ps in model.network.param_tree().items()
            for k, p in ps.items()}


def test_learning_rate_control_matches_jax(pair):
    """set_learning_rate(0.0) leaves the tables and dense weights as they
    were (the accumulators still take the gradients, in both packages),
    -1 restores the schedule, reset_learning_rate_scheduler swaps it;
    get_current_loss is the last step's loss."""
    jm, tm = pair
    assert port_model("f32").get_current_loss() == 0.0
    names = [t.name for g in tm.ec.plan.groups for t in g.tables]
    before_t, before_d = tables_of(tm, names), dense_of(tm)
    for m in (jm, tm):
        m.set_learning_rate(0.0)
    step_both(jm, tm, "lr 0")
    for m in (jm, tm):
        after_t, after_d = tables_of(m, names), dense_of(m)
        for n in names:
            np.testing.assert_array_equal(after_t[n], before_t[n], err_msg=n)
        for k, v in before_d.items():
            np.testing.assert_array_equal(after_d[k], v, err_msg=k)
    assert_close_to_jax(tm, jm, "lr 0")
    for m in (jm, tm):
        m.set_learning_rate(-1.0)
    step_both(jm, tm, "schedule restored")
    assert not np.array_equal(tables_of(tm, names[:1])[names[0]], before_t[names[0]])
    assert_close_to_jax(tm, jm, "schedule restored")
    sched = dict(base_lr=0.5, warmup_steps=4, decay_start=6, decay_steps=2, decay_power=2.0, end_lr=0.01)
    for m in (jm, tm):
        m.reset_learning_rate_scheduler(**sched)
    for step in range(1, 10):
        assert tm.get_learning_rate_scheduler().get_next(step) == pytest.approx(
            jm.get_learning_rate_scheduler().get_next(step), rel=1e-7), step
    loss = step_both(jm, tm, "new schedule")
    assert tm.get_current_loss() == loss
    np.testing.assert_allclose(tm.get_current_loss(), jm.get_current_loss(), rtol=1e-4)
    assert_close_to_jax(tm, jm, "new schedule")


def test_freezing_dense_and_tables_matches_jax(pair):
    """freeze_dense, then freeze_embedding of a one-hot table and of a
    rowop table, then of the whole collection, each undone after a step;
    each step against the JAX package's. A frozen one-hot table launches
    no backward."""
    jm, tm = pair
    oh, rowop = (next(g for g in tm.ec.plan.groups if g.compute_kind == kind) for kind in ("onehot", "rowop"))
    frozen = [oh.tables[0].name, rowop.tables[0].name]
    names = [t.name for g in tm.ec.plan.groups for t in g.tables]

    for m in (jm, tm):
        m.freeze_dense()
    before = [dense_of(m) for m in (jm, tm)]
    step_both(jm, tm, "dense frozen")
    for m, b in zip((jm, tm), before):
        for k, v in dense_of(m).items():
            np.testing.assert_array_equal(v, b[k], err_msg=k)
    assert_close_to_jax(tm, jm, "dense frozen")

    for m in (jm, tm):
        m.unfreeze_dense()
        for n in frozen:
            m.freeze_embedding(n)
    before = [tables_of(m, names) for m in (jm, tm)]
    ops.reset_counts()
    step_both(jm, tm, "two tables frozen")
    assert ops.plain_counts()["onehot_bwd"] == 1  # one call for the live lookups; the frozen get none
    for m, b in zip((jm, tm), before):
        after = tables_of(m, names)
        for n in names:
            assert np.array_equal(after[n], b[n]) == (n in frozen), n
    assert_close_to_jax(tm, jm, "two tables frozen")

    for m in (jm, tm):
        m.unfreeze_embedding()
    before = [tables_of(m, frozen) for m in (jm, tm)]
    step_both(jm, tm, "unfrozen")
    for m, b in zip((jm, tm), before):
        assert all(not np.array_equal(tables_of(m, [n])[n], b[n]) for n in frozen)
    assert_close_to_jax(tm, jm, "unfrozen")

    for m in (jm, tm):
        m.freeze_embedding()
    before = [tables_of(m, names) for m in (jm, tm)]
    step_both(jm, tm, "collection frozen")
    for m, b in zip((jm, tm), before):
        after = tables_of(m, names)
        assert all(np.array_equal(after[n], b[n]) for n in names)
    assert_close_to_jax(tm, jm, "collection frozen")
    for m in (jm, tm):
        m.unfreeze_embedding()
    step_both(jm, tm, "collection unfrozen")


def test_freezing_dlrm_ftrl_tables_matches_jax(monkeypatch):
    """The tiny static DLRM-FTRL with a one-hot table, both tables of its
    one sorted-route group and the dense network frozen: that group's
    segmented scan gets a device count of 0 (no valid key: the counted
    route's list keeps its length), one fewer one-hot backward runs, and the
    step matches the JAX package's (loss rtol 1e-4); the frozen rows and
    dense weights stay bitwise; unfrozen, they move again."""
    from hugectr_tpu_torch.embedding import sparse_optimizer

    jm = jax_model(monkeypatch, "ftrl_static")
    tm = port_model("ftrl_static")
    load_jax_state(tm, jax.device_get(jm.state))
    sorted_group = next(g for g in tm.ec.plan.groups if g.name == "mp_ev128")
    oh = next(g for g in tm.ec.plan.groups if g.compute_kind == "onehot")
    frozen = [oh.tables[0].name] + [t.name for t in sorted_group.tables]
    for m in (jm, tm):
        m.freeze_dense()
        for n in frozen:
            m.freeze_embedding(n)
    ks = []
    scan = sparse_optimizer.segmented_sum_sorted
    monkeypatch.setattr(sparse_optimizer, "segmented_sum_sorted",
                        lambda v, h, dt, count, rowsrc: ks.append(int(count)) or scan(v, h, dt, count, rowsrc))
    before = [(tables_of(m, frozen), dense_of(m)) for m in (jm, tm)]
    ops.reset_counts()
    step_both(jm, tm, "frozen")
    assert ks == [0] and tm.ec.group_routes["mp_ev128"] == "sorted"
    assert ops.plain_counts()["onehot_bwd"] == 1  # one call for the live lookups; the frozen get none
    for m, (bt, bd) in zip((jm, tm), before):
        assert all(np.array_equal(tables_of(m, [n])[n], bt[n]) for n in frozen)
        assert all(np.array_equal(v, bd[k]) for k, v in dense_of(m).items())
    for m in (jm, tm):
        m.unfreeze_dense()
        m.unfreeze_embedding()
    step_both(jm, tm, "unfrozen")
    assert ks[-1] > 0
    assert all(not np.array_equal(tables_of(tm, [n])[n], before[1][0][n]) for n in frozen)


def test_freezing_a_split_table_by_its_user_name(monkeypatch):
    """The bench-configured model: freezing a split table's user-level name
    freezes its superhot, hot and cold tiers (`_is_frozen`'s `name::` rule),
    one step against the JAX package's; unfrozen, the tiers move again. The
    JAX package's `Model.freeze_embedding` refuses a user-level name (its
    `_find_table` knows the tiers only, ROADMAP Queue 3), so its side sets
    the collection's `frozen_tables` as its own tests do
    (tests/test_hot_cold_split.py:112)."""
    jm = jax_model(monkeypatch, "bench_bf16")
    tm = port_model("bench_bf16")
    load_jax_state(tm, jax.device_get(jm.state))
    user = next(iter(tm.ec.plan.table_splits))
    tiers = [sub for sub, _off in tm.ec.plan.table_splits[user]]
    assert len(tiers) == 3
    with pytest.raises(KeyError):
        jm.freeze_embedding(user)
    jm.ec.frozen_tables.add(user)
    jm._build_steps()
    tm.freeze_embedding(user)
    names = [t.name for g in tm.ec.plan.groups for t in g.tables]
    before = [tables_of(m, names) for m in (jm, tm)]
    step_both(jm, tm, "split table frozen", rtol=1e-5)
    for m, b in zip((jm, tm), before):
        after = tables_of(m, names)
        for n in names:
            assert np.array_equal(after[n], b[n]) == (n in tiers), n
    s = jax.device_get(jm.state)
    for g, arr in s["emb_tables"].items():
        np.testing.assert_allclose(f32(tm.tables[g]), f32(arr), rtol=2.0**-7, atol=2.0**-8, err_msg=g)
    jm.ec.frozen_tables.discard(user)
    jm._build_steps()
    tm.unfreeze_embedding(user)
    before = tables_of(tm, tiers)
    step_both(jm, tm, "split table unfrozen", rtol=5e-3)
    after = tables_of(tm, tiers)
    assert all(not np.array_equal(after[n], before[n]) for n in tiers)


def test_update_label_weights_on_mmoe(monkeypatch):
    """The tiny MMoE: new task weights in both packages, then two steps
    against the JAX package's; the summary is the same text."""
    jm = jax_sample(monkeypatch, "mmoe")
    tm = build_tiny_sample("mmoe", cpu())
    load_jax_state(tm, host_state(jm))
    assert tm.summary() == jm.summary()
    labels = ["50k_label", "married_label"]
    for m in (jm, tm):
        m.update_label_weights(labels, [0.9, 0.1])
    assert {s.label_name: s.weight for s in tm.network.loss_specs} == {"50k_label": 0.9, "married_label": 0.1}
    for step in range(2):
        step_both(jm, tm, f"step {step + 1}")
    with pytest.raises(ValueError, match="unknown label"):
        tm.update_label_weights(["nope"], [1.0])


def test_params_summary_overflow_and_check_out_tensor_match_jax(pair):
    """get_params_num, summary(), check_overflow() and check_out_tensor()
    on one batch; copy_weights_for_evaluation is a no-op in both."""
    jm, tm = pair
    assert tm.get_params_num() == jm.get_params_num()
    assert tm.summary() == jm.summary()
    want = jm.check_overflow()
    got = tm.check_overflow()
    assert sorted(got) == sorted(want)
    for g, v in want.items():
        assert got[g] == v, g
    before = dense_of(tm)
    assert tm.copy_weights_for_evaluation() is None and jm.copy_weights_for_evaluation() is None
    assert all(np.array_equal(v, before[k]) for k, v in dense_of(tm).items())
    batch = next(iter(tm.train_reader))
    for top in (tm.dense_layers[0].top_names[0], tm.dense_layers[2].top_names[0]):
        np.testing.assert_allclose(tm.check_out_tensor(top, batch), np.asarray(jm.check_out_tensor(top, batch)),
                                   rtol=1e-5, atol=1e-6, err_msg=top)


class Recorder(th.TrainingCallback):
    """The hooks in the order `fit` calls them; stops at iteration 4."""

    def __init__(self):
        self.events = []

    def on_training_start(self, model):
        self.events.append(("training_start",))

    def on_eval_start(self, model, iteration):
        self.events.append(("eval_start", iteration))

    def on_eval_end(self, model, iteration, metrics):
        self.events.append(("eval_end", iteration, sorted(metrics)))
        return iteration == 4

    def on_training_end(self, model, iteration):
        self.events.append(("training_end", iteration))


class Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def mllog(lines):
    import json

    return [json.loads(x.split(":::MLLOG ", 1)[1]) for x in lines if ":::MLLOG " in x]


def test_fit_callbacks_early_stop_and_mllog_events_match_jax(pair):
    """The callbacks in the JAX package's order, an early stop through
    on_eval_end, and the `:::MLLOG` events' keys and fields."""
    jm, tm = pair
    recs, handlers = [], []
    for m, logger in ((jm, jax_logger()), (tm, th.get_logger())):
        m.solver.perf_logging = True
        m.solver.max_eval_batches = 2
        rec, h = Recorder(), Lines()
        m.callbacks.append(rec)
        logger.addHandler(h)
        recs.append(rec)
        handlers.append((logger, h))
    try:
        for m in (jm, tm):
            m.fit(max_iter=8, display=0, eval_interval=2)
    finally:
        for logger, h in handlers:
            logger.removeHandler(h)
    assert recs[1].events == recs[0].events
    assert recs[1].events[0] == ("training_start",) and recs[1].events[-1] == ("training_end", 4)
    jev, tev = (mllog(h.lines) for _logger, h in handlers)
    assert [e["key"] for e in tev] == [e["key"] for e in jev] == [
        "init_start", "run_start", "eval_start", "eval_accuracy", "eval_start", "eval_accuracy", "run_stop"]
    assert [sorted(e) for e in tev] == [sorted(e) for e in jev]
    assert [e.get("iteration") for e in tev] == [e.get("iteration") for e in jev]
    # the Solver's callbacks are the Model's
    rec = Recorder()
    assert th.Model(th.Solver(training_callbacks=[rec]), None, th.OptParams(), device="cpu").callbacks == [rec]


def test_read_a_batch_stages_the_next_train_batch(pair):
    """A staged batch is what the next train() takes, in both packages:
    read_a_batch, then two steps, against the JAX package's and against a
    port model that trains without staging."""
    jm, tm = pair
    plain = port_model("f32")
    load_jax_state(plain, jax.device_get(jm.state))
    for m in (jm, tm):
        assert m.read_a_batch() is True
    staged = [step_both(jm, tm, f"staged step {i + 1}") for i in range(2)]
    assert staged == [plain.train() for _ in range(2)]
    assert tm.read_a_batch(is_train=False) is True


def test_every_public_method_of_the_jax_model_is_ported():
    """Each public method of hugectr_tpu.Model exists on the port's Model,
    the reader handles' too; on the synthetic reader the handles report no
    EOF and start with the train feed, and `set_source` keeps it."""
    jax_methods = sorted(n for n, _ in inspect.getmembers(jh.Model) if not n.startswith("_"))
    missing = [n for n in jax_methods if not hasattr(th.Model, n)]
    assert missing == []
    tm = port_model("f32")
    train, ev = tm.get_data_reader_train(), tm.get_data_reader_eval()
    handle = sorted(n for n in dir(train) if not n.startswith("_"))
    assert handle == sorted(n for n in dir(jh.Model.get_data_reader_train(tm)) if not n.startswith("_"))
    assert not train.is_started() and not train.is_eof() and not ev.is_eof()
    assert train.read_a_batch_to_device() == tm.solver.batchsize and train.is_started()
    tm.set_source(source="unused", eval_source="unused")
    assert isinstance(tm.train_reader, type(tm.eval_reader)) and not train.is_eof()
    assert th.TrainingCallback is not None and "TrainingCallback" in th.__all__
