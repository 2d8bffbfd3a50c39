"""The component-skip ablations (SKIP_EMBEDDING, SKIP_EMBEDDING_UPDATE,
SKIP_DENSE_LAYERS; hugectr_tpu/model/model.py:782-826, 869 and
hugectr_tpu/layers/network.py:139-165) against the JAX package with the
same variables set: 2 steps from carried state on the tiny DLRM-DCNv2 (the
bottom MLP is "mlp1", the top "mlp2"), and on a tiny graph with a
BatchNorm, Adam and an L2 regularizer, where a skipped layer's state and
parameters still move as in JAX. Also: the flags are read once, when the
step is built; a skipped stateless layer calls no forward; a skipped
stage's kernels make no calls.

Tolerances: losses rtol 1e-4; tables, dense parameters, their optimizer
state and BatchNorm's statistics rtol 1e-4 / atol 1e-5 (float32 sums in
another order over two steps).
"""
import jax
import numpy as np
import pytest
import torch

import hugectr_tpu as jh
import hugectr_tpu_torch as th
from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.tools import flagship as jflagship
from hugectr_tpu_torch import ops
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.tools import flagship as tflagship
from hugectr_tpu_torch.tools.carry import load_jax_state

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
SKIPS = ("SKIP_EMBEDDING", "SKIP_EMBEDDING_UPDATE", "SKIP_DENSE_LAYERS")
# test_torch_model.py's engine: one-hot for vocab <= 100, the rest sorted
ENGINE = dict(onehot_vocab=100, dense_update_rows=0, dense_key_ratio=0.0)
JAX_ENV = {
    "HCTR_TPU_ONEHOT_VOCAB": "100",
    "HCTR_TPU_DENSE_UPDATE_ROWS": "0",
    "HCTR_TPU_DENSE_KEY_RATIO": "0",
    "HCTR_TPU_SEGSUM": "scan",
    "HCTR_TPU_HOT_ROWS": "0",
    "HCTR_BENCH_OPT": "rowwise_adagrad",
}
FLAGS = {
    "embedding": {"SKIP_EMBEDDING": "1"},
    "embedding_update": {"SKIP_EMBEDDING_UPDATE": "1"},
    "bottom_mlp": {"SKIP_DENSE_LAYERS": "mlp1"},
    "top_mlp": {"SKIP_DENSE_LAYERS": "mlp2,m2"},
}


def _set_env(monkeypatch, env):
    for k in SKIPS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.delenv("HCTR_TPU_EMB_DTYPE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _assert_dense_close(tm, s, what):
    params = tm.network.param_tree()
    for layer, ps in s["dense_params"].items():
        for k, v in ps.items():
            np.testing.assert_allclose(params[layer][k].detach().numpy(), v, **TOL, err_msg=f"{what} {layer}/{k}")
    for kind, tree in s["dopt"].items():
        for layer, ps in tree.items():
            for k, v in ps.items():
                np.testing.assert_allclose(tm.dopt[kind][layer][k].numpy(), v, **TOL,
                                           err_msg=f"{what} {kind} {layer}/{k}")


@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_skip_flag_two_steps_match_jax(monkeypatch, flag):
    _set_env(monkeypatch, {**JAX_ENV, **FLAGS[flag]})
    jm = jflagship.build_tiny_dlrm(JaxResourceManager.create(num_devices=1), batchsize=64)
    tm = tflagship.build_tiny_dlrm(ResourceManager.create(device="cpu"), batchsize=64, **ENGINE)
    load_jax_state(tm, jax.device_get(jm.state))
    tables0 = {g: t.clone() for g, t in tm.tables.items()}
    params0 = {f"{la}/{k}": p.detach().clone() for la, ps in tm.network.param_tree().items() for k, p in ps.items()}
    ops.reset_counts()
    for step in range(2):
        jl, tl = jm.train(), tm.train()
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"loss at step {step + 1}")
    s = jax.device_get(jm.state)
    _assert_dense_close(tm, s, flag)
    for i in range(26):
        np.testing.assert_allclose(
            tm.ec.export_table(tm.tables, str(i)), jm.ec.export_table(s["emb_tables"], str(i)),
            **TOL, err_msg=f"table {i}",
        )
    counts = ops.plain_counts()
    moved = {g: not torch.equal(t, tables0[g]) for g, t in tm.tables.items()}
    if flag == "embedding":
        assert counts == {"segscan": 0, "onehot_fwd": 0, "onehot_bwd": 0, "ordered_pool": 0}
        assert not any(moved.values())
    elif flag == "embedding_update":
        assert counts["onehot_fwd"] == 2 and counts["onehot_bwd"] == counts["segscan"] == 0
        assert not any(moved.values())
    else:
        assert counts["onehot_fwd"] == 2 and counts["segscan"] == 2
        skipped = "l0_MLP" if flag == "bottom_mlp" else "l3_MLP"
        params = tm.network.param_tree()
        # zero gradients under rowwise AdaGrad's dense AdaGrad: unchanged
        for k, p in params[skipped].items():
            assert torch.equal(p.detach(), params0[f"{skipped}/{k}"]), k
        if flag == "top_mlp":  # every gradient is zero: the loss is ln 2
            assert not any(moved.values())
            np.testing.assert_allclose(tl, np.log(2.0), rtol=1e-6)


def test_skip_embedding_update_asks_no_cotangent(monkeypatch):
    """Under SKIP_EMBEDDING_UPDATE the embedding tops enter the network
    without requires_grad, so autograd makes no cotangent for them."""
    _set_env(monkeypatch, {"SKIP_EMBEDDING_UPDATE": "1"})
    tm = tflagship.build_tiny_dlrm(ResourceManager.create(device="cpu"), batchsize=32, **ENGINE)
    seen = []
    orig = tm._user_tensors

    def spy(outs):
        seen.extend(v.requires_grad for v in outs.values())
        return orig(outs)

    tm._user_tensors = spy
    tm.train()
    assert seen and not any(seen)


def test_flags_are_read_when_the_step_is_built(monkeypatch):
    _set_env(monkeypatch, {})
    tm = tflagship.build_tiny_dlrm(ResourceManager.create(device="cpu"), batchsize=32, **ENGINE)
    monkeypatch.setenv("SKIP_EMBEDDING", "1")
    ops.reset_counts()
    tm.train()
    assert ops.plain_counts()["onehot_fwd"] == 1  # set after compile: not read
    tm.reset_learning_rate_scheduler(0.005)  # rebuilds the step, as in the JAX package
    ops.reset_counts()
    tm.train()
    assert ops.plain_counts()["onehot_fwd"] == 0


def test_flags_are_read_again_by_update_label_weights(monkeypatch):
    _set_env(monkeypatch, {})
    tm = tflagship.build_tiny_dlrm(ResourceManager.create(device="cpu"), batchsize=32, **ENGINE)
    monkeypatch.setenv("SKIP_EMBEDDING", "1")
    ops.reset_counts()
    tm.train()
    assert ops.plain_counts()["onehot_fwd"] == 1
    label = tm.network.loss_specs[0].label_name
    tm.update_label_weights([label], [1.0])  # rebuilds the step, as JAX's model.py:1986 does
    ops.reset_counts()
    tm.train()
    assert ops.plain_counts()["onehot_fwd"] == 0


def test_skipped_stateless_layer_calls_no_forward(monkeypatch):
    """The skipped MLPs' forward is never called, in training or in eval;
    the zeros have the tops' shapes and the compute dtype."""
    _set_env(monkeypatch, {"SKIP_DENSE_LAYERS": "mlp1,mlp2"})
    tm = tflagship.build_tiny_dlrm(ResourceManager.create(device="cpu"), batchsize=32, max_eval_batches=2,
                                   batchsize_eval=16, **ENGINE)
    calls = {name: 0 for name in tm.network.layers}
    for name, layer in tm.network.layers.items():
        layer.register_forward_pre_hook(lambda m, a, n=name: calls.__setitem__(n, calls[n] + 1))
    tm.train()
    tm.eval()
    assert calls["l0_MLP"] == calls["l3_MLP"] == 0
    assert calls["l1_Concat"] == calls["l2_MultiCross"] == 3  # one step, two eval batches
    out = tm.network.forward({"dense": torch.ones(7, 13), "label": torch.ones(7, 1),
                              "sparse_embedding": torch.ones(7, 26 * 16)}, torch.bfloat16)
    assert out["mlp1"].shape == (7, 16) and out["mlp1"].dtype == torch.bfloat16
    assert not out["mlp2"].any()


def _bn_graph(pkg, rm, port_engine=None):
    """A tiny graph in `pkg`: a 50-row table, bottom MLP "mlp1", BatchNorm
    "bn1" on it, Concat with the embedding, top MLP "m2", BCE with an L2
    regularizer; Adam for the dense network and the table."""
    L = pkg.Layer_t
    solver = pkg.CreateSolver(max_eval_batches=2, batchsize_eval=32, batchsize=32, lr=0.01, repeat_dataset=True,
                              **(port_engine or {}))
    reader = pkg.DataReaderParams(data_reader_type=pkg.DataReaderType_t.Synthetic, synthetic_num_batches=3)
    model = pkg.Model(solver, reader, pkg.CreateOptimizer(optimizer_type=pkg.Optimizer_t.Adam), resource_manager=rm)
    model.add(pkg.Input(label_dim=1, label_name="label", dense_dim=13, dense_name="dense",
                        data_reader_sparse_param_array=[pkg.DataReaderSparseParam("d0", 2, True, 1)]))
    ebc = pkg.EmbeddingCollectionConfig()
    ebc.embedding_lookup([pkg.EmbeddingTableConfig(name="t0", max_vocabulary_size=50, ev_size=8)], ["d0"], "emb",
                         ["sum"])
    ebc.shard(shard_matrix=[["t0"]] * rm.num_devices, shard_strategy=[("mp", ["t0"])])
    model.add(ebc)
    DL = pkg.DenseLayer
    model.add(DL(layer_type=L.MLP, bottom_names=["dense"], top_names=["mlp1"], num_outputs=[16, 8]))
    model.add(DL(layer_type=L.BatchNorm, bottom_names=["mlp1"], top_names=["bn1"], factor=0.3))
    model.add(DL(layer_type=L.Concat, bottom_names=["bn1", "emb"], top_names=["c"]))
    model.add(DL(layer_type=L.MLP, bottom_names=["c"], top_names=["m2"], num_outputs=[8, 1],
                 activations=[pkg.Activation_t.Relu, pkg.Activation_t.Non]))
    model.add(DL(layer_type=L.BinaryCrossEntropyLoss, bottom_names=["m2", "label"], top_names=["loss"],
                 use_regularizer=True, regularizer_type="l2", lambda_=0.01))
    model.compile()
    return model


@pytest.mark.parametrize("skip", ["bn1", "mlp1"])
def test_skipped_layers_under_batchnorm_adam_and_l2_match_jax(monkeypatch, skip):
    """Skipping the BatchNorm: its running statistics still update from its
    input, and Adam still moves its gamma and beta by the L2 term. Skipping
    the bottom MLP: its weights move by the L2 term alone, and the
    BatchNorm sees zeros."""
    _set_env(monkeypatch, {"SKIP_DENSE_LAYERS": skip})
    jm = _bn_graph(jh, JaxResourceManager.create(num_devices=1))
    # the engine tests/conftest.py gives the JAX package: no one-hot, no dense sweep
    tm = _bn_graph(th, ResourceManager.create(device="cpu"),
                   dict(onehot_vocab=0, dense_update_rows=0, dense_key_ratio=0.0, hot_rows=0))
    load_jax_state(tm, jax.device_get(jm.state))
    bn0 = {k: v.clone() for k, v in tm.network.state_tree()["l1_BatchNorm"].items()}
    layer = "l1_BatchNorm" if skip == "bn1" else "l0_MLP"
    p0 = {k: p.detach().clone() for k, p in tm.network.param_tree()[layer].items()}
    for step in range(2):
        jl, tl = jm.train(), tm.train()
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"loss at step {step + 1}")
    s = jax.device_get(jm.state)
    _assert_dense_close(tm, s, skip)
    for k, v in s["net_state"]["l1_BatchNorm"].items():
        np.testing.assert_allclose(tm.network.state_tree()["l1_BatchNorm"][k].numpy(), v, **TOL, err_msg=k)
    np.testing.assert_allclose(tm.ec.export_table(tm.tables, "t0"), jm.ec.export_table(s["emb_tables"], "t0"), **TOL)
    if skip == "bn1":
        assert not torch.equal(tm.network.state_tree()["l1_BatchNorm"]["running_mean"], bn0["running_mean"])
    for k, p in tm.network.param_tree()[layer].items():  # the L2 term of a zero parameter is zero
        assert torch.equal(p.detach(), p0[k]) == (not p0[k].any()), f"{layer}/{k}: moves iff non-zero"
