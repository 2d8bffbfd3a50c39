"""A tiny graph with the layers and regularizers no sample uses (GRU,
BatchNorm, a GELU MLP, Gather over the global batch, BCE with an L1 or L2
regularizer; `torch_rank_fns.graph_layers_model`) trained 3 steps from the
JAX model's carried state, on one device and at W = 2 ranks (a spawned
gloo group) against the JAX package's 2-device CPU mesh: losses, dense
parameters and their AdaGrad state, BatchNorm's running statistics and the
table. Then `dense_model.npz` with `net_state/` byte-equal to the JAX
package's and cross-loading both ways, the graph files of both packages
alike, and HCTR_TPU_CHECK_KEYS (tests/test_model_e2e.py:451-559).

Tolerances: losses rtol 1e-4; parameters, state, statistics and table rtol
1e-4 / atol 1e-5 (float32 sums in another order over three steps); the
snapshot's files bitwise.
"""
import json

import jax
import numpy as np
import pytest
import torch

import hugectr_tpu as jh
import hugectr_tpu_torch as th
import torch_rank_fns as fns
from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.tools import hybrid
from hugectr_tpu_torch.tools.carry import load_jax_state
from test_torch_persistence import assert_same_snapshot

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)


def _jax_model(reg, num_devices=1):
    return fns.graph_layers_model(jh, JaxResourceManager.create(num_devices=num_devices), reg=reg)


def _port_model(reg="l2"):
    return fns.graph_layers_model(th, ResourceManager.create(device="cpu"), reg=reg, port_engine=fns.GRAPH_ENGINE)


def _state(jm):
    s = jax.device_get(jm.state)
    return {k: s[k] for k in ("emb_tables", "eopt", "dense_params", "dopt", "net_state", "step")}


def _assert_state_close(tm, s, what):
    params = tm.network.param_tree()
    for layer, ps in s["dense_params"].items():
        for k, v in ps.items():
            np.testing.assert_allclose(params[layer][k].detach().numpy(), v, **TOL, err_msg=f"{what} {layer}/{k}")
    for kind, tree in s["dopt"].items():
        for layer, ps in tree.items():
            for k, v in ps.items():
                np.testing.assert_allclose(tm.dopt[kind][layer][k].numpy(), v, **TOL,
                                           err_msg=f"{what} {kind} {layer}/{k}")
    bufs = tm.network.state_tree()
    assert set(bufs) == set(s["net_state"]) and len(bufs) == 1
    for layer, st in s["net_state"].items():
        for k, v in st.items():
            np.testing.assert_allclose(bufs[layer][k].numpy(), v, **TOL, err_msg=f"{what} {layer}/{k}")
    for g, v in s["emb_tables"].items():
        np.testing.assert_allclose(tm.tables[g].numpy(), v, **TOL, err_msg=f"{what} {g}")


@pytest.mark.parametrize("reg", ["l1", "l2"])
def test_tiny_graph_trains_as_jax(monkeypatch, reg):
    """One device: 3 steps from JAX's carried state (net_state included);
    the losses carry the regularizer (the same graph without it gives
    other losses) and the running statistics move."""
    jm = _jax_model(reg)
    s0 = _state(jm)
    tm = _port_model(reg)
    load_jax_state(tm, s0)
    jl = [jm.train() for _ in range(3)]
    tl = [tm.train() for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    s3 = _state(jm)
    _assert_state_close(tm, s3, reg)
    (bn,) = s3["net_state"].values()
    assert not np.allclose(bn["running_mean"], 0.0)
    plain = _port_model("none")
    load_jax_state(plain, s0)
    assert abs(plain.train() - tl[0]) > 1e-6


def test_tiny_graph_on_two_ranks_matches_jax_mesh():
    """W = 2 gloo ranks against JAX's 2-device mesh from one state: the
    BatchNorm statistics over the global batch, Gather's global rows, the
    regularizer counted once; replicated arrays bitwise across the ranks."""
    jm = _jax_model("l2", num_devices=2)
    s0 = _state(jm)
    jl = [jm.train() for _ in range(3)]
    s3 = _state(jm)
    ranks = hybrid.run(fns.graph_layers_ranks, 2, {"state": s0, "reg": np.asarray("l2")}, device="cpu")
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["losses"], jl, rtol=1e-4, err_msg=f"rank {r}")
        for layer, ps in s3["dense_params"].items():
            for k, v in ps.items():
                np.testing.assert_allclose(res[f"dense:{layer}.{k}"], v, **TOL, err_msg=f"rank {r} {layer}/{k}")
        for kind, tree in s3["dopt"].items():
            for layer, ps in tree.items():
                for k, v in ps.items():
                    np.testing.assert_allclose(res[f"dopt:{kind}.{layer}.{k}"], v, **TOL)
        for layer, st in s3["net_state"].items():
            for k, v in st.items():
                np.testing.assert_allclose(res[f"net_state:{layer}.{k}"], v, **TOL, err_msg=f"rank {r} {k}")
        for g, v in s3["emb_tables"].items():
            n = res[f"table:{g}"].shape[0]
            np.testing.assert_allclose(res[f"table:{g}"], np.asarray(v)[r * n : (r + 1) * n], **TOL)
    for k, v in ranks[0].items():
        if not k.startswith("table:"):
            np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)


def test_net_state_snapshot_bytes_and_cross_loading(tmp_path):
    """The carried state after a JAX step: `dense_model.npz` (with
    `net_state/<layer>/running_*`) and every other file byte-equal to the
    JAX package's; each package loads the other's snapshot (the running
    statistics too) and `load_dense_weights` takes them with the
    parameters."""
    jm = _jax_model("l2")
    jm.train()
    jm.download_params_to_files(str(tmp_path / "jax"), 1)
    tm = _port_model()
    load_jax_state(tm, _state(jm))
    tm.download_params_to_files(str(tmp_path / "port"), 1)
    rels = assert_same_snapshot(str(tmp_path / "port_iter1"), str(tmp_path / "jax_iter1"))
    assert "dense_model.npz" in rels
    keys = list(np.load(tmp_path / "port_iter1" / "dense_model.npz").keys())
    assert [k for k in keys if k.startswith("net_state/")] == ["net_state/l2_BatchNorm/running_mean",
                                                               "net_state/l2_BatchNorm/running_var"]
    fresh = _port_model()
    fresh.load_params_from_files(str(tmp_path / "jax_iter1"))
    _assert_state_close(fresh, _state(jm), "port from jax")
    fresh2 = _port_model()
    fresh2.load_dense_weights(str(tmp_path / "jax_iter1"))
    want = _state(jm)["net_state"]["l2_BatchNorm"]["running_var"]
    np.testing.assert_array_equal(fresh2.network.state_tree()["l2_BatchNorm"]["running_var"].numpy(), want)
    jm2 = _jax_model("l2")
    jm2.load_params_from_files(str(tmp_path / "port_iter1"))
    _assert_state_close(tm, _state(jm2), "jax from port")


def test_graph_files_match_and_load_in_the_port(tmp_path):
    """The dense layers of both packages' graph files are the same JSON (the
    fields GRU, BatchNorm and Gather set among them), and the JAX file
    builds the port's model with the same layers."""
    jm, tm = _jax_model("l2"), _port_model()
    jm.graph_to_json(str(tmp_path / "jax.json"))
    tm.graph_to_json(str(tmp_path / "port.json"))
    jg, tg = (json.load(open(tmp_path / f"{n}.json")) for n in ("jax", "port"))
    assert tg["dense_layers"] == jg["dense_layers"]
    assert json.dumps(tg["dense_layers"], indent=2) == json.dumps(jg["dense_layers"], indent=2)
    assert {"SeqLength", "indices", "gamma_init_type", "transpose_b"} <= set(tg["dense_layers"][0])
    rebuilt = th.Model.construct_from_json(str(tmp_path / "jax.json"), resource_manager=ResourceManager.create(
        device="cpu"))
    assert [type(m).__name__ for m in rebuilt.network.layers.values()] == [
        type(m).__name__ for m in tm.network.layers.values()]


def _check_keys_model(monkeypatch, value):
    monkeypatch.setenv("HCTR_TPU_CHECK_KEYS", value)
    solver = th.CreateSolver(max_eval_batches=1, batchsize_eval=16, batchsize=16, lr=0.01, repeat_dataset=True)
    reader = th.DataReaderParams(data_reader_type=th.DataReaderType_t.Synthetic, synthetic_num_batches=2)
    model = th.Model(solver, reader, th.CreateOptimizer(optimizer_type=th.Optimizer_t.SGD),
                     resource_manager=ResourceManager.create(device="cpu"))
    model.add(th.Input(label_dim=1, label_name="label", dense_dim=4, dense_name="dense",
                       data_reader_sparse_param_array=[th.DataReaderSparseParam("d0", 2, True, 1)]))
    ebc = th.EmbeddingCollectionConfig()
    ebc.embedding_lookup([th.EmbeddingTableConfig(name="t0", max_vocabulary_size=50, ev_size=8)], ["d0"], "emb",
                         ["sum"])
    ebc.shard(shard_matrix=[["t0"]], shard_strategy=[("mp", ["t0"])])
    model.add(ebc)
    model.add(th.DenseLayer(layer_type=th.Layer_t.Concat, bottom_names=["emb", "dense"], top_names=["c"]))
    model.add(th.DenseLayer(layer_type=th.Layer_t.InnerProduct, bottom_names=["c"], top_names=["out"], num_output=1))
    model.add(th.DenseLayer(layer_type=th.Layer_t.BinaryCrossEntropyLoss, bottom_names=["out", "label"],
                            top_names=["loss"]))
    model.compile()
    return model


def _batch(keys):
    return {"label": np.zeros((16, 1), np.float32), "dense": np.zeros((16, 4), np.float32),
            "d0": np.full((16, 2), keys, np.int32)}


def test_check_keys_env_asserts_out_of_range(monkeypatch):
    """tests/test_model_e2e.py:451: HCTR_TPU_CHECK_KEYS=1 makes `_put_batch`
    raise for a static table's key >= vocab and for a negative key other
    than -1, naming the table; in-range keys and padding pass. The fused
    batch of a file reader is checked on its feature columns."""
    model = _check_keys_model(monkeypatch, "1")
    model._put_batch(_batch(49))
    with pytest.raises(ValueError, match="t0"):
        model._put_batch(_batch(50))
    model._put_batch(_batch(-1))
    with pytest.raises(ValueError, match="negative"):
        model._put_batch(_batch(-7))
    assert model._host_features({"d0": 1}) == {"d0": 1}


def test_check_keys_env_zero_disables(monkeypatch):
    """tests/test_model_e2e.py:559: "0" disables the check like every other
    variable (and the default is off)."""
    model = _check_keys_model(monkeypatch, "0")
    model._put_batch(_batch(50))
    monkeypatch.delenv("HCTR_TPU_CHECK_KEYS")
    assert not _check_keys_model(monkeypatch, "")._check_keys
