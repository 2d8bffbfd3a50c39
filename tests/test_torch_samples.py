"""The eight other samples and their variants end to end, against the JAX
package. The JAX side is `samples/<name>.py` itself, run with `runpy`: its
reader replaced by the synthetic one, its slot sizes capped at 100 rows
(`hugectr_tpu.SparseEmbedding` patched, as tests/test_torch_dlrm_ftrl.py
patches EmbeddingTableConfig) and its Dropout at rate 0
(`hugectr_tpu.DenseLayer` patched), the engine settings of `TINY_SAMPLE`
set in its environment. The port's side is
`tools/samples.py::build_tiny_sample` on the CPU, carried from the JAX
model's state. Both train 3 steps on the same synthetic batches, then
evaluate. The port's steps and its eval forward run under
tests/test_torch_graph_step.py's `_Refuse` (no `.item()`, nonzero,
masked_select, unique or boolean index): the code its captured step runs
on the card (tests/test_torch_graph_samples.py holds it bitwise against
the earlier host-counted routes).

Tolerances: loss rtol 1e-4 per step; every table, the sparse optimizer
state, the dense parameters and the dense optimizer state rtol 1e-4 /
atol 1e-5 after step 3 (float32 sums in another order), with two
exceptions for weights under Adam, whose step lr * m / (sqrt(v) + eps)
divides a gradient by its own size. (a) A gradient that is 0 but for
rounding (JAX's sqrt(v) < 1e-9: DIN's attention-score biases and the
weights of the item columns that Scale repeats over a sample's history,
which the per-sample softmax does not see) makes steps of rounding noise:
such weights are only held within 3 lr of JAX's. (b) Where a row's
gradients of successive steps cancel in m, m / sqrt(v) carries their
rounding: at most one weight in 10,000 of an array (at least one) may
differ by up to 0.1 lr (NeuMF, lr 0.0045: one in 8,192 by 2.3e-5; BST: one
table element in 35,200 by 3.6e-5). Each task's eval AUC within 1e-6 and
AverageLoss rtol 1e-5. `graph_to_json` of the two
models is equal field for field (the solver on the fields both packages
set), and each package's graph file builds the same graph in the other.

Here: criteo_parquet, wdl, dcn, deepfm and the three NCF graphs;
tests/test_torch_samples_more.py holds MMoE (both), DIN and BST, and
tests/test_torch_samples_hybrid.py DIN and MMoE at W = 2.
"""
import json
import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

import hugectr_tpu
from hugectr_tpu.model.model import Model as JModel

from hugectr_tpu_torch import ops
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Optimizer_t
from hugectr_tpu_torch.model.model import Model as TModel
from hugectr_tpu_torch.tools.carry import load_jax_state
from hugectr_tpu_torch.tools.samples import GRAPHS, TINY_SAMPLE, build_tiny_sample

from test_torch_graph_step import _Refuse

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
SAMPLES = os.path.join(os.path.dirname(__file__), "..", "samples")
JAX_ENV = {"HCTR_TPU_ONEHOT_VOCAB": str(TINY_SAMPLE["onehot_vocab"]),
           "HCTR_TPU_SPLIT_VOCAB": str(TINY_SAMPLE["split_vocab"]),
           "HCTR_TPU_DENSE_UPDATE_ROWS": str(TINY_SAMPLE["dense_update_rows"]),
           "HCTR_TPU_DENSE_KEY_RATIO": str(TINY_SAMPLE["dense_key_ratio"]), "HCTR_TPU_SEGSUM": "scan",
           "HCTR_TPU_ONEHOT_KERNEL": "pallas", "HCTR_TPU_HOT_ROWS": "0"}
IDS = [name if var is None else var for name, var in GRAPHS]


def jax_sample(mp, name, variant=None, num_devices=1):
    """samples/<name>.py as a compiled JAX model at the tests' size, on a
    mesh of `num_devices` devices."""
    for k, v in JAX_ENV.items():
        mp.setenv(k, v)
    mp.delenv("HCTR_TPU_EMB_DTYPE", raising=False)
    cap = TINY_SAMPLE["slot_cap"]
    orig_se, orig_dl = hugectr_tpu.SparseEmbedding, hugectr_tpu.DenseLayer

    def capped(**kw):
        kw["slot_size_array"] = [min(s, cap) for s in kw["slot_size_array"]]
        return orig_se(**kw)

    def no_dropout(**kw):
        if kw["layer_type"] == hugectr_tpu.Layer_t.Dropout:
            kw["dropout_rate"] = TINY_SAMPLE["dropout_rate"]
        return orig_dl(**kw)

    mp.setattr(hugectr_tpu, "SparseEmbedding", capped)
    mp.setattr(hugectr_tpu, "DenseLayer", no_dropout)
    mp.syspath_prepend(SAMPLES)
    import common as sample_common

    mp.setattr(sample_common, "make_reader", lambda args, sizes, nnz_array=None, **kw: hugectr_tpu.DataReaderParams(
        data_reader_type="synthetic", synthetic_num_batches=TINY_SAMPLE["synthetic_batches"], synthetic_alpha=1.05))
    argv = [name, "--batchsize", str(TINY_SAMPLE["batchsize"]), "--num_devices", str(num_devices)]
    mp.setattr(sys, "argv", argv + (["--variant", variant] if variant else []))
    model = runpy.run_path(os.path.join(SAMPLES, f"{name}.py"), run_name="not_main")["model"]
    model.compile()
    return model


def host_state(jm):
    """A JAX model's state on the host, bfloat16 arrays as float32."""
    s = jax.device_get(jm.state)
    return {k: s[k] for k in ("emb_tables", "eopt", "dense_params", "dopt", "step")}


def assert_weights_close(got, want, v, lr, what):
    """rtol 1e-4 / atol 1e-5, with the two Adam exceptions of the module's
    docstring (`v`: JAX's second moment of these weights, or None)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    diff = np.abs(got - want)
    bad = diff > TOL["atol"] + TOL["rtol"] * np.abs(want)
    noise = np.zeros(want.shape, bool) if v is None else np.sqrt(np.asarray(v)) < 1e-9
    assert np.isfinite(got).all() and (diff[noise] <= 3 * lr).all(), what
    rest = bad & ~noise
    assert rest.sum() <= max(1, want.size // 10000) and (diff[rest] <= 0.1 * lr).all(), (
        f"{what}: {int(rest.sum())} of {want.size} beyond tolerance, by up to {diff[rest].max(initial=0)}")


def assert_state_close(state, tables, eopt, dense, dopt, lr, what=""):
    for g, arr in state["emb_tables"].items():
        assert_weights_close(tables[g], arr, state["eopt"][g].get("v"), lr, f"{what} table {g}")
        for k, v in state["eopt"][g].items():
            np.testing.assert_allclose(eopt[g][k], v, **TOL, err_msg=f"{what} sparse state {g}/{k}")
    for layer, ps in state["dense_params"].items():
        for k, v in ps.items():
            assert_weights_close(dense[layer][k], v, state["dopt"].get("v", {}).get(layer, {}).get(k), lr,
                                 f"{what} {layer}/{k}")
    for kind, tree in state["dopt"].items():
        for layer, ps in tree.items():
            for k, v in ps.items():
                np.testing.assert_allclose(dopt[kind][layer][k], v, **TOL, err_msg=f"{what} {kind} {layer}/{k}")


def assert_eval_close(got, want):
    assert set(got) == set(want), (got, want)
    for k, v in want.items():
        if k.startswith("auc"):
            assert abs(got[k] - v) <= 1e-6, (k, got[k], v)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


def _graph(model, path):
    model.graph_to_json(str(path))
    with open(path) as f:
        return json.load(f)


def assert_graphs_equal(tg, jg):
    """Field for field: the Input, the dense layers, the SparseEmbeddings
    and collections; the solver on the fields both set."""
    for key in ("input", "dense_layers", "sparse_embeddings", "embedding_collections"):
        assert tg[key] == jg[key], key
    common = {k for k, v in jg["solver"].items() if v is not None} & set(tg["solver"])
    assert {"batchsize", "batchsize_eval", "lr", "max_eval_batches", "metrics_spec"} <= common
    assert {k: tg["solver"][k] for k in common} == {k: jg["solver"][k] for k in common}


def check_sample(monkeypatch, tmp_path, name, variant):
    """One graph: plans, graph files, 3 steps, state and eval against JAX."""
    jm = jax_sample(monkeypatch, name, variant)
    tm = build_tiny_sample(name, ResourceManager.create(device="cpu"), variant=variant)
    assert [(g.name, g.compute_kind) for g in tm.ec.plan.groups] == [
        (g.name, g.compute_kind) for g in jm.ec.plan.groups]
    jgraph, tgraph = _graph(jm, tmp_path / "jax.json"), _graph(tm, tmp_path / "port.json")
    assert_graphs_equal(tgraph, jgraph)
    load_jax_state(tm, host_state(jm))
    ops.reset_counts()
    for step in range(3):
        jl = jm.train()
        with _Refuse():  # the port's step as it is captured: no host read, no data-sized op
            tl = tm.train_async()
        np.testing.assert_allclose(float(tl), jl, rtol=1e-4, err_msg=f"{name} loss at step {step + 1}")
    assert set(ops.launch_counts().values()) == {0}
    onehot = [g for g in tm.ec.plan.groups if g.compute_kind == "onehot"]
    routes = list(tm.ec.group_routes.values())
    n_sorted = routes.count("sorted")
    # the dense sweep and SGD sum by the drop-mode scatter; the AdaGrad
    # family's, FTRL's and Adam's sorted route updates by the drop-mode row
    # update; no Dropout draws at rate 0
    ada = tm.opt_params.optimizer in (Optimizer_t.AdaGrad, Optimizer_t.RowWiseAdaGrad)
    ftrl = tm.opt_params.optimizer == Optimizer_t.FTRL
    adam = tm.opt_params.optimizer == Optimizer_t.Adam
    assert ops.plain_counts() == {"segscan": 3 * n_sorted, "onehot_fwd": 3 * len(onehot),
                                  "onehot_bwd": 3 * len(onehot), "ordered_pool": 0,
                                  "row_scatter": 3 * (routes.count("dense") + routes.count("scatter")),
                                  "adagrad_rows": 3 * n_sorted * ada, "ftrl_rows": 3 * n_sorted * ftrl,
                                  "adam_rows": 3 * n_sorted * adam, "dropout_mask": 0}
    state = host_state(jm)
    params = tm.network.param_tree()
    assert_state_close(
        state, {g: t.numpy() for g, t in tm.tables.items()},
        {g: {k: t.numpy() for k, t in st.items()} for g, st in tm.eopt.items()},
        {layer: {k: p.detach().numpy() for k, p in ps.items()} for layer, ps in params.items()},
        {kind: {layer: {k: t.numpy() for k, t in ps.items()} for layer, ps in tree.items()}
         for kind, tree in tm.dopt.items()}, tm.solver.lr, name)
    source, _feeder, _fed = tm._eval_batches()
    with _Refuse():  # the eval forward as it is captured
        for b in source:
            tm._eval_step(b)
    assert_eval_close(tm.eval(), jm.eval())


# the multi-task and attention graphs, whose JAX compiles take longest, are
# in tests/test_torch_samples_more.py, so that the test workers share them
@pytest.mark.parametrize("name,variant", GRAPHS[:7], ids=IDS[:7])
def test_sample_three_steps_match_jax(monkeypatch, tmp_path, name, variant):
    check_sample(monkeypatch, tmp_path, name, variant)


def test_samples_cover_every_route_and_width():
    """Between them the tiny graphs take the one-hot, dense-sweep and
    sorted update routes, at the samples' widths (E 1, 11, 16, 18, 32)."""
    cpu = ResourceManager.create(device="cpu")
    routes, widths = set(), set()
    for name, variant in GRAPHS:
        m = build_tiny_sample(name, cpu, variant=variant)
        m.train()
        routes |= set(m.ec.group_routes.values())
        widths |= {g.ev_size for g in m.ec.plan.groups}
    assert routes == {"onehot", "dense", "sorted"}
    assert widths == {1, 11, 16, 18, 32}


def test_graph_files_load_in_either_package(monkeypatch, tmp_path):
    """DeepFM and BST: the JAX package's graph file builds the port's graph
    (`construct_from_json`: the same layers, fields and tables), and the
    port's builds the JAX package's."""
    cpu = ResourceManager.create(device="cpu")
    for name in ("deepfm", "bst"):
        with monkeypatch.context() as mp:
            jm = jax_sample(mp, name)
            jgraph = _graph(jm, tmp_path / f"{name}_jax.json")
        tm = build_tiny_sample(name, cpu)
        tgraph = _graph(tm, tmp_path / f"{name}_port.json")
        from_jax = TModel.construct_from_json(str(tmp_path / f"{name}_jax.json"), reader_params=tm.reader_params,
                                              optimizer=tm.opt_params, resource_manager=cpu)
        assert sorted((lk.table.name, lk.table.vocabulary_size) for lk in from_jax.ec.plan.lookups) == sorted(
            (lk.table.name, lk.table.vocabulary_size) for lk in jm.ec.plan.lookups)
        assert_graphs_equal(_graph(from_jax, tmp_path / f"{name}_again.json"), jgraph)
        assert np.isfinite(from_jax.train())
        from_port = JModel.construct_from_json(str(tmp_path / f"{name}_port.json"), compile_model=False)
        assert_graphs_equal(tgraph, _graph(from_port, tmp_path / f"{name}_jax_again.json"))
        assert tgraph["solver_settings"]["embedding_state_dtype"] == "float32"


def test_vocabulary_for_matches_jax_at_every_world_size():
    """`SparseEmbedding.vocabulary_for(W)`: an explicit vocabulary, the sum
    of the slot sizes, or (with neither) the workspace of W devices, as in
    the JAX package; every sample gives its slot sizes, so no sample's
    tables change with the rank count."""
    from hugectr_tpu.embedding.config import SparseEmbedding as JSE
    from hugectr_tpu_torch.embedding.config import SparseEmbedding as TSE

    for kw in (dict(slot_size_array=[3, 5]), dict(max_vocabulary_size=77, slot_size_array=[3]), dict(),
               dict(workspace_size_per_gpu_in_mb=1)):
        kw = dict(dict(embedding_type="DistributedSlotSparseEmbeddingHash", workspace_size_per_gpu_in_mb=84,
                       embedding_vec_size=18, combiner="sum", sparse_embedding_name="e", bottom_name="d"), **kw)
        for w in (1, 2, 4):
            assert TSE(**kw).vocabulary_for(w) == JSE(**kw).vocabulary_for(w)
    assert TSE(**kw).vocabulary_for(2) == (1 << 20) * 2 // (4 * 18)  # 1 MB a device, 4 bytes x ev 18
    cpu = ResourceManager.create(device="cpu")
    for name, variant in GRAPHS:
        m = build_tiny_sample(name, cpu, variant=variant)
        assert m.sparse_embeddings and all(se.slot_size_array for se in m.sparse_embeddings), name


def test_unported_layer_field_refuses_to_load(tmp_path):
    """The fields of the layers that once were not ported (here
    MatrixMultiply's `transpose_b`) no longer refuse a graph file: every
    field is the JAX package's and loads, and a layer that sets one keeps
    it through the model and its next graph file."""
    cpu = ResourceManager.create(device="cpu")
    tm = build_tiny_sample("ncf", cpu)
    g = _graph(tm, tmp_path / "ncf.json")
    g["dense_layers"][0]["transpose_b"] = True
    (tmp_path / "set.json").write_text(json.dumps(g))
    m = TModel.construct_from_json(str(tmp_path / "set.json"), resource_manager=cpu)
    assert m.dense_layers[0].transpose_b is True
    assert _graph(m, tmp_path / "again.json")["dense_layers"] == g["dense_layers"]
