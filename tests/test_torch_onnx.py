"""The serving path: the port's ONNX converter (`tools/hugectr2onnx.py`,
`tools/onnx_writer.py`) and `tools/predict.py` against the JAX package's.

Each graph of tests/test_onnx_export.py (DCN, DIN attention, BST, GRU,
MatrixMultiply / MaskedSoftmax / Select / Gather, the hot/cold split) runs
as that file runs it, with the JAX converter wrapped: every conversion is
made again by the port's converter from the same graph file and snapshot,
and the ONNX files must be the same bytes. Where the snapshot is a
directory, the port also rebuilds the model from the JAX graph file, loads
the JAX snapshot, writes its own graph file and snapshot, and converts
those: the same bytes again. The GRU graph is also run through that file's
numpy interpreter against the port model's own logits (rtol 1e-3, atol
1e-4, the file's tolerance). `predict` from a JAX-written graph file and
snapshot against root tools/predict.py::predict within 1e-6 (absolute),
and the CLI's `.npy` against `predict`.
"""
import importlib.util
import inspect
import os
import pathlib

import jax  # noqa: F401 (JAX on the CPU, as the conftest sets it)
import numpy as np
import pytest
import torch

import hugectr_tpu as jh
import hugectr_tpu_torch as th
import test_onnx_export as jt
import torch_rank_fns as fns
from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.tools import hugectr2onnx as tconv
from hugectr_tpu_torch.tools import onnx_writer as tw
from hugectr_tpu_torch.tools import predict as tpredict

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
GRAPHS = ["test_dcn_onnx_roundtrip", "test_din_style_attention_export", "test_bst_style_export",
          "test_gru_export", "test_matrixmultiply_maskedsoftmax_select_gather_export",
          "test_hot_cold_split_model_export"]


def _rebuild(graph_config, snapshot, out_dir):
    """The port's model from the JAX graph file with the JAX snapshot
    loaded; its own graph file and snapshot written under `out_dir`."""
    tm = th.Model.construct_from_json(
        graph_config, reader_params=th.DataReaderParams(data_reader_type="synthetic", synthetic_num_batches=2),
        resource_manager=ResourceManager.create(device="cpu"))
    tm.load_params_from_files(snapshot)
    tm.graph_to_json(os.path.join(out_dir, "port_graph.json"))
    tm.download_params_to_files(os.path.join(out_dir, "port"), 7)
    return tm, os.path.join(out_dir, "port_graph.json"), os.path.join(out_dir, "port_iter7")


@pytest.mark.parametrize("name", GRAPHS)
def test_port_converter_writes_the_jax_bytes(name, mesh1, tmp_path, monkeypatch):
    real = jt.hugectr2onnx.convert
    calls = []

    def both(onnx_path, graph_config, dense_model, *args, **kw):
        real(onnx_path, graph_config, dense_model, *args, **kw)
        with open(onnx_path, "rb") as f:
            want = f.read()
        tconv.convert(onnx_path + ".port", graph_config, dense_model, *args, **kw)
        with open(onnx_path + ".port", "rb") as f:
            assert f.read() == want, f"{name}: the port's converter wrote other bytes"
        rec = dict(path=onnx_path, kw=kw)
        if os.path.isdir(dense_model) and not kw.get("sparse_models") and not args:
            out = tmp_path / f"rebuilt{len(calls)}"
            out.mkdir()
            tm, graph2, snap2 = _rebuild(graph_config, dense_model, str(out))
            tconv.convert(str(out / "m.onnx"), graph2, snap2, **kw)
            with open(out / "m.onnx", "rb") as f:
                assert f.read() == want, f"{name}: the port's own graph file and snapshot convert otherwise"
            rec.update(model=tm, port_onnx=str(out / "m.onnx"))
        calls.append(rec)

    monkeypatch.setattr(jt.hugectr2onnx, "convert", both)
    fn = getattr(jt, name)
    args = dict(mesh1=mesh1, tmp_path=tmp_path, monkeypatch=monkeypatch)
    fn(**{k: args[k] for k in inspect.signature(fn).parameters})
    assert calls and any("model" in c for c in calls)
    if name == "test_gru_export":  # the port model against the port's ONNX file, numerically
        (rec,) = [c for c in calls if "model" in c and c["kw"].get("convert_embedding")]
        nodes, inits, _inputs, outputs = jt.parse_model(open(rec["port_onnx"], "rb").read())
        rng = np.random.default_rng(6)
        feeds = {"dense": rng.random((8, 32), dtype=np.float32), "d0": rng.integers(0, 20, (8, 1)).astype(np.int64)}
        pred = jt.run_model_ext(nodes, inits, feeds)[outputs[0]].reshape(-1)
        batch = {"label": np.zeros((8, 1), np.float32), "dense": feeds["dense"], "d0": feeds["d0"].astype(np.int32)}
        logits = rec["model"].check_out_tensor("logit", batch).reshape(-1)
        np.testing.assert_allclose(pred, 1.0 / (1.0 + np.exp(-logits)), rtol=1e-3, atol=1e-4)


def test_writer_and_decoder_match_jax():
    """The port's protobuf writer gives the JAX writer's bytes for a graph
    with float and int64 initializers, attributes of every kind and value
    infos, and `decode_fields` reads them back alike."""
    from hugectr_tpu.tools import onnx_writer as jw

    def build(w):
        g = w.OnnxGraph(name="g")
        g.add_input("x", ["batch", 4])
        a = g.add_initializer("w", np.arange(12, dtype=np.float32).reshape(4, 3))
        b = g.add_initializer("i", np.asarray([2, -1], np.int64))
        g.add_node("MatMul", ["x", a], ["y"])
        g.add_node("Reshape", ["y", b], ["z"])
        g.add_node("Transpose", ["z"], ["t"], perm=[1, 0])
        g.add_node("Softmax", ["t"], ["s"], axis=-1)
        g.add_node("LayerNormalization", ["s"], ["o"], epsilon=1e-5)
        g.add_output("o", ["batch", 3])
        return g.serialize()

    got, want = build(tw), build(jw)
    assert got == want
    assert tw.decode_fields(got) == jw.decode_fields(want)


def _jax_predict():
    spec = importlib.util.spec_from_file_location("jax_tools_predict", ROOT / "tools" / "predict.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.predict


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The tiny graph (GRU, BatchNorm, Gather, ...) trained 2 steps in the
    JAX package, its graph file and snapshot."""
    root = tmp_path_factory.mktemp("served")
    jm = fns.graph_layers_model(jh, JaxResourceManager.create(num_devices=1))
    for _ in range(2):
        jm.train()
    jm.graph_to_json(str(root / "graph.json"))
    jm.download_params_to_files(str(root / "snap"), 2)
    rp = lambda pkg: pkg.DataReaderParams(data_reader_type="synthetic", synthetic_num_batches=4)  # noqa: E731
    want = _jax_predict()(str(root / "graph.json"), str(root / "snap_iter2"), rp(jh), max_batches=0,
                          resource_manager=JaxResourceManager.create(num_devices=1))
    return root, rp, want


def test_predict_matches_jax_predict(served):
    """The port's `predict` rebuilds the model from the JAX graph file,
    loads the JAX snapshot (BatchNorm's running statistics in eval) and
    sweeps the eval source (the graph's max_eval_batches, 2, of the cached
    synthetic batches): JAX's predictions within 1e-6."""
    root, rp, want = served
    got = tpredict.predict(str(root / "graph.json"), str(root / "snap_iter2"), rp(th), device="cpu")
    assert set(got) == set(want) == {"label"}
    assert got["label"].shape == want["label"].shape == (2 * fns.GRAPH_B, 1)
    np.testing.assert_allclose(got["label"], want["label"], rtol=0, atol=1e-6)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tpredict.predict(str(root / "graph.json"), str(root / "snap_iter2"), rp(th), max_batches=1)


def test_predict_cli_writes_the_predictions(served, tmp_path, capsys):
    """`python -m hugectr_tpu_torch.tools.predict ... --device cpu
    --max-batches 1` writes the first batch's predictions as `.npy`."""
    root, rp, want = served
    out = tmp_path / "preds.npy"
    tpredict.main(["--graph", str(root / "graph.json"), "--snapshot", str(root / "snap_iter2"),
                   "--data-reader-type", "synthetic", "--source", "unused", "--max-batches", "1",
                   "--output", str(out), "--device", "cpu"])
    assert f"{fns.GRAPH_B} rows across 1 head(s)" in capsys.readouterr().out
    np.testing.assert_allclose(np.load(out), want["label"][: fns.GRAPH_B], rtol=0, atol=1e-6)


def test_reshape_graph_needs_a_batch_size_in_both_converters(tmp_path):
    """A fault of the reference, kept by the port's copy for the same bytes
    (ROADMAP "Faults of the reference"): without `batch_size` the graph's
    batch is the symbol "batch", and a Reshape's shape inference takes
    np.prod of it (hugectr_tpu/tools/hugectr2onnx.py:362), so a graph with
    a Reshape (DLRM-FTRL's) does not convert; with a batch size both
    converters write the same bytes, and so does the port's command line."""
    from hugectr_tpu_torch.tools.flagship import build_tiny_dlrm_ftrl

    tm = build_tiny_dlrm_ftrl(ResourceManager.create(device="cpu"))
    tm.graph_to_json(str(tmp_path / "g.json"))
    tm.download_params_to_files(str(tmp_path / "s"), 1)
    snap = str(tmp_path / "s_iter1")
    for conv in (jt.hugectr2onnx, tconv):
        with pytest.raises(TypeError):  # numpy's no-loop error for str * str
            conv.convert(str(tmp_path / "x.onnx"), str(tmp_path / "g.json"), snap)
    jt.hugectr2onnx.convert(str(tmp_path / "j.onnx"), str(tmp_path / "g.json"), snap, batch_size=64)
    tconv.convert(str(tmp_path / "t.onnx"), str(tmp_path / "g.json"), snap, batch_size=64)
    assert (tmp_path / "t.onnx").read_bytes() == (tmp_path / "j.onnx").read_bytes()
    # the command line (the root hugectr2onnx/converter.py's flags)
    tconv.main(["--onnx_model_path", str(tmp_path / "c.onnx"), "--graph_config", str(tmp_path / "g.json"),
                "--dense_model", snap, "--batch_size", "64"])
    assert (tmp_path / "c.onnx").read_bytes() == (tmp_path / "j.onnx").read_bytes()
