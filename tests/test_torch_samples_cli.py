"""The sample scripts as a user starts them (`python -m
hugectr_tpu_torch.samples.<name>`), against the JAX package's samples/.

- Graphs: for each argv of tests/test_samples.py:14-25 and for
  `dlrm_dcnv2` with and without `--use_mixed_precision`, the JAX script and
  the port's module run with `runpy` on the same argv (plus `--device cpu`
  for the port), each script's `make_reader` writing a tiny Parquet set in
  `tmp_path` as tests/test_samples.py:84-92 makes one (slots capped at 500
  rows, 2 files of 256 rows). `graph_to_json` of the two models is equal
  field for field (`assert_graphs_equal`: the solver on the fields both
  packages set), with a `--lr` and a `--batchsize` of the test's own, so a
  flag that is parsed but not passed on shows.
- Parsers: each port script takes the JAX script's options, and
  `--device` besides (the port's entry points run on the card unless
  asked for the CPU).
- Training through the CLI: `dcn` and `dlrm_ftrl --use_dynamic_hash_table`
  train 3 steps on the same Parquet files (written by the port's
  `make_reader`) from JAX's carried state, Dropout at rate 0 in both:
  losses rtol 1e-4 a step, the state at tests/test_torch_samples.py's and
  tests/test_torch_dlrm_ftrl.py's tolerances, key stores bitwise.
"""
import argparse
import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

import hugectr_tpu
import hugectr_tpu_torch
from hugectr_tpu_torch import ops
from hugectr_tpu_torch.samples import common as port_common
from hugectr_tpu_torch.tools.carry import load_jax_state

from test_torch_dlrm_ftrl import LAMBDA1, TOL as FTRL_TOL
from test_torch_optimizers import assert_ftrl_close
from test_torch_samples import _graph, assert_graphs_equal, assert_state_close, host_state

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
JAX_SAMPLES = os.path.join(ROOT, "samples")
PORT_SAMPLES = os.path.join(ROOT, "hugectr_tpu_torch", "samples")
ARGVS = [
    "criteo_parquet", "wdl", "dcn", "deepfm", "ncf", "mmoe", "din", "bst", "ncf --variant ncf",
    "ncf --variant neumf", "mmoe --variant shared_bottom", "dlrm_ftrl", "dlrm_ftrl --use_dynamic_hash_table",
    "dlrm_dcnv2", "dlrm_dcnv2 --use_mixed_precision",
]
# the port's defaults of the engine settings, set in the JAX package's environment
JAX_ENV = {"HCTR_TPU_ONEHOT_VOCAB": "8192", "HCTR_TPU_SPLIT_VOCAB": str(256 * 1024),
           "HCTR_TPU_DENSE_UPDATE_ROWS": "262144", "HCTR_TPU_DENSE_KEY_RATIO": "0.3", "HCTR_TPU_SEGSUM": "xla",
           "HCTR_TPU_HOT_ROWS": "0"}


def _tiny(make_reader):
    """`make_reader` writing tests/test_samples.py:84-92's tiny set."""
    def small_reader(args, slot_sizes, nnz_array=None, **kw):
        kw.update(num_samples_per_file=256, num_files=2)
        return make_reader(args, [min(s, 500) for s in slot_sizes], nnz_array=nnz_array, **kw)

    return small_reader


def _argv(spec: str, data_dir, extra=()):
    name, *flags = spec.split()
    if name == "dlrm_dcnv2":
        return name, [name, "--batchsize", "64", "--vocab_cap", "500", "--lr", "0.004", "--num_devices", "1",
                      *flags, *extra]
    return name, [name, "--data_dir", str(data_dir), "--batchsize", "64", "--lr", "0.002", "--num_devices", "1",
                  *flags, *extra]


@pytest.fixture
def runners(monkeypatch):
    """(run the JAX script, run the port's module), each with a tiny
    Parquet reader, on one device (JAX) or the CPU (the port)."""
    for k, v in JAX_ENV.items():
        monkeypatch.setenv(k, v)
    for k in ("HCTR_TPU_EMB_DTYPE", "HCTR_TPU_EMB_STATE_DTYPE", "HCTR_BENCH_OPT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.syspath_prepend(JAX_SAMPLES)
    import common as jax_common

    monkeypatch.setattr(jax_common, "make_reader", _tiny(jax_common.make_reader))
    monkeypatch.setattr(port_common, "make_reader", _tiny(port_common.make_reader))

    def run_jax(spec, data_dir):
        name, argv = _argv(spec, data_dir)
        monkeypatch.setattr(sys, "argv", argv)
        return runpy.run_path(os.path.join(JAX_SAMPLES, f"{name}.py"), run_name="not_main")["model"]

    def run_port(spec, data_dir):
        name, argv = _argv(spec, data_dir, ["--device", "cpu"])
        monkeypatch.setattr(sys, "argv", argv)
        return runpy.run_path(os.path.join(PORT_SAMPLES, f"{name}.py"), run_name="not_main")["model"]

    return run_jax, run_port


@pytest.mark.parametrize("spec", ARGVS, ids=[a.replace(" --", "-") for a in ARGVS])
def test_sample_graph_equals_the_jax_scripts(spec, runners, tmp_path):
    run_jax, run_port = runners
    jm, tm = run_jax(spec, tmp_path / "jax"), run_port(spec, tmp_path / "port")
    assert tm.device.type == "cpu"
    jg, tg = _graph(jm, tmp_path / "jax.json"), _graph(tm, tmp_path / "port.json")
    assert_graphs_equal(tg, jg)
    assert tg["solver"]["lr"] == jg["solver"]["lr"] == (0.0045 if spec.startswith("ncf") else
                                                         0.004 if spec.startswith("dlrm_dcnv2") else 0.002)
    assert tg["solver"]["batchsize"] == 64
    if not spec.startswith("dlrm_dcnv2"):  # the Parquet set each script wrote, in its own directory
        assert (tmp_path / "port" / "file_list.txt").exists() and (tmp_path / "jax" / "file_list.txt").exists()


class _Parsed(Exception):
    pass


def _options(monkeypatch, path):
    """The option strings of the parser `path` builds at module level."""
    seen = {}

    def parse(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(_Parsed):
        runpy.run_path(path, run_name="not_main")
    return {s for a in seen["parser"]._actions for s in a.option_strings}


def test_each_parser_takes_the_jax_scripts_options_and_device(monkeypatch):
    monkeypatch.syspath_prepend(JAX_SAMPLES)
    names = sorted({a.split()[0] for a in ARGVS})
    assert sorted(f[:-3] for f in os.listdir(PORT_SAMPLES) if f.endswith(".py")) == sorted(
        names + ["__init__", "common"])
    for name in names:
        jopts = _options(monkeypatch, os.path.join(JAX_SAMPLES, f"{name}.py"))
        topts = _options(monkeypatch, os.path.join(PORT_SAMPLES, f"{name}.py"))
        assert topts == jopts | {"--device"}, name


def _dropout_off(monkeypatch):
    for mod in (hugectr_tpu, hugectr_tpu_torch):
        orig = mod.DenseLayer

        def no_dropout(_orig=orig, _mod=mod, **kw):
            if kw["layer_type"] == _mod.Layer_t.Dropout:
                kw["dropout_rate"] = 0.0
            return _orig(**kw)

        monkeypatch.setattr(mod, "DenseLayer", no_dropout)


@pytest.mark.parametrize("spec", ["dcn", "dlrm_ftrl --use_dynamic_hash_table"], ids=["dcn", "dlrm_ftrl_dynamic"])
def test_sample_cli_trains_as_the_jax_script(spec, runners, monkeypatch, tmp_path):
    run_jax, run_port = runners
    _dropout_off(monkeypatch)
    tm = run_port(spec, tmp_path)  # writes the Parquet set
    files = sorted(os.listdir(tmp_path / "file_list.txt.d"))
    jm = run_jax(spec, tmp_path)  # reads the same files
    assert sorted(os.listdir(tmp_path / "file_list.txt.d")) == files
    jm.compile()
    tm.compile()
    try:
        assert [(g.name, g.compute_kind) for g in tm.ec.plan.groups] == [
            (g.name, g.compute_kind) for g in jm.ec.plan.groups]
        load_jax_state(tm, jax.device_get(jm.state))
        ops.reset_counts()
        for step in range(3):
            jl, tl = jm.train(), tm.train()
            np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"{spec} loss at step {step + 1}")
        if spec == "dcn":
            params = tm.network.param_tree()
            assert_state_close(
                host_state(jm), {g: t.numpy() for g, t in tm.tables.items()},
                {g: {k: t.numpy() for k, t in st.items()} for g, st in tm.eopt.items()},
                {layer: {k: p.detach().numpy() for k, p in ps.items()} for layer, ps in params.items()},
                {kind: {layer: {k: t.numpy() for k, t in ps.items()} for layer, ps in tree.items()}
                 for kind, tree in tm.dopt.items()}, tm.solver.lr, spec)
            return
        state = jax.device_get(jm.state)
        for g, arr in state["emb_tables"].items():
            if g.endswith("#keys"):
                np.testing.assert_array_equal(tm.tables[g].numpy(), arr)
                assert (arr != 2**31 - 1).sum() > 100
                continue
            assert_ftrl_close(tm.tables[g].numpy(), np.asarray(arr), np.asarray(state["eopt"][g]["z"]), LAMBDA1,
                              FTRL_TOL, f"table {g}")
            for k in ("z", "n"):
                np.testing.assert_allclose(tm.eopt[g][k].numpy(), state["eopt"][g][k], **FTRL_TOL, err_msg=k)
    finally:
        tm._close_readers()
