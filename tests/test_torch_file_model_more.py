"""Training from files against the JAX package on the CPU, continued
(tests/test_torch_file_model.py): DLRM with FTRL (samples/dlrm_ftrl.py)
from Norm files, and the criteo_parquet sample over Parquet that the test
writes into a temporary `--data_dir`, read through the sample's own
`make_reader` (JAX: the sample run with `runpy`; port: `build_tiny_sample`
given the same `DataReaderParams`). The tolerances are those of
tests/test_torch_dlrm_ftrl.py and tests/test_torch_samples.py.
"""
import os
import runpy
import sys

import jax
import numpy as np
import torch

import hugectr_tpu as jh
import hugectr_tpu_torch as th
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.tools import flagship as tflagship
from hugectr_tpu_torch.tools.carry import load_jax_state
from hugectr_tpu_torch.tools.samples import TINY_SAMPLE, build_tiny_sample

from test_torch_file_model import TOL, close
from test_torch_samples import JAX_ENV as SAMPLE_ENV
from test_torch_samples import assert_eval_close, host_state

torch.set_num_threads(1)
SAMPLES = os.path.join(os.path.dirname(__file__), "..", "samples")


def test_dlrm_ftrl_trains_from_norm_as_jax(tmp_path, monkeypatch):
    """samples/dlrm_ftrl.py (JAX, `runpy`, its reader made a Norm one over
    the files) against `build_tiny_dlrm_ftrl(reader=...)`: 3 steps and an
    eval over 3 batches, the tolerances of tests/test_torch_dlrm_ftrl.py;
    the eval's predictions rtol 1e-5."""
    from test_torch_dlrm_ftrl import LAMBDA1
    from test_torch_optimizers import assert_ftrl_close

    sizes = [min(v, tflagship.TINY_FTRL["vocab_cap"]) for v in tflagship.FTRL_SLOT_SIZES]
    p = th.DataGeneratorParams(format="norm", num_slot=26, slot_size_array=sizes, check_type="sum", num_files=2,
                               eval_num_files=1, num_samples_per_file=96, source=str(tmp_path / "train.txt"),
                               eval_source=str(tmp_path / "eval.txt"), seed=3)
    th.DataGenerator(p).generate()
    fields = dict(data_reader_type="norm", source=[p.source], eval_source=p.eval_source, slot_size_array=sizes)
    jm = ftrl_sample(monkeypatch, jh.DataReaderParams(**fields))
    tm = tflagship.build_tiny_dlrm_ftrl(ResourceManager.create(device="cpu"), reader=th.DataReaderParams(**fields))
    try:
        load_jax_state(tm, jax.device_get(jm.state))
        for step in range(3):
            np.testing.assert_allclose(tm.train(), jm.train(), rtol=1e-4, err_msg=f"loss at step {step + 1}")
        state = jax.device_get(jm.state)
        for g, arr in state["emb_tables"].items():
            assert_ftrl_close(tm.tables[g].numpy(), np.asarray(arr), np.asarray(state["eopt"][g]["z"]), LAMBDA1,
                              TOL, f"table {g}")
        jm.eval(), tm.eval()
        # three FTRL steps leave every prediction within a few ulps of 0.4998,
        # so the AUC ranks rounding: the eval's predictions and labels are held
        n = tm.metrics._nb * tm.metrics.batch_size
        assert tm.metrics._nb == jm.metrics._nb == 3
        np.testing.assert_allclose(tm.metrics._preds[:n].numpy(), np.asarray(jm.metrics._preds)[:n], rtol=1e-5)
        np.testing.assert_array_equal(tm.metrics._labels[:n].numpy(), np.asarray(jm.metrics._labels)[:n])
    finally:
        close(jm, tm)


def ftrl_sample(mp, reader, dynamic: bool = False, i64: bool = False, num_devices: int = 1):
    """samples/dlrm_ftrl.py as a JAX model at the tiny size reading
    `reader` (a JAX `DataReaderParams`), with `i64_input_key`."""
    from test_torch_dlrm_ftrl import _jax_env

    orig = jh.CreateSolver
    mp.setattr(jh, "CreateSolver", lambda **kw: orig(**dict(kw, i64_input_key=i64)))
    mp.syspath_prepend(SAMPLES)
    import common as sample_common

    for k, v in _jax_env(dynamic).items():
        mp.setenv(k, v)
    mp.delenv("HCTR_TPU_EMB_DTYPE", raising=False)
    cap = tflagship.TINY_FTRL["vocab_cap"]
    orig_t = jh.EmbeddingTableConfig

    def capped(**kw):
        if kw["max_vocabulary_size"] > 0:
            kw["max_vocabulary_size"] = min(kw["max_vocabulary_size"], cap)
        kw["dynamic_capacity"] = min(kw["dynamic_capacity"], tflagship.TINY_FTRL["dynamic_capacity"])
        return orig_t(**kw)

    mp.setattr(jh, "EmbeddingTableConfig", capped)
    mp.setattr(sample_common, "make_reader", lambda *a, **kw: reader)
    argv = ["dlrm_ftrl", "--batchsize", str(tflagship.TINY_FTRL["batchsize"]), "--num_devices", str(num_devices)]
    mp.setattr(sys, "argv", argv + (["--use_dynamic_hash_table"] if dynamic else []))
    model = runpy.run_path(os.path.join(SAMPLES, "dlrm_ftrl.py"), run_name="not_main")["model"]
    model.compile()
    return model


def test_criteo_parquet_sample_reads_its_data_dir(tmp_path, monkeypatch):
    """samples/criteo_parquet.py with `--data_dir` holding Parquet the
    port's `DataGenerator` wrote (the file names its `make_reader` looks
    for), against `build_tiny_sample("criteo_parquet", reader=...)` given
    the sample's own reader parameters: 3 steps and the eval."""
    import hugectr_tpu

    from test_torch_samples import assert_state_close

    cap = TINY_SAMPLE["slot_cap"]
    d = tmp_path / "criteo"
    d.mkdir()
    th.DataGenerator(th.DataGeneratorParams(
        format="parquet", num_slot=26, slot_size_array=[cap] * 26, num_files=2, eval_num_files=1,
        num_samples_per_file=128, source=str(d / "file_list.txt"), eval_source=str(d / "file_list_test.txt"),
        seed=11)).generate()
    mp = monkeypatch
    for k, v in SAMPLE_ENV.items():
        mp.setenv(k, v)
    mp.delenv("HCTR_TPU_EMB_DTYPE", raising=False)
    orig = hugectr_tpu.SparseEmbedding
    mp.setattr(hugectr_tpu, "SparseEmbedding",
               lambda **kw: orig(**dict(kw, slot_size_array=[min(v, cap) for v in kw["slot_size_array"]])))
    mp.syspath_prepend(SAMPLES)
    mp.setattr(sys, "argv", ["criteo", "--batchsize", str(TINY_SAMPLE["batchsize"]), "--num_devices", "1",
                             "--data_dir", str(d)])
    jm = runpy.run_path(os.path.join(SAMPLES, "criteo_parquet.py"), run_name="not_main")["model"]
    jm.compile()
    jrp = jm.reader_params
    assert jrp.data_reader_type == hugectr_tpu.DataReaderType_t.Parquet and jrp.source == [str(d / "file_list.txt")]
    trp = th.DataReaderParams(data_reader_type=jrp.data_reader_type.value, source=list(jrp.source),
                              eval_source=jrp.eval_source, slot_size_array=list(jrp.slot_size_array),
                              num_workers=jrp.num_workers)
    tm = build_tiny_sample("criteo_parquet", ResourceManager.create(device="cpu"), reader=trp)
    try:
        load_jax_state(tm, host_state(jm))
        for step in range(3):
            np.testing.assert_allclose(tm.train(), jm.train(), rtol=1e-4, err_msg=f"loss at step {step + 1}")
        st = host_state(jm)
        assert_state_close(st, {g: t.numpy() for g, t in tm.tables.items()},
                           {g: {k: t.numpy() for k, t in s.items()} for g, s in tm.eopt.items()},
                           {layer: {k: p.detach().numpy() for k, p in ps.items()}
                            for layer, ps in tm.network.param_tree().items()},
                           {kind: {layer: {k: t.numpy() for k, t in ps.items()} for layer, ps in tree.items()}
                            for kind, tree in tm.dopt.items()}, lr=0.001)
        assert_eval_close(tm.eval(), jm.eval())
    finally:
        close(jm, tm)
