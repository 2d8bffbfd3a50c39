"""Training from files, end to end, against the JAX package on the CPU.

The tiny DLRM-DCNv2 of tests/test_torch_model.py reads Raw (the native
reader; int and float layouts), Parquet and Norm files that the port's
`DataGenerator` wrote, in both packages, from the same carried state: 3
steps, then an eval over the eval file (Parquet and Norm with
`drop_incomplete_batch=False`, so their eval ends in a padded tail batch
that counts in the metrics in both). Tolerances are that file's: loss rtol
1e-4 per step; every table and the dense parameters rtol 1e-4 / atol 1e-5
after step 3; the eval AUC within 1e-6 (the same predictions up to float32
summation order).

The reader API as in the JAX package: `read_a_batch_to_device` returns a
padded tail's true row count and 0 at EOF, `is_eof`, `is_started`,
`set_source`; the native Raw path drops the eval file's tail (whole global
batches only, raw_reader.cpp) even with `drop_incomplete_batch=False`, and
reads in file order whatever `AsyncParam.shuffle` says.

tests/test_torch_file_model_more.py holds DLRM-FTRL from Norm files and
the criteo_parquet sample over its `--data_dir`, and
tests/test_torch_file_model_hybrid.py the Raw file at W = 2.
"""
import os

import jax
import numpy as np
import pytest
import torch

import hugectr_tpu as jh
import hugectr_tpu_torch as th
from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.tools import flagship as jflagship
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.data.native_reader import NativeRawReader
from hugectr_tpu_torch.tools import flagship as tflagship
from hugectr_tpu_torch.tools.carry import load_jax_state

from test_torch_model import ENGINE, JAX_ENV

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
BATCH = 64
TINY = dict(ev_size=16, vocab_cap=1000, bottom_mlp=(32, 16), top_mlp=(32, 16, 1), projection_dim=8,
            num_cross_layers=2, batchsize=BATCH, max_eval_batches=8)
SIZES = [min(v, 1000) for v in tflagship.MLPERF_TABLE_SIZES]


def generate(out: str, fmt: str, **kw) -> th.DataGeneratorParams:
    """The flagship's slots (capped at 1,000 rows) and hotness: Raw, 4
    train batches and 160 eval rows (2.5 batches); Parquet and Norm, 2
    train files of 150 rows and one eval file of 150."""
    ext = "bin" if fmt == "raw_async" else "txt"
    p = th.DataGeneratorParams(
        format=fmt, num_slot=26, slot_size_array=SIZES, nnz_array=tflagship.MLPERF_MULTI_HOT_SIZES,
        num_samples=4 * BATCH, eval_num_samples=2 * BATCH + 32, num_files=2, eval_num_files=1,
        num_samples_per_file=150, source=os.path.join(out, f"train.{ext}"),
        eval_source=os.path.join(out, f"eval.{ext}"), seed=7, **kw)
    th.DataGenerator(p).generate()
    return p


def reader_fields(fmt: str, p, **extra) -> dict:
    """`DataReaderParams` fields of both packages for files `p`."""
    kw = dict(data_reader_type=fmt, source=[p.source], eval_source=p.eval_source, **extra)
    if fmt == "norm":
        kw["slot_size_array"] = SIZES  # Norm keys carry the slots' offsets
    return kw


FORMATS = {
    # name: (format, generator kwargs, reader kwargs, AsyncParam kwargs)
    "raw_int": ("raw_async", {}, {}, dict(num_threads=2, is_dense_float=False)),
    "raw_float": ("raw_async", dict(float_label_dense=True), dict(float_label_dense=True), None),
    "parquet": ("parquet", {}, dict(num_workers=2), None),
    "norm": ("norm", dict(check_type="sum"), {}, None),
}


def tail_solver(mp, drop: bool):
    """The JAX flagship's `CreateSolver` with `drop_incomplete_batch` set."""
    orig = jh.CreateSolver
    mp.setattr(jh, "CreateSolver", lambda **kw: orig(**dict(kw, drop_incomplete_batch=drop)))


def build_pair(mp, fields: dict, async_kw=None, drop: bool = True, **kw):
    """(JAX model, port model) of the tiny DLRM-DCNv2 over the same files,
    the port carrying the JAX model's initial state."""
    for k, v in JAX_ENV.items():
        mp.setenv(k, v)
    mp.delenv("HCTR_TPU_EMB_DTYPE", raising=False)
    tail_solver(mp, drop)
    jr = jh.DataReaderParams(**fields, async_param=jh.AsyncParam(**async_kw) if async_kw else None)
    tr = th.DataReaderParams(**fields, async_param=th.AsyncParam(**async_kw) if async_kw else None)
    jm = jflagship.build_dlrm_dcnv2(JaxResourceManager.create(num_devices=1), reader=jr, **dict(TINY, **kw))
    tm = tflagship.build_dlrm_dcnv2(ResourceManager.create(device="cpu"), reader=tr, drop_incomplete_batch=drop,
                                    **ENGINE, **dict(TINY, **kw))
    load_jax_state(tm, jax.device_get(jm.state))
    return jm, tm


def close(*models):
    """Stop the port models' feeders and close their readers. The JAX
    models' are left alone: their native reader's `close` frees the core
    while a feeder thread may still wait in it (`rr_next`), and their
    feeder threads are daemons blocked on a full queue."""
    for m in models:
        if isinstance(m, th.Model):
            m._close_readers()


def assert_tables_close(tm, jm):
    state = jax.device_get(jm.state)
    params = tm.network.param_tree()
    for layer, ps in state["dense_params"].items():
        for k, v in ps.items():
            np.testing.assert_allclose(params[layer][k].detach().numpy(), v, **TOL, err_msg=f"{layer}/{k}")
    for i in range(26):
        np.testing.assert_allclose(tm.ec.export_table(tm.tables, str(i)),
                                   jm.ec.export_table(state["emb_tables"], str(i)), **TOL, err_msg=f"table {i}")


@pytest.mark.parametrize("name", list(FORMATS))
def test_tiny_dlrm_trains_from_files_as_jax(tmp_path, monkeypatch, name):
    fmt, gen_kw, rd_kw, async_kw = FORMATS[name]
    p = generate(str(tmp_path), fmt, **gen_kw)
    drop = fmt in ("raw_async",)  # Parquet and Norm evaluate a padded tail
    jm, tm = build_pair(monkeypatch, reader_fields(fmt, p, **rd_kw), async_kw, drop=drop)
    try:
        if fmt == "raw_async":
            assert isinstance(tm.train_reader, NativeRawReader)
            assert tm._fused_float == (name == "raw_float")
        for step in range(3):
            jl, tl = jm.train(), tm.train()
            np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"loss at step {step + 1}")
        up = tm._train_feeder.uploader  # one fused upload a batch, or one a column
        assert up.batches >= 3 and up.bytes >= 3 * BATCH * (1 + 13 + sum(tflagship.MLPERF_MULTI_HOT_SIZES)) * 4
        assert_tables_close(tm, jm)
        jv, tv = jm.eval(), tm.eval()
        assert abs(tv["auc"] - jv["auc"]) <= 1e-6, (tv, jv)
        for h in (tm.get_data_reader_eval(), jm.get_data_reader_eval()):
            assert h.is_eof() and h.is_started()
        # 2 whole eval batches and a tail, which the native reader drops
        assert tm.metrics._nb == jm.metrics._nb == (2 if drop else 3)
    finally:
        close(jm, tm)


def test_tail_counts_eof_and_set_source_as_jax(tmp_path, monkeypatch):
    """A non-repeating Parquet train source (300 rows: 4 batches and a
    padded tail of 44 rows): `read_a_batch_to_device` returns 64 four times,
    then 44, then 0 with `is_eof()`; `train()` then raises StopIteration;
    `set_source` clears EOF and starts over. The eval handle reads the
    eval file's 2 batches and its tail of 22 on the host, then EOF."""
    p = generate(str(tmp_path), "parquet")
    fields = reader_fields("parquet", p, num_workers=1)
    for k, v in JAX_ENV.items():
        monkeypatch.setenv(k, v)
    orig = jh.CreateSolver
    monkeypatch.setattr(jh, "CreateSolver",
                        lambda **kw: orig(**dict(kw, repeat_dataset=False, drop_incomplete_batch=False)))
    jm = jflagship.build_dlrm_dcnv2(JaxResourceManager.create(num_devices=1), reader=jh.DataReaderParams(**fields),
                                    **TINY)
    tm = tflagship.build_dlrm_dcnv2(ResourceManager.create(device="cpu"), reader=th.DataReaderParams(**fields),
                                    drop_incomplete_batch=False, repeat_dataset=False, **ENGINE, **TINY)
    try:
        for m in (jm, tm):
            h = m.get_data_reader_train()
            assert not h.is_started()
            assert [h.read_a_batch_to_device() for _ in range(6)] == [64, 64, 64, 64, 44, 0]
            assert h.is_eof() and h.is_started()
            with pytest.raises(StopIteration):
                m.train()
            h.set_source(p.source)
            assert not h.is_eof()
            assert h.read_a_batch_to_device() == 64
            e = m.get_data_reader_eval()
            assert [e.read_a_batch_to_device() for _ in range(4)] == [64, 64, 22, 0]
            assert e.is_eof()
            e.set_source(p.eval_source)
            assert not e.is_eof() and e.read_a_batch_to_device() == 64
        load_jax_state(tm, jax.device_get(jm.state))
        np.testing.assert_allclose(tm.train(), jm.train(), rtol=1e-4)  # the staged first batch
    finally:
        close(jm, tm)


def test_native_path_drops_the_tail_and_ignores_shuffle(tmp_path, monkeypatch):
    """The Model's Raw path is the native reader in both packages: with
    `drop_incomplete_batch=False` and `AsyncParam.shuffle=True` the eval
    reads 2 whole batches of the 160-row file and reaches EOF (the tail of
    32 rows is never read), and training reads the file's batches in file
    order (faults of the reference, ROADMAP Queue 3)."""
    p = generate(str(tmp_path), "raw_async")
    fields = reader_fields("raw_async", p)
    jm, tm = build_pair(monkeypatch, fields, dict(shuffle=True, is_dense_float=False), drop=False)
    try:
        assert tm.eval_reader.num_batches == jm.eval_reader.num_batches == 2
        rows = np.fromfile(p.source, np.int32).reshape(4 * BATCH, -1)
        for b in range(5):
            assert tm.read_a_batch() and jm.read_a_batch()
            got = tm._staged_train_batch["__raw_rows__"].numpy()
            np.testing.assert_array_equal(got, rows[(b % 4) * BATCH:(b % 4 + 1) * BATCH])
            np.testing.assert_array_equal(np.asarray(jm._staged_train_batch["__raw_rows__"]), got)
        jv, tv = jm.eval(), tm.eval()
        assert abs(tv["auc"] - jv["auc"]) <= 1e-6
        assert tm.get_data_reader_eval().is_eof() and jm.get_data_reader_eval().is_eof()
        assert tm.metrics._nb == jm.metrics._nb == 2
    finally:
        close(jm, tm)
