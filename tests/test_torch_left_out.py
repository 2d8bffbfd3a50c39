"""The JAX package's settings that the port leaves out (ROADMAP Queue 1,
"Left out on purpose"), each run by the JAX package against its own
default on the CPU: each gives the same numbers, bitwise, so the port,
which has one form of each, computes what either setting computes.

- Lowering and eval devices of XLA, on the tiny bench-configured model with
  bench.py's measured caps (3 steps and an eval): HCTR_TPU_EVAL_SCAN=0
  (the eval batch by batch instead of one scanned dispatch,
  model.py:1346-1410), HCTR_TPU_SCATTER_AUTO=0 (every row scatter flagged
  sorted and unique, sparse_optimizer.py:28-57), HCTR_TPU_SEGSUM_FOLD_BYTES=0
  (the segment sums split into a [K, E] and a row-id sum instead of one
  [K, E + 1] fold, :221-235, :538-567) and HCTR_TPU_SHARED_TIER_SORT=0 (each
  tier sorts its own keys instead of one sort of the split table's raw
  keys, collection.py:1728-1799). Losses, the eval's metrics and every
  table after the steps are bitwise the default run's.
- A reader variant, on the tiny DLRM-DCNv2 from Parquet files (3 steps
  and an eval): HCTR_TPU_SYNC_PARQUET=1 (the synchronous Parquet reader
  instead of the threaded one, model.py:600-606). The same.

Two probe settings that no JAX script, tool or benchmark sets are left out
too, though they change the numbers a little; the last test records by how
much, the JAX package against its own default:
- HCTR_TPU_FWD_SORTED_BYTES=1 (every rowop group of the tiny bench model on
  the sorted-gather forward, collection.py:184-194, 1487-1494): its bf16
  pools round after each add in another order than the gather-and-sum's
  float32 sums, as the compact forward of a measured cap does; held as
  tests/test_torch_bench.py holds the two packages' losses after a step
  (rtol 5e-3) and their own evals (AUC within 0.01).
- HCTR_TPU_FUSED_H2D=0 (Raw batches decoded on the host, feature by
  feature, instead of one fused int32 upload split in the step,
  model.py:530-540): the host's numpy log1p of the dense inputs and the
  step's differ in a last bit now and then; held at
  tests/test_torch_file_model.py's tolerances (losses rtol 1e-4, every
  parameter and table rtol 1e-4 / atol 1e-5, AUC within 1e-6).
"""
import jax
import numpy as np
import pytest

import hugectr_tpu as jh
from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.tools import flagship as jflagship

from test_torch_bench import JAX_ENV as BENCH_ENV
from test_torch_bench import TINY as BENCH_TINY
from test_torch_file_model import FORMATS, TINY, TOL, generate, reader_fields, tail_solver
from test_torch_model import JAX_ENV as F32_ENV

AUTO_ENV = dict(BENCH_ENV, HCTR_TPU_UCAP_FACTOR="auto", HCTR_TPU_UCAP_HEADROOM="1.05")
KNOBS = {"HCTR_TPU_EVAL_SCAN": "0", "HCTR_TPU_SCATTER_AUTO": "0", "HCTR_TPU_SEGSUM_FOLD_BYTES": "0",
         "HCTR_TPU_SHARED_TIER_SORT": "0"}
# knob: (the file format of tests/test_torch_file_model.py it changes, its value)
READER_KNOBS = {"HCTR_TPU_SYNC_PARQUET": ("parquet", "1")}
# probe knob: (the model it runs on: "bench" or a file format, its value)
PROBE_KNOBS = {"HCTR_TPU_FWD_SORTED_BYTES": ("bench", "1"), "HCTR_TPU_FUSED_H2D": ("raw_int", "0")}


def _result(jm, steps: int = 3):
    """(losses, eval metrics, every group's storage as float32)."""
    losses = [jm.train() for _ in range(steps)]
    ev = jm.eval()
    state = jax.device_get(jm.state)
    return losses, ev, {g: np.asarray(v).astype(np.float32) for g, v in state["emb_tables"].items()}


def _bench_run(mp, env=None):
    for k in (*KNOBS, *READER_KNOBS, *PROBE_KNOBS):
        mp.delenv(k, raising=False)
    for k, v in dict(AUTO_ENV, **(env or {})).items():
        mp.setenv(k, v)
    reader = jh.DataReaderParams(data_reader_type="synthetic", synthetic_num_batches=3, synthetic_alpha=1.05,
                                 synthetic_learnable=True)
    jm = jflagship.build_dlrm_dcnv2(JaxResourceManager.create(num_devices=1), reader=reader, **BENCH_TINY)
    assert jm.ec.knob_ucap_auto
    return _result(jm)


def _assert_same(got, want):
    assert got[0] == want[0], (got[0], want[0])
    assert got[1] == want[1], (got[1], want[1])
    assert sorted(got[2]) == sorted(want[2])
    for g in want[2]:
        np.testing.assert_array_equal(got[2][g], want[2][g], err_msg=g)


@pytest.fixture(scope="module")
def bench_default():
    with pytest.MonkeyPatch.context() as mp:
        return _bench_run(mp)


@pytest.mark.parametrize("knob", list(KNOBS))
def test_lowering_setting_gives_the_default_numbers(bench_default, monkeypatch, knob):
    _assert_same(_bench_run(monkeypatch, {knob: KNOBS[knob]}), bench_default)


def _file_runs(tmp_path, mp, name, knob, value, steps: int = 3):
    """The tiny DLRM-DCNv2 from files of format `name`, with `knob` unset
    and then set to `value`: [(losses, eval metrics, storage), ...]."""
    fmt, gen_kw, rd_kw, async_kw = FORMATS[name]
    p = generate(str(tmp_path), fmt, **gen_kw)
    fields = reader_fields(fmt, p, **rd_kw)
    for k, v in F32_ENV.items():
        mp.setenv(k, v)
    mp.delenv("HCTR_TPU_EMB_DTYPE", raising=False)
    tail_solver(mp, fmt == "raw_async")
    runs = []
    for setting in (None, value):
        if setting is None:
            mp.delenv(knob, raising=False)
        else:
            mp.setenv(knob, setting)
        jr = jh.DataReaderParams(**fields, async_param=jh.AsyncParam(**async_kw) if async_kw else None)
        jm = jflagship.build_dlrm_dcnv2(JaxResourceManager.create(num_devices=1), reader=jr, **TINY)
        runs.append(_result(jm, steps) + (jax.device_get(jm.state)["dense_params"],))
    return runs


@pytest.mark.parametrize("knob", list(READER_KNOBS))
def test_reader_setting_gives_the_default_numbers(tmp_path, monkeypatch, knob):
    name, value = READER_KNOBS[knob]
    runs = _file_runs(tmp_path, monkeypatch, name, knob, value)
    _assert_same(runs[1][:3], runs[0][:3])


@pytest.mark.parametrize("knob", list(PROBE_KNOBS))
def test_probe_setting_stays_near_the_default(bench_default, tmp_path, monkeypatch, knob):
    model, value = PROBE_KNOBS[knob]
    if model == "bench":
        got, want = _bench_run(monkeypatch, {knob: value}), bench_default
        np.testing.assert_allclose(got[0], want[0], rtol=5e-3)
        assert abs(got[1]["auc"] - want[1]["auc"]) < 0.01, (got[1], want[1])
        return
    (*want, want_dense), (*got, got_dense) = _file_runs(tmp_path, monkeypatch, model, knob, value)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    assert abs(got[1]["auc"] - want[1]["auc"]) <= 1e-6, (got[1], want[1])
    for g in want[2]:
        np.testing.assert_allclose(got[2][g], want[2][g], **TOL, err_msg=g)
    for layer, ps in want_dense.items():
        for k, v in ps.items():
            np.testing.assert_allclose(got_dense[layer][k], v, **TOL, err_msg=f"{layer}/{k}")
