"""The slice end to end: DLRM with FTRL, static and with exact dynamic
tables. The JAX side is `samples/dlrm_ftrl.py` itself, run with `runpy`
(its reader replaced by the synthetic one, its tables capped at 200 rows,
dynamic capacity 200); the port's side is `build_tiny_dlrm_ftrl` on the
CPU. Both train 3 steps from the same state (carried from JAX, key stores
included) on the same synthetic batches, then evaluate.

Tolerances: loss rtol 1e-4 per step; every table, the dense parameters and
the FTRL state z and n rtol 1e-4 / atol 1e-5 after step 3 (float32 sums in
another order). FTRL sets a weight to 0 where |z| <= lambda1 (0.01): the
elements whose z lies within 1e-6 of the threshold are left out of the
weight comparison, counted, and required to be few. Key stores bit-equal;
the eval AUC within 1e-6.
"""
import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

import hugectr_tpu
from hugectr_tpu.embedding import sparse_optimizer as jso

from hugectr_tpu_torch import ops
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.tools import flagship as tflagship
from hugectr_tpu_torch.tools.carry import load_jax_state

from test_torch_optimizers import assert_ftrl_close

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
LAMBDA1 = 0.01
SAMPLES = os.path.join(os.path.dirname(__file__), "..", "samples")


def _jax_env(dynamic: bool) -> dict:
    """The JAX package's engine settings equal to `TINY_FTRL` (and
    `TINY_FTRL_DYNAMIC`)."""
    kw = dict(tflagship.TINY_FTRL, **(tflagship.TINY_FTRL_DYNAMIC if dynamic else {}))
    return {"HCTR_TPU_ONEHOT_VOCAB": str(kw["onehot_vocab"]), "HCTR_TPU_SPLIT_VOCAB": str(kw["split_vocab"]),
            "HCTR_TPU_DENSE_UPDATE_ROWS": str(kw["dense_update_rows"]), "HCTR_TPU_SEGSUM": "scan",
            "HCTR_TPU_ONEHOT_KERNEL": "pallas", "HCTR_TPU_HOT_ROWS": "0"}


def _sample_model(monkeypatch, dynamic: bool, num_devices: int = 1):
    """samples/dlrm_ftrl.py as a JAX model at the tiny size, on a mesh of
    `num_devices` devices."""
    for k, v in _jax_env(dynamic).items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("HCTR_TPU_EMB_DTYPE", raising=False)
    cap = tflagship.TINY_FTRL["vocab_cap"]
    orig = hugectr_tpu.EmbeddingTableConfig

    def capped(**kw):
        if kw["max_vocabulary_size"] > 0:
            kw["max_vocabulary_size"] = min(kw["max_vocabulary_size"], cap)
        kw["dynamic_capacity"] = min(kw["dynamic_capacity"], tflagship.TINY_FTRL["dynamic_capacity"])
        return orig(**kw)

    monkeypatch.setattr(hugectr_tpu, "EmbeddingTableConfig", capped)
    monkeypatch.syspath_prepend(SAMPLES)
    import common as sample_common

    monkeypatch.setattr(sample_common, "make_reader", lambda args, sizes, nnz_array=None, **kw: (
        hugectr_tpu.DataReaderParams(data_reader_type="synthetic",
                                     synthetic_num_batches=tflagship.TINY_FTRL["synthetic_batches"],
                                     synthetic_alpha=1.05)))
    argv = ["dlrm_ftrl", "--batchsize", str(tflagship.TINY_FTRL["batchsize"]), "--num_devices", str(num_devices)]
    monkeypatch.setattr(sys, "argv", argv + (["--use_dynamic_hash_table"] if dynamic else []))
    model = runpy.run_path(os.path.join(SAMPLES, "dlrm_ftrl.py"), run_name="not_main")["model"]
    model.compile()
    return model


def _jax_routes(jm) -> dict:
    """Each group's update route by the JAX package's rule for FTRL
    (sparse_optimizer.py:440-447: the one-hot engine, the dense sweep for
    shards of at most `dense_update_rows` rows, no key-ratio rule)."""
    limit = jso.dense_update_rows()
    return {g.name: "onehot" if g.compute_kind == "onehot"
            else "dense" if 0 < g.total_storage_rows <= limit else "sorted"
            for g in jm.ec.plan.groups}


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_dlrm_ftrl_three_steps_match_jax(monkeypatch, dynamic):
    jm = _sample_model(monkeypatch, dynamic)
    tm = tflagship.build_tiny_dlrm_ftrl(ResourceManager.create(device="cpu"), dynamic=dynamic)
    assert [(g.name, g.compute_kind) for g in tm.ec.plan.groups] == [
        (g.name, g.compute_kind) for g in jm.ec.plan.groups]
    state = jax.device_get(jm.state)
    assert sorted(state["dopt"]) == sorted(tm.dopt) == ["n", "z"]
    keys = [g for g in state["emb_tables"] if g.endswith("#keys")]
    assert keys == (["mp_ev128#keys"] if dynamic else [])
    load_jax_state(tm, state)
    ops.reset_counts()
    for step in range(3):
        jl, tl = jm.train(), tm.train()
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"loss at step {step + 1}")
    assert tm.ec.group_routes == _jax_routes(jm)
    routes = set(tm.ec.group_routes.values())
    assert routes == ({"dense"} if dynamic else {"onehot", "dense", "sorted"})
    n_onehot = 0 if dynamic else len(next(g for g in tm.ec.plan.groups if g.compute_kind == "onehot").lookups)
    n_sorted = sum(r == "sorted" for r in tm.ec.group_routes.values())
    n_dense = sum(r == "dense" for r in tm.ec.group_routes.values())
    # FTRL's dense sweep sums its gradient rows with the drop-mode scatter;
    # its sorted groups update by the drop-mode row update
    assert ops.plain_counts() == {"segscan": 3 * n_sorted, "onehot_fwd": 3 * (n_onehot > 0),
                                  "onehot_bwd": 3 * (n_onehot > 0), "ordered_pool": 0,
                                  "row_scatter": 3 * n_dense, "adagrad_rows": 0,
                                  "ftrl_rows": 3 * n_sorted, "adam_rows": 0, "dropout_mask": 0}
    assert set(ops.launch_counts().values()) == {0}

    state = jax.device_get(jm.state)
    for g, arr in state["emb_tables"].items():
        if g.endswith("#keys"):
            np.testing.assert_array_equal(tm.tables[g].numpy(), arr)
            assert (arr != 2**31 - 1).sum() > 100
            continue
        assert_ftrl_close(tm.tables[g].numpy(), np.asarray(arr), np.asarray(state["eopt"][g]["z"]), LAMBDA1,
                          TOL, f"table {g}")
        for k in ("z", "n"):
            np.testing.assert_allclose(tm.eopt[g][k].numpy(), state["eopt"][g][k], **TOL, err_msg=f"{g} {k}")
    params = tm.network.param_tree()
    for layer, ps in state["dense_params"].items():
        for k, v in ps.items():
            assert_ftrl_close(params[layer][k].detach().numpy(), v, state["dopt"]["z"][layer][k], LAMBDA1, TOL,
                              f"{layer}/{k}")
            for s in ("z", "n"):
                np.testing.assert_allclose(tm.dopt[s][layer][k].numpy(), state["dopt"][s][layer][k], **TOL,
                                           err_msg=f"{s} {layer}/{k}")
    np.testing.assert_allclose(tm.eval()["auc"], jm.eval()["auc"], atol=1e-6)
