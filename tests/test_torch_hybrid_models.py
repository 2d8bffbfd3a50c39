"""Hybrid-parallel training of the tiny models of the configurations the
port trains on one device, at W = 2 ranks against the JAX Model on a
2-device CPU mesh from the JAX model's carried state. The port's ranks are
one spawned gloo group (`tools/hybrid.py::train_model`); JAX runs in this
process. (The collections of these configurations:
`tests/test_torch_hybrid_configs.py`.)

The bench model runs the masked gather of the owned keys in both packages
(JAX with HCTR_TPU_FWD_PARTITION=0, `_mp_fwd_local`, collection.py:869-878;
the port with `fwd_partition=False`): float32 sums rounded once to bf16.
Both packages' default, the owner-partitioned forward, which rounds after
every key, is held in tests/test_torch_exchange_models.py. The dynamic
DLRM-FTRL runs both packages' defaults (float32 tables).

* The tiny bench-configured DLRM-DCNv2 (tests/test_torch_bench.py's
  tolerances): step 1 loss rtol 1e-5, steps 2-3 rtol 5e-3, each rank's
  storage after step 1 within one bf16 ulp at the tables' scale (rtol
  2^-7, atol 2^-8), the eval of each package's own weights AUC within 0.01,
  of JAX's (carried) weights AUC within 1e-6 and AverageLoss rtol 1e-5;
  every replicated array bitwise equal across the ranks.
* The tiny DLRM-FTRL with dynamic tables (tests/test_torch_dlrm_ftrl.py's):
  loss rtol 1e-4 per step, each rank's storage and FTRL state rtol 1e-4 /
  atol 1e-5 (weights whose z lies within 1e-6 of lambda1 left out, at most
  1% of them), key stores bitwise equal per shard, eval AUC within 1e-6;
  each rank's store fill and dropped keys a step.
"""
import json

import jax
import numpy as np
import pytest
import torch

import hugectr_tpu as jh
import torch_rank_fns as fns
from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.core.types import Metric_t as JMetric
from hugectr_tpu.metrics.metrics import MetricAccumulator as JAcc
from hugectr_tpu.tools import flagship as jflagship
from hugectr_tpu_torch.tools import flagship as tflagship
from hugectr_tpu_torch.tools import hybrid

from test_torch_bench import JAX_ENV as BENCH_ENV
from test_torch_bench import SPLIT as BENCH_SPLIT
from test_torch_bench import TINY as BENCH_TINY
from test_torch_dlrm_ftrl import _sample_model
from test_torch_optimizers import assert_ftrl_close

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_ULP = 2.0**-7
EMPTY = 2**31 - 1
# the unique-cap windows off, as BENCH_ENV sets them for the JAX package
BENCH_KW = dict(tflagship.bench_settings(), **BENCH_TINY, **BENCH_SPLIT, onehot_vocab=64, synthetic_learnable=True,
                metrics_spec={"auc": 0.80275, "average_loss": 0.0}, unique_cap_factor=0)
MASKED_KW = dict(BENCH_KW, fwd_partition=False)  # JAX's HCTR_TPU_FWD_PARTITION=0


def _jax_bench_model(fwd_partition="0"):
    """The tiny bench-configured JAX model on a 2-device mesh (as
    tests/test_torch_bench.py's, AUC and AverageLoss), its initial state,
    the state after step 1 and after step 3, its losses and its eval;
    HCTR_TPU_FWD_PARTITION set to `fwd_partition` (None: the default)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HCTR_TPU_FWD_PARTITION", raising=False)
        env = dict(BENCH_ENV, HCTR_TPU_FWD_PARTITION=fwd_partition) if fwd_partition else BENCH_ENV
        for k, v in env.items():
            mp.setenv(k, v)
        reader = jh.DataReaderParams(data_reader_type="synthetic", synthetic_num_batches=3, synthetic_alpha=1.05,
                                     synthetic_learnable=True)
        jm = jflagship.build_dlrm_dcnv2(JaxResourceManager.create(num_devices=2), reader=reader, **BENCH_TINY)
        jm.metrics = JAcc({JMetric.AUC: 0.80275, JMetric.AverageLoss: 0.0}, batch_size=jm.solver.batchsize_eval,
                          max_batches=jm.solver.max_eval_batches)
        s0 = jax.device_get(jm.state)
        losses = [jm.train()]
        s1 = jax.device_get(jm.state)
        losses += [jm.train() for _ in range(2)]
        s3 = jax.device_get(jm.state)
        ev = jm.eval()
    return dict(state=s0, state1=_state_tree(s1), state3=s3, losses=losses, eval=ev, plan=jm.ec.plan)


def _jax_ftrl_model():
    """samples/dlrm_ftrl.py with dynamic tables as a JAX model on a 2-device
    mesh at the tiny size: its initial state, losses, final state, eval."""
    with pytest.MonkeyPatch.context() as mp:
        jm = _sample_model(mp, dynamic=True, num_devices=2)
        s0 = jax.device_get(jm.state)
        losses = [jm.train() for _ in range(3)]
        ev = jm.eval()
        s3 = jax.device_get(jm.state)
    return dict(state=s0, losses=losses, state3=s3, eval=ev, plan=jm.ec.plan)


def _state_tree(s):
    """A JAX model's host state as `load_jax_state` reads it, bfloat16
    arrays as float32 (exact; the `.npz` files that carry it to the ranks
    hold no bfloat16)."""
    def f32(node):
        if isinstance(node, dict):
            return {k: f32(v) for k, v in node.items()}
        a = np.asarray(node)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a

    return f32({k: s[k] for k in ("emb_tables", "eopt", "dense_params", "dopt", "step")})


@pytest.fixture(scope="module")
def jax_models():
    return {"bench": _jax_bench_model(), "ftrl": _jax_ftrl_model()}


@pytest.fixture(scope="module")
def port_w2(jax_models):
    """One spawned group of 2 ranks: the tiny bench model (one step with its
    storage; three steps and an eval, then an eval of JAX's weights after
    three steps) and the tiny dynamic DLRM-FTRL (three steps and an eval),
    each from JAX's carried state."""
    jb, jf = jax_models["bench"], jax_models["ftrl"]
    bench = dict(builder="build_dlrm_dcnv2", kwargs=MASKED_KW, eval=True, export=False)
    ftrl = dict(builder="build_tiny_dlrm_ftrl", kwargs=dict(dynamic=True), steps=3, eval=True, storage=True,
                export=False)
    inputs = {
        "bench1": {"config": json.dumps(dict(bench, steps=1, eval=False, storage=True)),
                   "state": _state_tree(jb["state"])},
        "bench3": {"config": json.dumps(dict(bench, steps=3)), "state": _state_tree(jb["state"]),
                   "eval_state": _state_tree(jb["state3"])},
        "ftrl": {"config": json.dumps(ftrl), "state": _state_tree(jf["state"])},
        "calls": json.dumps({"bench1": "train_model", "bench3": "train_model", "ftrl": "train_model"}),
    }
    res = hybrid.run(fns.several, 2, inputs, device="cpu")
    return {k: [r[k] for r in res] for k in ("bench1", "bench3", "ftrl")}


def test_bench_model_on_two_ranks_matches_jax(port_w2, jax_models):
    """The tiny bench-configured DLRM-DCNv2 at W = 2 against the JAX Model
    on a 2-device mesh from the same state (tests/test_torch_bench.py's
    tolerances)."""
    jb = jax_models["bench"]
    assert jb["plan"].table_splits and any(lm.key_hi >= 0 for lm in jb["plan"].groups[0].lookups)
    for r, (one, three) in enumerate(zip(port_w2["bench1"], port_w2["bench3"])):
        np.testing.assert_allclose(one["losses"][0], jb["losses"][0], rtol=1e-5, err_msg=f"rank {r} step 1")
        np.testing.assert_allclose(three["losses"], jb["losses"], rtol=5e-3, err_msg=f"rank {r}")
        for g in jb["plan"].groups:  # within one bf16 ulp at the tables' scale
            got = one["storage"][g.name]
            want = jb["state1"]["emb_tables"][g.name]
            if g.is_model_parallel:
                want = want[r * got.shape[0] : (r + 1) * got.shape[0]]
            np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=2.0**-8, err_msg=f"rank {r} {g.name}")
        assert abs(three["eval"]["auc"] - jb["eval"]["auc"]) < 0.01
        assert abs(three["eval_carried"]["auc"] - jb["eval"]["auc"]) <= 1e-6
        np.testing.assert_allclose(three["eval_carried"]["average_loss"], jb["eval"]["average_loss"], rtol=1e-5)
    a, b = port_w2["bench3"]
    assert set(a["replicated"]) == set(b["replicated"]) and any(k.startswith("table:onehot") for k in a["replicated"])
    for k, v in a["replicated"].items():
        np.testing.assert_array_equal(b["replicated"][k], v, err_msg=k)
    assert set(a["routes"].values()) == {"onehot", "dense", "sorted"}
    for res in (a, b):
        n_sorted = sum(v == "sorted" for v in res["routes"].values())
        n_dense = sum(v == "dense" for v in res["routes"].values())
        assert res["plain_calls"] == {"onehot_fwd": 3, "onehot_bwd": 3,
                                      "segscan": 3 * n_sorted, "ordered_pool": 0,
                                      "row_scatter": 3 * n_dense, "adagrad_rows": 3 * n_sorted,
                                      "ftrl_rows": 0, "adam_rows": 0, "dropout_mask": 0}
        assert res["collective_bytes"]["reduce_scatter"] % 2 == 0


def test_dynamic_ftrl_model_on_two_ranks_matches_jax(port_w2, jax_models):
    """The tiny DLRM-FTRL with dynamic tables at W = 2 against
    samples/dlrm_ftrl.py on a 2-device mesh from the same state."""
    jf = jax_models["ftrl"]
    s3 = jf["state3"]
    lambda1 = 0.01
    for r, res in enumerate(port_w2["ftrl"]):
        np.testing.assert_allclose(res["losses"], jf["losses"], rtol=1e-4, err_msg=f"rank {r}")
        assert res["routes"] == {"mp_ev128": "dense"}
        for g, arr in s3["emb_tables"].items():
            arr = np.asarray(arr)
            n = res["storage"][g].shape[0]
            want = arr[r * n : (r + 1) * n]
            if g.endswith("#keys"):
                np.testing.assert_array_equal(res["storage"][g], want, err_msg=f"rank {r} {g}")
                assert (want != EMPTY).sum() > 50
                continue
            z = np.asarray(s3["eopt"][g]["z"])[r * n : (r + 1) * n]
            assert_ftrl_close(res["storage"][g], want, z, lambda1, TOL, f"rank {r} {g}")
            for k in ("z", "n"):
                np.testing.assert_allclose(res["state"][g][k], np.asarray(s3["eopt"][g][k])[r * n : (r + 1) * n],
                                           **TOL, err_msg=f"rank {r} {g} {k}")
        assert abs(res["eval"]["auc"] - jf["eval"]["auc"]) <= 1e-6
        fill, dropped = res["store_fill"]["mp_ev128"], res["dropped_keys"]["mp_ev128"]
        assert len(fill) == 3 and fill[-1] == int((res["storage"]["mp_ev128#keys"] != EMPTY).sum())
        assert (np.diff(fill) >= 0).all() and (dropped >= 0).all()
    a, b = port_w2["ftrl"]
    for k, v in a["replicated"].items():
        np.testing.assert_array_equal(b["replicated"][k], v, err_msg=k)
