"""The slice end to end: the tiny DLRM-DCNv2 with bench.py's settings,
scaled down (bf16 tables and bf16 rowwise-AdaGrad state, mixed precision, a
split with a superhot tier, learnable labels), trains 3 steps in both
packages from the same state (carried from JAX) on the same synthetic
batches, then evaluates with the binned AUC.

Tolerances, and why:
- step 1 loss rtol 1e-5: the same state and batch; bf16 products summed in
  float32 in another order;
- steps 2-3 loss rtol 5e-3: the first AdaGrad step from zero accumulators
  moves every dense parameter by +-lr, by the sign of its gradient, so an
  element whose bf16 gradient lies within a rounding of zero moves by 2 lr
  more in one package than in the other;
- tables after step 1 within one bf16 ulp at the tables' scale (2^-7 x 0.5
  absolute, 2^-7 relative): float32 sums rounded once to bf16;
- eval from the same (carried) weights: AUC within 1e-6, AverageLoss rtol
  1e-5; from each package's own 3 steps: AUC within 0.01.
"""
import jax
import numpy as np
import pytest
import torch

import hugectr_tpu as jh
from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.core.types import Metric_t as JMetric
from hugectr_tpu.metrics.metrics import MetricAccumulator as JAcc
from hugectr_tpu.tools import flagship as jflagship
from hugectr_tpu_torch import ops
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Metric_t as TMetric
from hugectr_tpu_torch.metrics.metrics import MetricAccumulator as TAcc
from hugectr_tpu_torch.tools import flagship as tflagship
from hugectr_tpu_torch.tools.carry import load_jax_state

torch.set_num_threads(1)

TINY = dict(ev_size=16, vocab_cap=4000, synthetic_batches=3, bottom_mlp=(32, 16), top_mlp=(32, 16, 1),
            projection_dim=8, num_cross_layers=2, batchsize=64, use_mixed_precision=True,
            max_eval_batches=5)
# bench.py's settings (bf16, rowwise AdaGrad, the split, the binned AUC past
# its limit) at the tiny size: tables of >= 1,024 rows split at 256 rows,
# a 32-row superhot tier; the eval buffer (320 samples) past the exact
# limit; groups of more than 1,024 rows on the sorted route
SPLIT = dict(hot_rows=256, superhot_rows=32, split_vocab=512, auc_exact_max=100, dense_update_rows=1024)
JAX_ENV = {
    "HCTR_TPU_EMB_DTYPE": "bfloat16", "HCTR_TPU_EMB_STATE_DTYPE": "bfloat16", "HCTR_TPU_SEGSUM": "xla",
    "HCTR_TPU_UCAP_FACTOR": "0", "HCTR_TPU_HOT_ROWS": "256", "HCTR_TPU_SUPERHOT_ROWS": "32",
    "HCTR_TPU_SPLIT_VOCAB": "512", "HCTR_TPU_ONEHOT_VOCAB": "64", "HCTR_TPU_AUC_EXACT_MAX": "100",
    "HCTR_TPU_DENSE_UPDATE_ROWS": "1024", "HCTR_TPU_DENSE_KEY_RATIO": "0.3",
    "HCTR_BENCH_OPT": "rowwise_adagrad",
}


def _metrics(jm, tm):
    """AUC and AverageLoss on both models' eval accumulators."""
    spec = {JMetric.AUC: 0.80275, JMetric.AverageLoss: 0.0}
    s = tm.solver
    jm.metrics = JAcc(spec, batch_size=s.batchsize_eval, max_batches=s.max_eval_batches)
    tm.metrics = TAcc({TMetric(k.value): v for k, v in spec.items()}, batch_size=s.batchsize_eval,
                      max_batches=s.max_eval_batches, device=tm.device, auc_exact_max=s.auc_exact_max)


@pytest.fixture
def models(monkeypatch):
    for k, v in JAX_ENV.items():
        monkeypatch.setenv(k, v)
    reader = jh.DataReaderParams(data_reader_type="synthetic", synthetic_num_batches=3,
                                 synthetic_alpha=1.05, synthetic_learnable=True)
    jm = jflagship.build_dlrm_dcnv2(JaxResourceManager.create(num_devices=1), reader=reader, **TINY)
    kw = dict(tflagship.bench_settings(), **TINY, **SPLIT)
    tm = tflagship.build_dlrm_dcnv2(ResourceManager.create(device="cpu"), onehot_vocab=64,
                                    synthetic_learnable=True, **kw)
    _metrics(jm, tm)
    load_jax_state(tm, jax.device_get(jm.state))
    return jm, tm


def test_tiny_bench_model_three_steps_and_eval_match_jax(models):
    jm, tm = models
    assert [g.name for g in tm.ec.plan.groups] == [g.name for g in jm.ec.plan.groups]
    assert tm.ec.plan.table_splits == jm.ec.plan.table_splits and tm.ec.plan.table_splits
    assert all(t.dtype == torch.bfloat16 for t in tm.tables.values())
    assert all(s["accum"].dtype == torch.bfloat16 for s in tm.eopt.values())
    onehot = tm.ec.plan.groups[0]
    assert onehot.compute_kind == "onehot" and any(lm.windowed for lm in onehot.lookups)
    ops.reset_counts()
    losses = []
    for step in range(3):
        jl, tl = jm.train(), tm.train()
        losses.append((jl, tl))
        np.testing.assert_allclose(tl, jl, rtol=1e-5 if step == 0 else 5e-3, err_msg=f"loss at step {step + 1}")
        if step == 0:
            state = jax.device_get(jm.state)
            for g, arr in state["emb_tables"].items():
                np.testing.assert_allclose(tm.tables[g].float().numpy(), np.asarray(arr).astype(np.float32),
                                           rtol=2.0**-7, atol=2.0**-8, err_msg=g)
    counts = ops.plain_counts()
    assert counts["onehot_fwd"] == 3
    assert set(tm.ec.group_routes.values()) == {"onehot", "dense", "sorted"}
    assert counts["segscan"] == 3 * sum(r == "sorted" for r in tm.ec.group_routes.values())
    assert counts["onehot_bwd"] == 3 * len(onehot.lookups)
    # eval of each package's own weights
    jv, tv = jm.eval(), tm.eval()
    assert abs(tv["auc"] - jv["auc"]) < 0.01, (tv, jv)
    assert ops.plain_counts()["onehot_fwd"] == 3 + tm.solver.max_eval_batches  # one per eval batch
    # eval of the same weights: the JAX package's, carried
    load_jax_state(tm, jax.device_get(jm.state))
    tv = tm.eval()
    assert abs(tv["auc"] - jv["auc"]) <= 1e-6, (tv, jv)
    np.testing.assert_allclose(tv["average_loss"], jv["average_loss"], rtol=1e-5)
    assert tm.get_eval_metrics() == list(tv.items())


def test_fit_evaluates_stops_early_and_guards_nan():
    """`fit` (model.py:1441): an eval every `eval_interval` iterations, an
    early stop once AUC passes its threshold, and a non-finite loss raises
    at the display check. The port only: the loop has no numbers of its own."""
    kw = dict(tflagship.bench_settings(), **TINY, **SPLIT)
    kw.update(metrics_spec={TMetric.AUC: 0.0})  # any AUC passes: stop at the first eval
    tm = tflagship.build_dlrm_dcnv2(ResourceManager.create(device="cpu"), onehot_vocab=64,
                                    synthetic_learnable=True, **kw)
    tm.fit(max_iter=6, display=1, eval_interval=2)
    assert tm._step == 2 and [k for k, _ in tm.get_eval_metrics()] == ["auc"]
    tm.metrics.metrics[TMetric.AUC] = 1.0  # no threshold: runs to max_iter
    tm.fit(max_iter=3, display=0, eval_interval=0)
    assert tm._step == 5
    with torch.no_grad():
        for t in tm.tables.values():
            t.fill_(float("nan"))
    with pytest.raises(RuntimeError, match="NaN/Inf loss at iter 1"):
        tm.fit(max_iter=2, display=1, eval_interval=0)
