"""The port's metrics module against the JAX package's, on the same numpy
inputs.

Tolerances: AUC, NDCG, HitRate, SMAPE within 1e-6 absolute (float32 sums
over at most a few thousand elements, taken in another order); the binned
AUC within 1e-4 of the exact AUC (tests/test_metrics.py:129); AverageLoss
within 1e-7 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugectr_tpu.core.types import Metric_t as JMetric
from hugectr_tpu.metrics import metrics as jm

from hugectr_tpu_torch.core.types import Metric_t as TMetric
from hugectr_tpu_torch.metrics import metrics as tm

torch.set_num_threads(1)


def _inputs(rng, n, ties: bool, masked: bool):
    preds = rng.random(n).astype(np.float32)
    if ties:  # coarse predictions: many ties across labels
        preds = np.round(preds * 20) / 20
    labels = (rng.random(n) < 0.3 + 0.4 * preds).astype(np.float32)
    valid = rng.random(n) > 0.2 if masked else None
    return preds, labels, valid


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "masked"])
def test_finalizers_match_jax(ties, masked):
    rng = np.random.default_rng(5 + 2 * ties + masked)
    preds, labels, valid = _inputs(rng, 3000, ties, masked)
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    jp, jl, tp, tl = jnp.asarray(preds), jnp.asarray(labels), torch.from_numpy(preds), torch.from_numpy(labels)
    for name in ("auc_score", "auc_score_large", "ndcg_score", "hitrate_score", "smape_score"):
        want = float(getattr(jm, name)(jp, jl, jv))
        got = float(getattr(tm, name)(tp, tl, tv))
        assert abs(got - want) <= 1e-6, (name, got, want)
    exact = float(tm.auc_score(tp, tl, tv))
    assert abs(float(tm.auc_score_large(tp, tl, tv)) - exact) <= 1e-4
    # auto: the exact path up to the limit, the binned one past it
    assert float(tm.auc_score_auto(tp, tl, tv, exact_max=3000)) == exact
    assert float(tm.auc_score_auto(tp, tl, tv, exact_max=2999)) == float(tm.auc_score_large(tp, tl, tv))


def test_auc_degenerate_labels_and_negative_predictions():
    preds = np.array([-3.5, -0.0, 0.0, 1e-30, -1e-30, 2.0, 7.5, -7.5], np.float32)
    for labels in (np.zeros(8, np.float32), np.ones(8, np.float32),
                   np.array([1, 0, 1, 0, 1, 0, 1, 0], np.float32)):
        for name in ("auc_score", "auc_score_large"):
            want = float(getattr(jm, name)(jnp.asarray(preds), jnp.asarray(labels)))
            got = float(getattr(tm, name)(torch.from_numpy(preds), torch.from_numpy(labels)))
            assert abs(got - want) <= 1e-6, (name, labels, got, want)


def test_binned_auc_within_1e4_of_exact_at_1m():
    """tests/test_metrics.py:129's bound at 1M uniform samples."""
    rng = np.random.default_rng(9)
    preds = rng.random(1 << 20).astype(np.float32)
    labels = (rng.random(1 << 20) < preds).astype(np.float32)
    tp, tl = torch.from_numpy(preds), torch.from_numpy(labels)
    assert abs(float(tm.auc_score_large(tp, tl)) - float(tm.auc_score(tp, tl))) < 1e-4


def test_metric_accumulator_matches_jax():
    """Batches written into the preallocated buffers, fewer than the
    capacity (the rest masked), one batch past it dropped; losses kept as
    device scalars; every metric, then reset; the early-stop rule."""
    rng = np.random.default_rng(3)
    spec = {JMetric.AUC: 0.6, JMetric.AverageLoss: 0.0, JMetric.NDCG: 1.0, JMetric.HitRate: 1.0,
            JMetric.SMAPE: 1.0}
    tspec = {TMetric(k.value): v for k, v in spec.items()}
    ja = jm.MetricAccumulator(spec, batch_size=64, max_batches=5)
    ta = tm.MetricAccumulator(tspec, batch_size=64, max_batches=5, device=torch.device("cpu"))
    for _ in range(2):
        for i in range(6 if _ else 4):
            p, lab, _v = _inputs(rng, 64, ties=i % 2 == 0, masked=False)
            loss = float(rng.random())
            ja.update(jnp.asarray(p), jnp.asarray(lab), loss=jnp.asarray(loss))
            ta.update(torch.from_numpy(p), torch.from_numpy(lab), loss=torch.tensor(loss))
        jv, tv = ja.finalize(), ta.finalize()
        assert sorted(jv) == sorted(tv)
        for k in jv:
            np.testing.assert_allclose(tv[k], jv[k], rtol=1e-7, atol=1e-6, err_msg=k)
        assert ta.check_earlystop(tv) == ja.check_earlystop(jv)
        ja.reset()
        ta.reset()
    assert ta.check_earlystop({"auc": 0.61}) and not ta.check_earlystop({"auc": 0.59})
