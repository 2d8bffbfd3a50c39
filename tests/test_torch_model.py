"""The slice end to end: the tiny DLRM-DCNv2 trains 3 steps in both
packages from the same state (carried from JAX) on the same synthetic
batches.

Tolerances: loss rtol 1e-4 per step; dense parameters and every table
rtol 1e-4 / atol 1e-5 after step 3 (float32 sums taken in another order
over three steps of GEMMs, segmented sums and optimizer updates).
"""
import jax
import numpy as np
import pytest
import torch

from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.tools import flagship as jflagship
from hugectr_tpu_torch import ops
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.tools import flagship as tflagship
from hugectr_tpu_torch.tools.carry import load_jax_state

torch.set_num_threads(1)

# one-hot threshold 100 puts tables with vocab <= 100 on the one-hot engine;
# the 1000-row cap puts the rest in one shared rowop group, sent to the
# sorted segscan route by turning the dense sweep off
ENGINE = dict(onehot_vocab=100, dense_update_rows=0, dense_key_ratio=0.0)
JAX_ENV = {
    "HCTR_TPU_ONEHOT_VOCAB": "100",
    "HCTR_TPU_DENSE_UPDATE_ROWS": "0",
    "HCTR_TPU_DENSE_KEY_RATIO": "0",
    "HCTR_TPU_SEGSUM": "scan",
    "HCTR_TPU_ONEHOT_KERNEL": "pallas",
    "HCTR_TPU_HOT_ROWS": "0",
    "HCTR_BENCH_OPT": "rowwise_adagrad",
}


@pytest.fixture
def models(monkeypatch):
    for k, v in JAX_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("HCTR_TPU_EMB_DTYPE", raising=False)
    jm = jflagship.build_tiny_dlrm(JaxResourceManager.create(num_devices=1), batchsize=64)
    tm = tflagship.build_tiny_dlrm(ResourceManager.create(device="cpu"), batchsize=64, **ENGINE)
    load_jax_state(tm, jax.device_get(jm.state))
    return jm, tm


def test_tiny_dlrm_three_steps_match_jax(models):
    jm, tm = models
    assert [(g.name, g.compute_kind) for g in tm.ec.plan.groups] == [
        (g.name, g.compute_kind) for g in jm.ec.plan.groups
    ]
    ops.reset_counts()
    for step in range(3):
        jl, tl = jm.train(), tm.train()
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"loss at step {step + 1}")
    assert tm.ec.group_routes == {"mp_ev16": "sorted", "onehot_ev16": "onehot"}
    counts = ops.plain_counts()
    n_onehot = len(tm.ec.plan.groups[-1].lookups)
    # the one-hot forward is one call per group and step, the backward one per table
    assert counts == {"segscan": 3, "onehot_fwd": 3, "onehot_bwd": 3 * n_onehot}
    assert ops.launch_counts() == {"segscan": 0, "onehot_fwd": 0, "onehot_bwd": 0}
    state = jax.device_get(jm.state)
    params = tm.network.param_tree()
    for layer, ps in state["dense_params"].items():
        for k, v in ps.items():
            np.testing.assert_allclose(params[layer][k].detach().numpy(), v, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{layer}/{k}")
    for i in range(26):
        np.testing.assert_allclose(
            tm.ec.export_table(tm.tables, str(i)), jm.ec.export_table(jm.state["emb_tables"], str(i)),
            rtol=1e-4, atol=1e-5, err_msg=f"table {i}",
        )


def test_flagship_widths_losses_match_jax(monkeypatch):
    """The flagship at its full dense widths (bottom 512/256/128, DCNv2
    projection 512 x 3, top 1024/1024/512/256/1, ev 128, 26 tables) at batch
    128 and a 20,000-row vocab cap: the losses of 3 steps agree, through the
    second step's jump (AdaGrad from zero accumulators moves every dense
    parameter by ~lr on its first step, in both packages). A 4,096-row split
    threshold and no small-shard dense sweep send tables to the sorted route,
    table 20 to the dense sweep by the key-ratio rule, 13 tables one-hot."""
    env = dict(JAX_ENV, HCTR_TPU_ONEHOT_VOCAB="8192", HCTR_TPU_SPLIT_VOCAB="4096",
               HCTR_TPU_DENSE_KEY_RATIO="0.3")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("HCTR_TPU_EMB_DTYPE", raising=False)
    kw = dict(batchsize=128, vocab_cap=20000, synthetic_batches=3)
    jm = jflagship.build_dlrm_dcnv2(JaxResourceManager.create(num_devices=1), **kw)
    tm = tflagship.build_dlrm_dcnv2(
        ResourceManager.create(device="cpu"), split_vocab=4096, dense_update_rows=0, **kw
    )
    load_jax_state(tm, jax.device_get(jm.state))
    for step in range(3):
        jl, tl = jm.train(), tm.train()
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"loss at step {step + 1}")
    routes = tm.ec.group_routes
    assert routes.pop("onehot_ev128") == "onehot"
    assert routes.pop("mp_ev128_20") == "dense"
    assert set(routes.values()) == {"sorted"}
