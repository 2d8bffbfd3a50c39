"""The dense layers under mixed precision (bf16 compute) against the JAX
layers, on the same numpy inputs and parameters: MLP, MultiCross (DCNv2
projection) and BCE, forward and gradients.

Both packages cast inputs and weights to bf16, sum the products in float32
(`preferred_element_type`), add the bias in float32 and cast the output to
bf16; the gradients of the float32 parameters come back through the casts.
Tolerance: one bf16 ulp of the element, 2^-7 relative, plus 2^-7 of the
tensor's largest magnitude absolute (a float32 sum taken in another order
can round to the neighbouring bf16 value, and a difference in one layer
moves the next layer's inputs by as much).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugectr_tpu.core import config as jcfg
from hugectr_tpu.layers.base import LAYER_REGISTRY as JLAYERS
from hugectr_tpu.layers.base import LayerCtx

from hugectr_tpu_torch.core import config as tcfg
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.layers.base import LAYER_REGISTRY as TLAYERS

torch.set_num_threads(1)
CPU = ResourceManager.create(device="cpu")
ULP = 2.0**-7


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=ULP, atol=ULP * float(np.abs(want).max()), err_msg=what)


def _check_bf16(kw, in_shapes, params, inputs):
    """Forward outputs (dtype and values) and d(sum(out * r))/d(params,
    inputs) of the JAX layer and the port's under bf16 compute."""
    jc, tc = jcfg.DenseLayer(**kw), tcfg.DenseLayer(**kw)
    ctx = LayerCtx(training=True, compute_dtype=jnp.bfloat16)
    japply = JLAYERS[jc.layer_type].apply
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jxs = [jnp.asarray(x) for x in inputs]
    jout = japply(jparams, {}, jxs, jc, ctx)[0][0]
    r = np.random.default_rng(0).normal(size=jout.shape).astype(np.float32)

    def jloss(p, xs):
        return jnp.sum(japply(p, {}, xs, jc, ctx)[0][0].astype(jnp.float32) * r)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jparams, jxs)
    layer = TLAYERS[tc.layer_type](tc, in_shapes, CPU.generator(0), CPU.device)
    with torch.no_grad():
        for k, v in params.items():
            getattr(layer, k).copy_(torch.from_numpy(v))
    xs = [torch.from_numpy(np.array(x)).requires_grad_(True) for x in inputs]
    tout = layer(xs, torch.bfloat16)[0]
    assert str(tout.dtype).split(".")[1] == str(jout.dtype)
    _close(tout.detach().float().numpy(), jout.astype(jnp.float32), "output")
    (tout.float() * torch.from_numpy(r)).sum().backward()
    for k in params:
        assert getattr(layer, k).grad.dtype == torch.float32  # parameters stay float32
        _close(getattr(layer, k).grad.numpy(), jgp[k], k)
    for i, (x, g) in enumerate(zip(xs, jgx)):
        _close(x.grad.numpy(), g, f"input {i}")


@pytest.mark.parametrize("bias", [True, False])
def test_mlp_bf16_matches_jax(bias):
    rng = np.random.default_rng(1)
    kw = dict(layer_type="MLP", bottom_names=["x"], top_names=["y"], num_outputs=[32, 16, 1],
              activations=["relu", "relu", "none"], use_bias=bias)
    params, fan_in = {}, 13
    for i, n in enumerate([32, 16, 1]):
        params[f"weight_{i}"] = (rng.normal(size=(fan_in, n)) * 0.3).astype(np.float32)
        if bias:
            params[f"bias_{i}"] = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
        fan_in = n
    _check_bf16(kw, [(24, 13)], params, [rng.normal(size=(24, 13)).astype(np.float32)])


def test_multicross_bf16_matches_jax():
    rng = np.random.default_rng(3)
    n, k = 20, 8
    kw = dict(layer_type="MultiCross", bottom_names=["x"], top_names=["y"], projection_dim=k, num_layers=2)
    params = {}
    for i in range(2):
        params[f"U_{i}"] = (rng.normal(size=(n, k)) * 0.3).astype(np.float32)
        params[f"V_{i}"] = (rng.normal(size=(k, n)) * 0.3).astype(np.float32)
        params[f"b_{i}"] = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    _check_bf16(kw, [(24, n)], params, [rng.normal(size=(24, n)).astype(np.float32)])


def test_bce_bf16_logits_match_jax():
    """The loss runs in float32 on bf16 logits (losses.py:24)."""
    rng = np.random.default_rng(4)
    kw = dict(layer_type="BinaryCrossEntropyLoss", bottom_names=["l", "y"], top_names=["loss"])
    logits = np.asarray(jnp.asarray(rng.normal(size=(64, 1)) * 4, jnp.bfloat16).astype(jnp.float32))
    labels = rng.integers(0, 2, size=(64, 1)).astype(np.float32)
    _check_bf16(kw, [(64, 1), (64, 1)], {}, [logits, labels])
