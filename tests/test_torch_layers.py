"""The port's Reshape and DLRM Interaction layers against the JAX package's
(core_layers.py `_reshape_apply`, interaction.py `_interaction_apply`), and
an Interaction's second top as an alias of its first in the network.

Tolerances: Reshape moves values and must be exact. Interaction in float32
rtol 1e-5 / atol 1e-5 (float32 dot products summed in another order); in
bfloat16 the output is the same float32 sums rounded once to bfloat16, so
one bf16 ulp (rtol 2^-7) apart where the sums straddle a rounding
boundary, and the input gradients, bfloat16 products summed in float32
and rounded, rtol 2^-6 / atol 2^-6. The network: loss rtol 1e-5, parameter
gradients rtol 1e-4 / atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugectr_tpu.core import config as jcfg
from hugectr_tpu.layers.base import LAYER_REGISTRY as JLAYERS
from hugectr_tpu.layers.base import LayerCtx
from hugectr_tpu.layers.network import Network as JNetwork

from hugectr_tpu_torch.core import config as tcfg
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.layers.base import LAYER_REGISTRY as TLAYERS
from hugectr_tpu_torch.layers.network import Network as TNetwork

torch.set_num_threads(1)
CPU = ResourceManager.create(device="cpu")
B = 12

# (config fields, input shape): the four forms of Reshape
RESHAPES = {
    "shape": (dict(shape=[-1, 4, 8]), (B, 32)),
    "shape_no_minus_one": (dict(shape=[B * 2, 16]), (B, 32)),
    "selected": (dict(selected=True, selected_slots=[3, 0, 3]), (B, 5, 8)),
    "time_step": (dict(leading_dim=8, time_step=2), (B, 32)),
    "leading_dim": (dict(leading_dim=8), (B, 4, 8)),
    "flatten": (dict(), (B, 4, 8)),
}


def _jax_apply(cfg, inputs, compute_dtype=jnp.float32):
    ctx = LayerCtx(training=True, compute_dtype=compute_dtype)
    return JLAYERS[cfg.layer_type].apply({}, {}, [jnp.asarray(x) for x in inputs], cfg, ctx)[0]


@pytest.mark.parametrize("form", list(RESHAPES))
def test_reshape_matches_jax(form):
    """Output shape from the config (`out_shapes` against the JAX package's
    shape function), forward values and the input gradient, exactly."""
    fields, in_shape = RESHAPES[form]
    kw = dict(layer_type="Reshape", bottom_names=["x"], top_names=["y"], **fields)
    jc, tc = jcfg.DenseLayer(**kw), tcfg.DenseLayer(**kw)
    x = np.random.default_rng(1).normal(size=in_shape).astype(np.float32)
    r_shape = JLAYERS["Reshape"].init(None, jc, [in_shape])[2][0]
    layer = TLAYERS["Reshape"](tc, [in_shape], CPU.generator(0), CPU.device)
    assert [tuple(s) for s in layer.out_shapes] == [tuple(r_shape)]
    r = np.random.default_rng(2).normal(size=r_shape).astype(np.float32)
    jout = _jax_apply(jc, [x])[0]
    jgrad = jax.grad(lambda v: jnp.sum(_jax_apply(jc, [v])[0] * r))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = layer([tx], torch.float32)[0]
    assert tuple(tout.shape) == tuple(r_shape)
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    (tout * torch.from_numpy(r)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jgrad))


def test_reshape_rejects_incompatible_shape():
    kw = dict(layer_type="Reshape", bottom_names=["x"], top_names=["y"], shape=[B, 31])
    with pytest.raises(ValueError):
        TLAYERS["Reshape"](tcfg.DenseLayer(**kw), [(B, 32)], CPU.generator(0), CPU.device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tops", [1, 2])
def test_interaction_matches_jax(dtype, tops):
    """[dense; 26 embeddings] -> pairwise dots in float32 -> strictly lower
    triangle in np.tril_indices order -> [dense | dots | 0], width
    128 + 351 + 1 = 480; with two tops the second is the same tensor.
    Forward and d(sum(out * r))/d(dense, emb)."""
    b, f, e = 16, 26, 128
    rng = np.random.default_rng(3)
    dense = rng.normal(size=(b, e)).astype(np.float32)
    emb = rng.normal(size=(b, f, e)).astype(np.float32) * 0.5
    kw = dict(layer_type="Interaction", bottom_names=["d", "e"], top_names=["y", "y2"][:tops])
    jc = jcfg.DenseLayer(**kw)
    jc._num_tops = tops
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    layer = TLAYERS["Interaction"](tcfg.DenseLayer(**kw), [(b, e), (b, f, e)], CPU.generator(0), CPU.device)
    assert layer.out_shapes == [(b, 480)] * tops
    r = rng.normal(size=(b, 480)).astype(np.float32)

    def jloss(d, em):
        return jnp.sum(_jax_apply(jc, [d, em], jdt)[0].astype(jnp.float32) * r)

    jout = _jax_apply(jc, [dense, emb], jdt)
    jgd, jge = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(dense), jnp.asarray(emb))
    td = torch.from_numpy(dense).requires_grad_(True)
    te = torch.from_numpy(emb).requires_grad_(True)
    touts = layer([td, te], tdt)
    assert len(touts) == tops and all(t is touts[0] for t in touts)
    assert touts[0].dtype == tdt
    out_tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2.0**-7, atol=2.0**-7)
    np.testing.assert_allclose(touts[0].detach().float().numpy(), np.asarray(jout[0]).astype(np.float32),
                               **out_tol)
    np.testing.assert_array_equal(touts[0][:, -1].detach().float().numpy(), 0.0)
    (touts[0].float() * torch.from_numpy(r)).sum().backward()
    grad_tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2.0**-6, atol=2.0**-6)
    scale = float(np.abs(np.asarray(jge)).max())
    np.testing.assert_allclose(td.grad.numpy() / scale, np.asarray(jgd) / scale, **grad_tol)
    np.testing.assert_allclose(te.grad.numpy() / scale, np.asarray(jge) / scale, **grad_tol)


def test_interaction_alias_top_in_network():
    """An Interaction with two tops feeding an MLP over [top, alias] (the
    reference's fused-MLP layout, network.py:62-99): the MLP reads the
    interaction once, and the loss and every parameter gradient agree with
    the JAX package's network from the same parameters."""
    b, f, e = 8, 3, 4
    layers = [
        dict(layer_type="Reshape", bottom_names=["emb"], top_names=["emb3d"], shape=[-1, f, e]),
        dict(layer_type="MLP", bottom_names=["dense"], top_names=["bot"], num_outputs=[8, e],
             activations=["relu", "relu"]),
        dict(layer_type="Interaction", bottom_names=["bot", "emb3d"], top_names=["inter", "inter_alias"]),
        dict(layer_type="MLP", bottom_names=["inter", "inter_alias"], top_names=["top"], num_outputs=[6, 1],
             activations=["relu", "none"]),
        dict(layer_type="BinaryCrossEntropyLoss", bottom_names=["top", "label"], top_names=["loss"]),
    ]
    shapes = {"dense": (b, 5), "emb": (b, f * e), "label": (b, 1)}
    rng = np.random.default_rng(4)
    inputs = {"dense": rng.normal(size=(b, 5)).astype(np.float32),
              "emb": rng.normal(size=(b, f * e)).astype(np.float32),
              "label": rng.integers(0, 2, size=(b, 1)).astype(np.float32)}
    jnet = JNetwork([jcfg.DenseLayer(**kw) for kw in layers], shapes)
    jp, js = jnet.init(jax.random.key(0))
    ctx = LayerCtx(training=True, compute_dtype=jnp.float32)

    def jloss(p):
        return jnet.forward_with_loss(p, js, {k: jnp.asarray(v) for k, v in inputs.items()}, ctx)[0]

    jl, jg = jax.value_and_grad(jloss)(jp)
    tnet = TNetwork([tcfg.DenseLayer(**kw) for kw in layers], shapes, CPU.generator(0), CPU.device)
    assert tnet.aliases == {"inter_alias": "inter"}
    assert tnet.layers["l3_MLP"].weight_0.shape[0] == e + f * (f + 1) // 2 + 1  # read once
    params = tnet.param_tree()
    assert set(params) == set(jp)
    with torch.no_grad():
        for layer, ps in jp.items():
            for k, v in ps.items():
                params[layer][k].copy_(torch.from_numpy(np.array(v)))
    tl, _ = tnet.forward_with_loss({k: torch.from_numpy(v) for k, v in inputs.items()}, torch.float32)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for layer, ps in jg.items():
        for k, v in ps.items():
            np.testing.assert_allclose(params[layer][k].grad.numpy(), np.asarray(v), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{layer}/{k}")
