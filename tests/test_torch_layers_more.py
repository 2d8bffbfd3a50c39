"""The eleven layer types no sample uses (Sigmoid, ELU, Cast, MaskedSoftmax,
Select, Gather, FusedReshapeConcatGeneral, BatchNorm, FusedInnerProduct,
MatrixMultiply, GRU), the MLP's ELU and GELU activations and the loss
regularizers, against the JAX package's functions
(hugectr_tpu/layers/core_layers.py, gemm.py, losses.py) on seeded numpy
inputs: output shapes from the configs, forward values, the gradients of
sum(out * r) with respect to every float input and every parameter (the
JAX parameters carried into the port's layer), and BatchNorm's running
statistics after a training forward and its eval forward from given
statistics.

Tolerances are those of tests/test_torch_layers_extended.py (`_close`):
float32 rtol 1e-5 with an atol of 1e-6 times the largest |value|; bfloat16
(inputs and compute) rtol 1e-2 with an atol of 1e-2 times the largest
|value| or cotangent. BatchNorm's running statistics: rtol 1e-5, atol 1e-6
(float32 in both dtypes). The regularizer's value: rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugectr_tpu.core import config as jcfg
from hugectr_tpu.layers.base import LAYER_REGISTRY as JLAYERS
from hugectr_tpu.layers.base import LayerCtx
from hugectr_tpu.layers import network as _jnetwork  # noqa: F401 (registry)
from hugectr_tpu.layers.losses import regularizer_term as jreg

from hugectr_tpu_torch.core import config as tcfg
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.layers.base import LAYER_REGISTRY as TLAYERS
from hugectr_tpu_torch.layers.losses import regularizer_term as treg
from test_torch_layers_extended import _close

torch.set_num_threads(1)
CPU = ResourceManager.create(device="cpu")
B = 12
S = 5

# name: (config fields, inputs maker(rng) -> list of arrays, indices of the
# inputs that take a gradient)
CASES = {
    "sigmoid": (dict(layer_type="Sigmoid"), lambda r: [r.normal(size=(B, 8)) * 2], [0]),
    "elu": (dict(layer_type="ELU", elu_alpha=0.7), lambda r: [r.normal(size=(B, 8)) * 2], [0]),
    "cast": (dict(layer_type="Cast"), lambda r: [r.normal(size=(B, 6))], [0]),
    "masked_softmax": (dict(layer_type="MaskedSoftmax", factor=0.5),
                       lambda r: [r.normal(size=(B, 2, S, S)) * 3,
                                  (r.random((B, 1, S, S)) < 0.7).astype(np.float32)], [0]),
    "select": (dict(layer_type="Select", dim=1, index=[0, 3, 4, 3]), lambda r: [r.normal(size=(B, 5, 3))], [0]),
    "select_last": (dict(layer_type="Select", dim=2, index=[2, 0]), lambda r: [r.normal(size=(B, 4, 3))], [0]),
    "gather": (dict(layer_type="Gather", indices=[3, 1, 0, 2, 11, 6, 4, 5]), lambda r: [r.normal(size=(B, 4))], [0]),
    "fused_reshape_concat_general": (dict(layer_type="FusedReshapeConcatGeneral"),
                                     lambda r: [r.normal(size=(B, 3, 4)), r.normal(size=(B, 3, 2))], [0, 1]),
    "batch_norm": (dict(layer_type="BatchNorm", factor=0.9, eps=1e-5),
                   lambda r: [r.normal(size=(B, 16)) * 3 + 1], [0]),
    "batch_norm_inits": (dict(layer_type="BatchNorm", factor=0.1, gamma_init_type="xavier_uniform",
                              beta_init_type="uniform"), lambda r: [r.normal(size=(B, 10))], [0]),
    "fused_inner_product": (dict(layer_type="FusedInnerProduct", num_output=5), lambda r: [r.normal(size=(B, 12))],
                            [0]),
    "matrix_multiply_2d": (dict(layer_type="MatrixMultiply"), lambda r: [r.normal(size=(B, 7)),
                                                                          r.normal(size=(7, 5))], [0, 1]),
    "matrix_multiply_3d": (dict(layer_type="MatrixMultiply"), lambda r: [r.normal(size=(B, 4, 6)),
                                                                          r.normal(size=(B, 6, 3))], [0, 1]),
    "matrix_multiply_3d_transpose_b": (dict(layer_type="MatrixMultiply", transpose_b=True),
                                       lambda r: [r.normal(size=(B, 4, 6)), r.normal(size=(B, 4, 6))], [0, 1]),
    "matrix_multiply_2d_3d": (dict(layer_type="MatrixMultiply"), lambda r: [r.normal(size=(B, 6)),
                                                                             r.normal(size=(6, 3, 4))], [0, 1]),
    "gru": (dict(layer_type="GRU", num_output=5, SeqLength=4, vector_size=3),
            lambda r: [r.normal(size=(B, 4 * 3))], [0]),
    "gru_batchsize_rows": (dict(layer_type="GRU", num_output=6, SeqLength=3, vector_size=4, batchsize=B),
                           lambda r: [r.normal(size=(B * 3, 4))], [0]),
    "mlp_elu": (dict(layer_type="MLP", num_outputs=[6, 4], act_type="elu"), lambda r: [r.normal(size=(B, 9))], [0]),
    "mlp_gelu": (dict(layer_type="MLP", num_outputs=[7, 3], activations=["gelu", "elu"]),
                 lambda r: [r.normal(size=(B, 9))], [0]),
}
STATS_TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(fields, shapes):
    names = [f"x{i}" for i in range(len(shapes))]
    kw = dict(bottom_names=names, top_names=["y0"], **fields)
    jc, tc = jcfg.DenseLayer(**kw), tcfg.DenseLayer(**kw)
    jc._num_tops = 1
    jparams, jstate, jshapes = JLAYERS[jc.layer_type].init(jax.random.key(3), jc, shapes)
    jparams = jax.tree.map(lambda p: p + 0.1 * jax.random.normal(jax.random.key(4), p.shape), jparams)
    layer = TLAYERS[tc.layer_type](tc, shapes, CPU.generator(0), CPU.device)
    assert [tuple(s) for s in layer.out_shapes] == [tuple(s) for s in jshapes]
    tparams = dict(layer.named_parameters())
    assert set(tparams) == set(jparams)
    with torch.no_grad():
        for k, v in jparams.items():
            tparams[k].copy_(torch.from_numpy(np.array(v)))
    assert set(getattr(layer, "state_keys", ())) == set(jstate)
    for k, v in jstate.items():  # the JAX initial state is the port's
        np.testing.assert_array_equal(getattr(layer, k).numpy(), np.asarray(v))
    return jc, jparams, jstate, layer, tparams


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_layer_matches_jax(case, dtype):
    """Shapes, forward, gradients (and BatchNorm's updated statistics) of
    one layer in training mode against the JAX package's init / apply."""
    fields, make, grad_idx = CASES[case]
    mixed = dtype == "bfloat16"
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if mixed else (jnp.float32, torch.float32)
    rng = np.random.default_rng(sum(map(ord, case)))
    inputs = [np.asarray(x, np.float32) for x in make(rng)]
    jc, jparams, jstate, layer, tparams = _pair(fields, [x.shape for x in inputs])
    cast = [i in grad_idx for i in range(len(inputs))]
    ctx = LayerCtx(training=True, compute_dtype=jdt)

    def jfwd(p, xs):
        return JLAYERS[jc.layer_type].apply(p, jstate, list(xs), jc, ctx)

    jx = [jnp.asarray(x).astype(jdt) if c else jnp.asarray(x) for x, c in zip(inputs, cast)]
    jouts, jnew = jfwd(jparams, jx)
    rs = [rng.normal(size=np.shape(o)).astype(np.float32) for o in jouts]

    def jloss(p, xs):
        return sum(jnp.sum(o.astype(jnp.float32) * r) for o, r in zip(jfwd(p, xs)[0], rs))

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jparams, jx)
    tx = [torch.from_numpy(x).to(tdt if c else torch.float32).requires_grad_(c) for x, c in zip(inputs, cast)]
    layer.train()
    touts = layer(tx, tdt)
    for i, (t, j) in enumerate(zip(touts, jouts)):
        assert t.dtype == {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}[j.dtype]
        _close(t.detach().float().numpy(), np.asarray(j.astype(jnp.float32)), mixed, f"{case} out {i}")
    for k, v in jnew.items():
        np.testing.assert_allclose(getattr(layer, k).numpy(), np.asarray(v), **STATS_TOL, err_msg=f"{case} {k}")
    sum((t.float() * torch.from_numpy(r)).sum() for t, r in zip(touts, rs)).backward()
    for i in grad_idx:
        _close(tx[i].grad.float().numpy(), np.asarray(jgx[i].astype(jnp.float32)), mixed, f"{case} d x{i}", rs)
    for k, v in jgp.items():
        _close(tparams[k].grad.numpy(), np.asarray(v), mixed, f"{case} d {k}", rs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_eval_uses_running_statistics(dtype):
    """Eval mode: BatchNorm normalises with the given running statistics and
    leaves them as they are."""
    mixed = dtype == "bfloat16"
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if mixed else (jnp.float32, torch.float32)
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(B, 16)) * 2).astype(np.float32)
    jc, jparams, _jstate, layer, _tp = _pair(dict(layer_type="BatchNorm", factor=0.5), [x.shape])
    state = {"running_mean": rng.normal(size=16).astype(np.float32),
             "running_var": (rng.random(16) + 0.5).astype(np.float32)}
    with torch.no_grad():
        for k, v in state.items():
            getattr(layer, k).copy_(torch.from_numpy(v))
    (jo,), jnew = JLAYERS["BatchNorm"].apply(jparams, {k: jnp.asarray(v) for k, v in state.items()},
                                             [jnp.asarray(x).astype(jdt)], jc, LayerCtx(False, jdt))
    layer.eval()
    (to,) = layer([torch.from_numpy(x).to(tdt)], tdt)
    _close(to.detach().float().numpy(), np.asarray(jo.astype(jnp.float32)), mixed, "eval out")
    for k, v in state.items():
        np.testing.assert_array_equal(getattr(layer, k).numpy(), v)
        np.testing.assert_array_equal(np.asarray(jnew[k]), v)


@pytest.mark.parametrize("reg", ["l1", "l2", "none"])
def test_regularizer_term_matches_jax(reg):
    """L1 lambda / B sum |w|, L2 lambda / (2 B) sum w^2 over every leaf (a
    bfloat16 leaf summed in float32), and their gradients (L1's is 1 at a
    weight of 0, as JAX's); lambda 0 and NonE give 0."""
    rng = np.random.default_rng(2)
    tree = {"l0_MLP": {"weight_0": rng.normal(size=(7, 5)), "bias_0": rng.normal(size=5)},
            "l3_BatchNorm": {"gamma": rng.normal(size=4), "beta": rng.normal(size=4)}}
    tree = {k: {n: v.astype(np.float32) for n, v in d.items()} for k, d in tree.items()}
    leaves = [torch.from_numpy(tree[k][n]) for k in sorted(tree) for n in sorted(tree[k])]
    want = float(jreg(reg, 0.25, 64, jax.tree.map(jnp.asarray, tree)))
    got = float(treg(reg, 0.25, 64, leaves))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got == 0.0) == (reg == "none")
    assert float(treg("l2", 0.0, 64, leaves)) == 0.0
    # the gradient, zero entries included (jnp.abs's derivative at 0 is 1)
    tree["l0_MLP"]["bias_0"][:2] = 0.0
    leaves = [torch.from_numpy(tree[k][n]).requires_grad_(True) for k in sorted(tree) for n in sorted(tree[k])]
    jg = jax.grad(lambda t: jreg(reg, 0.25, 64, t))(jax.tree.map(jnp.asarray, tree))
    if reg != "none":
        treg(reg, 0.25, 64, leaves).backward()
        want = [np.asarray(jg[k][n]) for k in sorted(tree) for n in sorted(tree[k])]
        for t, w in zip(leaves, want):
            np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-6)
    leaves = [t.detach() for t in leaves]
    bf = [t.to(torch.bfloat16) for t in leaves]
    np.testing.assert_allclose(float(treg(reg, 0.25, 64, bf)),
                               float(jreg(reg, 0.25, 64, [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                                                          for t in bf])), rtol=1e-6)
