"""The layers and losses of the eight other samples against the JAX
package's functions (hugectr_tpu/layers/core_layers.py, gemm.py,
interaction.py, losses.py) on seeded numpy inputs: output shapes from the
configs, forward values, and the gradients of sum(out * r) with respect to
every float input and every parameter (the JAX parameters carried into the
port's layer).

Tolerances: float32 rtol 1e-5 (sums in another order), with an atol of 1e-6
times the largest |value| of the compared array; under mixed precision
(inputs and compute in bfloat16) rtol 1e-2 with an atol of 1e-2 times that
scale, since an element near zero carries the rounding of larger terms. A
bfloat16 gradient's scale is also at least the largest |cotangent|: the
backward rounds products of the cotangent (a softmax's g - sum(g y), for
one) to bfloat16 before they cancel.
Also: Dropout's keep rate, scale, eval identity and determinism (the port
only: its draws cannot match JAX's), the SequenceMask + MultiHeadAttention
chain with lengths spread over 0..SEQ (fully masked rows included), and
MultiCross's DCN v1 branch.
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
from hugectr_tpu_torch.layers.network import Network as TNetwork

torch.set_num_threads(1)
CPU = ResourceManager.create(device="cpu")
B = 12
SEQ = 6


def _lengths(rng, n=B, top=SEQ):
    """Sequence lengths as the dense column holds them: floats spread over
    [0, top], every integer part present."""
    return (np.arange(n) % (top + 1) + rng.random(n) * 0.99).astype(np.float32).reshape(n, 1)


def _mask(lengths, n_from, n_to):
    ln = lengths.reshape(-1).astype(np.int32)
    i, j = np.arange(n_from)[None, :, None], np.arange(n_to)[None, None, :]
    return ((i < ln[:, None, None]) & (j < ln[:, None, None]))[:, None].astype(np.float32)


def _onehot(rng, n, c):
    return np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]


# name: (config fields, inputs maker(rng) -> list of arrays, indices of the
# inputs that take a gradient)
CASES = {
    "relu": (dict(layer_type="ReLU"), lambda r: [r.normal(size=(B, 8))], [0]),
    "softmax": (dict(layer_type="Softmax"), lambda r: [r.normal(size=(B, 6)) * 3], [0]),
    "softmax_masked": (dict(layer_type="Softmax"),
                       lambda r: [r.normal(size=(B, 2, SEQ, SEQ)), _mask(_lengths(r), SEQ, SEQ)], [0]),
    "dropout_rate0": (dict(layer_type="Dropout", dropout_rate=0.0), lambda r: [r.normal(size=(B, 8))], [0]),
    "slice": (dict(layer_type="Slice", ranges=[(0, 3), (3, 8), (2, 5)]), lambda r: [r.normal(size=(B, 8))], [0]),
    "slice_3d": (dict(layer_type="Slice", ranges=[(0, 1), (1, 4)]), lambda r: [r.normal(size=(B, 3, 4))], [0]),
    "add": (dict(layer_type="Add"), lambda r: [r.normal(size=(B, 5)) for _ in range(3)], [0, 1, 2]),
    "sub": (dict(layer_type="Sub"), lambda r: [r.normal(size=(B, 5)) for _ in range(2)], [0, 1]),
    "elementwise_multiply": (dict(layer_type="ElementwiseMultiply"),
                             lambda r: [r.normal(size=(B, 7)) for _ in range(2)], [0, 1]),
    "reduce_sum": (dict(layer_type="ReduceSum", axis=1), lambda r: [r.normal(size=(B, 5, 3))], [0]),
    "reduce_mean": (dict(layer_type="ReduceMean", axis=1), lambda r: [r.normal(size=(B, 5, 3))], [0]),
    "scale_axis0": (dict(layer_type="Scale", axis=0, factor=4), lambda r: [r.normal(size=(B, 3))], [0]),
    "scale_axis1": (dict(layer_type="Scale", axis=1, factor=3), lambda r: [r.normal(size=(B, 5))], [0]),
    "fused_reshape_concat": (dict(layer_type="FusedReshapeConcat"),
                             lambda r: [r.normal(size=(B, 4, 3)), r.normal(size=(B, 4, 5))], [0, 1]),
    "sequence_mask": (dict(layer_type="SequenceMask", max_sequence_len_from=SEQ, max_sequence_len_to=SEQ - 1),
                      lambda r: [_lengths(r), _lengths(r)[::-1].copy()], []),
    "prelu_dice": (dict(layer_type="PReLU_Dice", elu_alpha=0.2, eps=1e-8),
                   lambda r: [r.normal(size=(B, 10)) * 2 + 0.5], [0]),
    "layer_norm": (dict(layer_type="LayerNorm"), lambda r: [r.normal(size=(B, 4, 8)) * 3 + 1], [0]),
    "weight_multiply": (dict(layer_type="WeightMultiply", weight_dims=[13, 10]),
                        lambda r: [r.random(size=(B, 13))], [0]),
    "inner_product": (dict(layer_type="InnerProduct", num_output=5), lambda r: [r.normal(size=(B, 12))], [0]),
    "inner_product_flatten": (dict(layer_type="InnerProduct", num_output=5, use_bias=False),
                              lambda r: [r.normal(size=(B, 3, 4, 2))], [0]),
    "inner_product_3d": (dict(layer_type="InnerProduct", num_output=6), lambda r: [r.normal(size=(B, 4, 12))], [0]),
    "fm_order2": (dict(layer_type="FmOrder2", out_dim=4), lambda r: [r.normal(size=(B, 6 * 4))], [0]),
    "multi_head_attention": (dict(layer_type="MultiHeadAttention", num_attention_heads=2),
                             lambda r: [r.normal(size=(B, SEQ, 8)) for _ in range(3)] + [
                                 _mask(_lengths(r), SEQ, SEQ)], [0, 1, 2]),
    "multi_head_attention_unmasked": (dict(layer_type="MultiHeadAttention", num_attention_heads=4),
                                      lambda r: [r.normal(size=(B, 3, 8)), r.normal(size=(B, 5, 8)),
                                                 r.normal(size=(B, 5, 8))], [0, 1, 2]),
    "multicross_v1": (dict(layer_type="MultiCross", num_layers=3), lambda r: [r.normal(size=(B, 10)) * 0.5], [0]),
    "cross_entropy": (dict(layer_type="CrossEntropyLoss"), lambda r: [r.normal(size=(B, 2)), _onehot(r, B, 2)], [0]),
    "multi_cross_entropy": (dict(layer_type="MultiCrossEntropyLoss"),
                            lambda r: [r.normal(size=(B, 3)), r.integers(0, 2, (B, 3))], [0]),
    "multi_cross_entropy_weighted": (dict(layer_type="MultiCrossEntropyLoss", target_weight_vec=[0.5, 1.0, 2.0]),
                                     lambda r: [r.normal(size=(B, 3)), r.integers(0, 2, (B, 3))], [0]),
}


def _close(got, want, mixed, what, cotangents=()):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    if mixed:
        scale = max([scale] + [float(np.abs(r).max()) for r in cotangents])
    rtol = 1e-2 if mixed else 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * (scale if mixed else 0.1 * scale), err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_layer_matches_jax(case, dtype):
    """Shapes, forward and gradients of one layer against the JAX
    package's init/apply, parameters carried from JAX."""
    fields, make, grad_idx = CASES[case]
    mixed = dtype == "bfloat16"
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if mixed else (jnp.float32, torch.float32)
    rng = np.random.default_rng(sum(map(ord, case)))
    inputs = [np.asarray(x, np.float32) for x in make(rng)]
    names = [f"x{i}" for i in range(len(inputs))]
    n_tops = len(fields.get("ranges", [])) or (2 if fields["layer_type"] == "FusedReshapeConcat" else 1)
    kw = dict(bottom_names=names, top_names=[f"y{i}" for i in range(n_tops)], **fields)
    jc, tc = jcfg.DenseLayer(**kw), tcfg.DenseLayer(**kw)
    shapes = [x.shape for x in inputs]
    jparams, _, jshapes = JLAYERS[jc.layer_type].init(jax.random.key(3), jc, shapes)
    jparams = jax.tree.map(lambda p: p + 0.1 * jax.random.normal(jax.random.key(4), p.shape), jparams)
    layer = TLAYERS[tc.layer_type](tc, shapes, CPU.generator(0), CPU.device)
    assert [tuple(s) for s in layer.out_shapes] == [tuple(s) for s in jshapes]
    tparams = dict(layer.named_parameters())
    assert set(tparams) == set(jparams)
    with torch.no_grad():
        for k, v in jparams.items():
            tparams[k].copy_(torch.from_numpy(np.array(v)))
    # float inputs in the compute dtype, as the layer before would give them;
    # labels, masks and lengths as they are
    cast = [i in grad_idx for i in range(len(inputs))]
    ctx = LayerCtx(training=True, compute_dtype=jdt)

    def jfwd(p, xs):
        return JLAYERS[jc.layer_type].apply(p, {}, list(xs), jc, ctx)[0]

    jx = [jnp.asarray(x).astype(jdt) if c else jnp.asarray(x) for x, c in zip(inputs, cast)]
    jouts = jfwd(jparams, jx)
    rs = [rng.normal(size=np.shape(o)).astype(np.float32) for o in jouts]

    def jloss(p, xs):
        return sum(jnp.sum(o.astype(jnp.float32) * r) for o, r in zip(jfwd(p, xs), rs))

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jparams, jx)
    tx = [torch.from_numpy(x).to(tdt if c else torch.float32).requires_grad_(c) for x, c in zip(inputs, cast)]
    layer.train()
    touts = layer(tx, tdt)
    assert len(touts) == len(jouts)
    for i, (t, j) in enumerate(zip(touts, jouts)):
        assert t.dtype == {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}[j.dtype]
        _close(t.detach().float().numpy(), np.asarray(j.astype(jnp.float32)), mixed, f"{case} out {i}")
    if not (grad_idx or tparams):
        return  # SequenceMask: nothing to differentiate
    sum((t.float() * torch.from_numpy(r)).sum() for t, r in zip(touts, rs)).backward()
    for i in grad_idx:
        _close(tx[i].grad.float().numpy(), np.asarray(jgx[i].astype(jnp.float32)), mixed, f"{case} d x{i}", rs)
    for k, v in jgp.items():
        _close(tparams[k].grad.numpy(), np.asarray(v), mixed, f"{case} d {k}", rs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sequence_mask_into_attention_matches_jax(dtype):
    """BST's block: SequenceMask over lengths spread over 0..SEQ (rows with
    length 0 are fully masked: every score -10000, a uniform softmax), then
    MultiHeadAttention; forward and the gradients of q, k and v."""
    mixed = dtype == "bfloat16"
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if mixed else (jnp.float32, torch.float32)
    rng = np.random.default_rng(11)
    lengths = _lengths(rng)
    assert set(lengths.astype(np.int32).ravel()) == set(range(SEQ + 1))
    qkv = [rng.normal(size=(B, SEQ, 8)).astype(np.float32) for _ in range(3)]
    r = rng.normal(size=(B, SEQ, 8)).astype(np.float32)
    sm = dict(layer_type="SequenceMask", bottom_names=["l", "l"], top_names=["m"], max_sequence_len_from=SEQ,
              max_sequence_len_to=SEQ)
    mha = dict(layer_type="MultiHeadAttention", bottom_names=["q", "k", "v", "m"], top_names=["o"],
               num_attention_heads=4)
    ctx = LayerCtx(training=True, compute_dtype=jdt)

    def jloss(q, k, v):
        m = JLAYERS["SequenceMask"].apply({}, {}, [jnp.asarray(lengths)] * 2, jcfg.DenseLayer(**sm), ctx)[0][0]
        o = JLAYERS["MultiHeadAttention"].apply({}, {}, [q, k, v, m], jcfg.DenseLayer(**mha), ctx)[0][0]
        return jnp.sum(o.astype(jnp.float32) * r), o

    jx = [jnp.asarray(x).astype(jdt) for x in qkv]
    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(*jx)
    shapes = {"l": (B, 1), "q": (B, SEQ, 8), "k": (B, SEQ, 8), "v": (B, SEQ, 8)}
    net = TNetwork([tcfg.DenseLayer(**sm), tcfg.DenseLayer(**mha)], shapes, CPU.generator(0), CPU.device)
    tx = {n: torch.from_numpy(x).to(tdt).requires_grad_(True) for n, x in zip("qkv", qkv)}
    out = net.forward(dict(tx, l=torch.from_numpy(lengths)), tdt)
    assert out["m"].dtype == tdt and float(out["m"][lengths.ravel() < 1].sum()) == 0.0
    _close(out["o"].detach().float().numpy(), np.asarray(jo.astype(jnp.float32)), mixed, "attention out")
    (out["o"].float() * torch.from_numpy(r)).sum().backward()
    for i, n in enumerate("qkv"):
        _close(tx[n].grad.float().numpy(), np.asarray(jg[i].astype(jnp.float32)), mixed, f"d {n}", [r])


def _dropout(rate, seed=0, shape=(4000, 16)):
    cfg = tcfg.DenseLayer(layer_type="Dropout", bottom_names=["x"], top_names=["y"], dropout_rate=rate)
    return TLAYERS["Dropout"](cfg, [shape], CPU.generator(seed), CPU.device)


def test_dropout_keep_rate_scale_eval_and_seed():
    """The port's Dropout (its draws cannot match JAX's): in training, the
    kept share within 5 standard deviations of 1 - rate, kept values
    scaled by 1 / (1 - rate), the rest 0; identity in eval; the same masks
    from the same seed, another mask on the next call."""
    x = torch.rand((4000, 16)) + 0.5
    for rate in (0.5, 0.2):
        layer = _dropout(rate)
        layer.train()
        y = layer([x], torch.float32)[0]
        kept = y != 0
        n, keep = x.numel(), 1.0 - rate
        assert abs(float(kept.float().mean()) - keep) <= 5 * np.sqrt(keep * rate / n)
        torch.testing.assert_close(y[kept], x[kept] / keep, rtol=0, atol=0)
        again = layer([x], torch.float32)[0]
        assert not torch.equal(again != 0, kept)
        twin = _dropout(rate)
        twin.train()
        assert torch.equal(twin([x], torch.float32)[0], y)
        layer.eval()
        assert layer([x], torch.float32)[0] is x
    other = _dropout(0.5, seed=1)
    other.train()
    assert not torch.equal(other([x], torch.float32)[0] != 0, _dropout(0.5).train()([x], torch.float32)[0] != 0)
    zero = _dropout(0.0)
    zero.train()
    assert zero([x], torch.float32)[0] is x
