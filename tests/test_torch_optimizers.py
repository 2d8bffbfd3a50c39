"""The port's sparse and dense optimizers against the JAX package's, on the
same numpy inputs: SGD, MomentumSGD, Nesterov, AdaGrad, RowWiseAdaGrad,
RMSProp, Adam and FTRL on the dense sweep, the sorted route (segscan's
plain version) and a one-hot group (`_onehot_grad`, the Pallas kernel in
interpret mode on the JAX side); the seven dense optimizers over 3 steps.

Tolerances: float32 rtol 1e-4 / atol 1e-5 (float32 sums in another order);
bfloat16 tables and state rtol 2^-7 / atol 2^-6: the same float32 math
rounded once to bf16, from sums taken in another order, may round a step-1
value one ulp apart, and step 2 carries that ulp of an O(1) value (the
arrays hold |x| <= 2) into its result. FTRL's new weights are 0 where
|z| <= lambda1: where |z| lies within 1e-6 of lambda1 (one bf16 ulp of
lambda1 for bf16 z) a sum taken in another order may land on either side,
so those elements of w are left out of the comparison, counted, and
required to be few (z and n are compared everywhere).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugectr_tpu.core.types import Combiner_t as JComb
from hugectr_tpu.core.types import Optimizer_t as JOpt
from hugectr_tpu.embedding import sparse_optimizer as jso
from hugectr_tpu.embedding.collection import EmbeddingCollection as JEC
from hugectr_tpu.optim.dense import DenseOptimizer as JDenseOpt
from hugectr_tpu.optim.params import OptParams as JOptParams
from hugectr_tpu.parallel import plan as jplan

from hugectr_tpu_torch import ops
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Combiner_t as TComb
from hugectr_tpu_torch.core.types import Optimizer_t as TOpt
from hugectr_tpu_torch.embedding import sparse_optimizer as tso
from hugectr_tpu_torch.embedding.collection import EmbeddingCollection as TEC
from hugectr_tpu_torch.optim.dense import DenseOptimizer as TDenseOpt
from hugectr_tpu_torch.optim.params import OptParams as TOptParams
from hugectr_tpu_torch.parallel import plan as tplan

torch.set_num_threads(1)
CPU = ResourceManager.create(device="cpu")
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2.0**-7, atol=2.0**-6)
KINDS = ["sgd", "momentum_sgd", "nesterov", "adagrad", "rowwise_adagrad", "rmsprop", "adam", "ftrl"]
# hyperparameters that make every term count: FTRL's threshold zeroes part
# of the rows, Adam's bias corrections differ between steps 1 and 2
HYPER = dict(momentum_factor=0.9, beta=0.8, beta1=0.9, beta2=0.99, epsilon=1e-6, initial_accu_value=0.1,
             lambda1=1.0, lambda2=0.1, ftrl_beta=0.1)
LR = 0.05
ROWS, E = 300, 8
TOUCHED_ZERO = 7  # a row touched twice with opposite gradients


def _opts(kind):
    return JOptParams(JOpt(kind), **HYPER), TOptParams(TOpt(kind), **HYPER)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t).astype(np.float32)


def _start_state(rng, kind, rows, width=E):
    """Nonzero starting state (positive for the accumulators and n), so
    that a zero gradient still changes Momentum's and FTRL's rows."""
    topt = TOptParams(TOpt(kind), **HYPER)
    out = {}
    for k, v in tso.init_state(topt, rows, width).items():
        a = rng.normal(size=v.shape).astype(np.float32) * 0.5
        out[k] = np.abs(a) if k in ("accum", "v", "n") else a
    return out


def assert_ftrl_close(got_w, want_w, want_z, lambda1, tol, what, band=1e-6):
    """w agrees outside the threshold band ||z| - lambda1| <= band; the band
    holds at most 1% of the elements."""
    near = np.abs(np.abs(want_z) - lambda1) <= band
    assert near.sum() <= max(2, near.size // 100), f"{what}: {near.sum()} elements at the threshold"
    np.testing.assert_allclose(np.where(near, 0, got_w), np.where(near, 0, want_w), **tol, err_msg=what)


def _compare(kind, tt, ts, jt, js, tol, what):
    if kind == "ftrl":
        band = 1e-6 if tt.dtype == torch.float32 else 2.0**-7 * HYPER["lambda1"]
        assert_ftrl_close(_np(tt), _np(jt), _np(js["z"]), HYPER["lambda1"], tol, f"{what} table", band)
    else:
        np.testing.assert_allclose(_np(tt), _np(jt), **tol, err_msg=f"{what} table")
    assert set(ts) == set(js)
    for k in ts:
        np.testing.assert_allclose(_np(ts[k]), _np(js[k]), **tol, err_msg=f"{what} state {k}")


def _sparse_inputs(rng, step):
    k, s = 900, 400
    idx = rng.integers(0, ROWS + 20, k).astype(np.int32)
    idx[idx >= ROWS] = ROWS  # sentinel: invalid keys
    src = rng.integers(0, s, k).astype(np.int32)
    dsrc = rng.normal(size=(s, E)).astype(np.float32)
    # row 7 gets two keys whose gradients cancel exactly; row 11 three
    # duplicate keys of one source row
    idx[:5] = [TOUCHED_ZERO, TOUCHED_ZERO, 11, 11, 11]
    src[:5] = [s - 2, s - 1, 3, 3, 3]
    dsrc[s - 1] = -dsrc[s - 2]
    idx[idx == TOUCHED_ZERO] = ROWS
    idx[:2] = TOUCHED_ZERO
    return idx, src, dsrc


# (kind, route, dtype): every stateful kind on both routes in float32, Adam
# and FTRL also in bfloat16; SGD has its one scatter route
SPARSE_CASES = (
    [("sgd", "scatter", "float32")]
    + [(k, r, "float32") for k in KINDS[1:] for r in ("dense", "sorted")]
    + [(k, r, "bfloat16") for k in ("adam", "ftrl") for r in ("dense", "sorted")]
)
# the kinds whose table moves on a touched row with a zero summed gradient
MOVES_ON_ZERO = ("momentum_sgd", "nesterov", "adam", "ftrl")


@pytest.mark.parametrize("kind,route,dtype", SPARSE_CASES)
def test_apply_sparse_matches_jax(kind, route, dtype):
    """Two steps of `apply_sparse` from the same nonzero state; bf16 tables
    and state with lr in the table's type, as the collection passes it."""
    rng = np.random.default_rng(KINDS.index(kind) + 10)
    jopt, topt = _opts(kind)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    table = rng.normal(size=(ROWS, E)).astype(np.float32) * 0.5
    state = _start_state(rng, kind, ROWS, 1 if kind == "rowwise_adagrad" else E)
    jt, js = jnp.asarray(table, jdt), {k: jnp.asarray(v, jdt) for k, v in state.items()}
    # copies: the port updates in place, and a float32 JAX array may share
    # the numpy buffer while its asynchronous update has not read it yet
    tt = torch.from_numpy(table.copy()).to(tdt)
    ts = {k: torch.from_numpy(v.copy()).to(tdt) for k, v in state.items()}
    dense_rows = 1000 if route == "dense" else 0
    for step in (1, 2):
        idx, src, dsrc = _sparse_inputs(rng, step)
        jt, js = jso.apply_sparse(
            jopt, jt, js, jnp.asarray(idx), jnp.asarray(src), jnp.asarray(dsrc, jdt), jnp.asarray(LR, jdt),
            jnp.asarray(step), segsum="scan" if dtype == "float32" else "xla", dense_rows=dense_rows,
            dense_ratio=0.0,
        )
        got = tso.apply_sparse(
            topt, tt, ts, torch.from_numpy(idx).long(), torch.from_numpy(src).long(),
            torch.from_numpy(dsrc).to(tdt), torch.tensor(LR, dtype=tdt), dense_rows=dense_rows,
            dense_ratio=0.0, step=step,
        )
        assert got == route
        _compare(kind, tt, ts, jt, js, F32_TOL if dtype == "float32" else BF16_TOL, f"{kind} step {step}")


@pytest.mark.parametrize("kind", ["ftrl", "momentum_sgd", "adam"])
def test_touched_row_with_zero_sum_is_updated(kind):
    """A row hit by two keys whose gradients cancel is touched: on the dense
    sweep FTRL recomputes its weights from z, Momentum and Adam decay its
    moments (the JAX package's touch-count column, sparse_optimizer.py:
    464-504). With the touched mask taken from `grad != 0`, as for the
    AdaGrad family, the row would keep its table and state."""
    rng = np.random.default_rng(3)
    jopt, topt = _opts(kind)
    table = rng.normal(size=(ROWS, E)).astype(np.float32) * 0.5
    state = _start_state(rng, kind, ROWS)
    idx, src, dsrc = _sparse_inputs(rng, 1)
    jt, js = jso.apply_sparse(
        jopt, jnp.asarray(table), {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(idx),
        jnp.asarray(src), jnp.asarray(dsrc), jnp.asarray(LR, jnp.float32), jnp.asarray(1),
        dense_rows=1000, dense_ratio=0.0,
    )
    tt = torch.from_numpy(table.copy())
    ts = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    assert tso.apply_sparse(topt, tt, ts, torch.from_numpy(idx).long(), torch.from_numpy(src).long(),
                            torch.from_numpy(dsrc), torch.tensor(LR), dense_rows=1000, dense_ratio=0.0) == "dense"
    _compare(kind, tt, ts, jt, js, F32_TOL, kind)
    r = TOUCHED_ZERO
    assert not np.allclose(tt[r].numpy(), table[r]), "the touched row kept its weights"
    if kind != "ftrl":  # FTRL's z moves by g - sigma w, 0 for g = 0
        assert not np.allclose(ts["m"][r].numpy(), state["m"][r]), "the touched row kept its moments"
    untouched = np.setdiff1d(np.arange(ROWS), idx)
    assert untouched.size
    np.testing.assert_array_equal(tt[untouched].numpy(), table[untouched])
    for k, v in ts.items():
        np.testing.assert_array_equal(v[untouched].numpy(), state[k][untouched])


@pytest.mark.parametrize("kind", ["rowwise_adagrad", "adagrad", "ftrl", "adam"])
def test_key_ratio_rule_is_adagrad_only(kind):
    """The key-ratio rule sends a big shard with many keys to the dense
    sweep for the AdaGrad family only (sparse_optimizer.py:441-446): FTRL
    and Adam stay on the sorted route, as the JAX package's do, with the
    same results. At full size: a 400,000-row table with 200,000 keys."""
    adagrad = kind in ("rowwise_adagrad", "adagrad")
    assert tso.update_route(400_000, 200_000, 262144, 0.3, TOpt(kind)) == ("dense" if adagrad else "sorted")
    rng = np.random.default_rng(5)
    jopt, topt = _opts(kind)
    table = rng.normal(size=(ROWS, E)).astype(np.float32) * 0.5
    state = _start_state(rng, kind, ROWS, 1 if kind == "rowwise_adagrad" else E)
    idx, src, dsrc = _sparse_inputs(rng, 1)  # 900 keys >= 0.3 x 300 rows
    jt, js = jso.apply_sparse(
        jopt, jnp.asarray(table), {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(idx),
        jnp.asarray(src), jnp.asarray(dsrc), jnp.asarray(LR, jnp.float32), jnp.asarray(1),
        segsum="scan", dense_rows=0, dense_ratio=0.3,
    )
    tt = torch.from_numpy(table.copy())
    ts = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    got = tso.apply_sparse(topt, tt, ts, torch.from_numpy(idx).long(), torch.from_numpy(src).long(),
                           torch.from_numpy(dsrc), torch.tensor(LR), dense_rows=0, dense_ratio=0.3)
    assert got == ("dense" if adagrad else "sorted")
    _compare(kind, tt, ts, jt, js, F32_TOL, kind)


def _onehot_lookups(pkg, comb):
    t0 = pkg.EmbeddingTableConfig("t0", 57, E)
    t1 = pkg.EmbeddingTableConfig("t1", 100, E)
    return [pkg.LookupConfig(0, t0, "f0", "e0", comb.Sum, 3), pkg.LookupConfig(1, t1, "f1", "e1", comb.Mean, 2)]


@pytest.mark.parametrize("kind", KINDS)
def test_onehot_group_update_matches_jax(mesh1, monkeypatch, kind):
    """Two steps of `backward_and_update` on a one-hot group (sum and mean
    lookups, -1 padding, row 5 of t0 hit by two samples whose cotangents
    cancel): `_onehot_grad` and `apply_dense` with `colsum > 0` for every
    optimizer, against the JAX package's `_onehot_bwd_local` with the
    Pallas backward in interpret mode."""
    monkeypatch.setenv("HCTR_TPU_ONEHOT_VOCAB", "128")
    monkeypatch.setenv("HCTR_TPU_ONEHOT_KERNEL", "pallas")
    rng = np.random.default_rng(KINDS.index(kind) + 40)
    jopt, topt = _opts(kind)
    jec = JEC(jplan.compile_plan(_onehot_lookups(jplan, JComb), jplan.ShardingPlan([]), 1), mesh1, jopt)
    tec = TEC(tplan.compile_plan(_onehot_lookups(tplan, TComb), tplan.ShardingPlan([]), 1, onehot_vocab=128),
              CPU, topt)
    g = tec.plan.groups[0]
    assert [x.compute_kind for x in tec.plan.groups] == ["onehot"]
    table = rng.normal(size=(g.total_storage_rows, E)).astype(np.float32) * 0.5
    state = _start_state(rng, kind, g.total_storage_rows, 1 if kind == "rowwise_adagrad" else E)
    jt = {g.name: jnp.asarray(table)}
    js = {g.name: {k: jnp.asarray(v) for k, v in state.items()}}
    tt = {g.name: torch.from_numpy(table.copy())}
    ts = {g.name: {k: torch.from_numpy(v.copy()) for k, v in state.items()}}
    step_fn = jax.jit(jec.backward_and_update)
    b = 24
    ops.reset_counts()
    for step in (1, 2):
        feats = {"f0": rng.integers(0, 57, (b, 3)).astype(np.int32),
                 "f1": rng.integers(-1, 100, (b, 2)).astype(np.int32)}
        d = {"e0": rng.normal(size=(b, E)).astype(np.float32), "e1": rng.normal(size=(b, E)).astype(np.float32)}
        feats["f0"][:2] = [[5, -1, -1], [5, -1, -1]]
        feats["f0"][2:][feats["f0"][2:] == 5] = -1
        d["e0"][1] = -d["e0"][0]
        jt, js = step_fn(jt, js, feats, d, jnp.asarray(LR), jnp.asarray(step))
        tec.backward_and_update(tt, ts, {k: torch.from_numpy(v) for k, v in feats.items()},
                                {k: torch.from_numpy(v) for k, v in d.items()}, torch.tensor(LR), step)
        _compare(kind, tt[g.name], ts[g.name], jt[g.name], js[g.name], F32_TOL, f"{kind} step {step}")
    assert tec.group_routes == {g.name: "onehot"}
    assert ops.plain_counts()["onehot_bwd"] == 2  # one call for the two tables a step, two steps
    if kind in MOVES_ON_ZERO:  # the touched row with a zero sum moved
        assert not np.allclose(tt[g.name][5].numpy(), table[5])


DENSE_KINDS = ["sgd", "momentum_sgd", "nesterov", "adagrad", "rmsprop", "adam", "ftrl"]


@pytest.mark.parametrize("kind", DENSE_KINDS)
def test_dense_optimizer_matches_jax(kind):
    """`DenseOptimizer` against `hugectr_tpu.optim.dense.DenseOptimizer`,
    3 steps over a two-layer parameter tree (a zero-gradient element
    included), in place from `.grad`."""
    rng = np.random.default_rng(DENSE_KINDS.index(kind) + 70)
    jopt_p, topt_p = _opts(kind)
    params = {
        "l0_MLP": {"weight_0": rng.normal(size=(6, 4)).astype(np.float32),
                   "bias_0": rng.normal(size=(4,)).astype(np.float32)},
        "l2_MultiCross": {"U_0": rng.normal(size=(4, 3)).astype(np.float32)},
    }
    jopt, topt = JDenseOpt(jopt_p), TDenseOpt(topt_p)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jopt.init(jp)
    tp = {layer: {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in ps.items()}
          for layer, ps in params.items()}
    tst = topt.init(tp)
    assert set(tst) == set(jst)
    for step in (1, 2, 3):
        grads = {layer: {k: rng.normal(size=v.shape).astype(np.float32) for k, v in ps.items()}
                 for layer, ps in params.items()}
        grads["l0_MLP"]["bias_0"][1] = 0.0
        jp, jst = jopt.update(jp, jst, jax.tree.map(jnp.asarray, grads), jnp.asarray(LR), jnp.asarray(step))
        for layer, ps in tp.items():
            for k, p in ps.items():
                p.grad = torch.from_numpy(grads[layer][k])
        topt.update(tp, tst, torch.tensor(LR), step)
        for layer, ps in tp.items():
            for k, p in ps.items():
                what = f"{kind} step {step} {layer}/{k}"
                if kind == "ftrl":
                    assert_ftrl_close(_np(p), _np(jp[layer][k]), _np(jst["z"][layer][k]), HYPER["lambda1"],
                                      F32_TOL, what)
                else:
                    np.testing.assert_allclose(_np(p), _np(jp[layer][k]), **F32_TOL, err_msg=what)
                for key in tst:
                    np.testing.assert_allclose(_np(tst[key][layer][k]), _np(jst[key][layer][k]), **F32_TOL,
                                               err_msg=f"{what} state {key}")
