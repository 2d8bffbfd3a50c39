"""Hybrid-parallel embedding collections of every configuration the port
trains on one device, over W ranks, against the JAX package on a W-device
CPU mesh: bf16 tables and state with the hot/cold/superhot split, exact
dynamic tables, and partial placement (`shard_matrix` giving a table fewer
shards than ranks). The port's ranks are spawned gloo processes
(`tools/hybrid.py::run`, rank functions in `tests/torch_rank_fns.py`); JAX
runs in this process. Each rank reads its block of the global batch.
(The models of these configurations: `tests/test_torch_hybrid_models.py`.)

Cases (`torch_rank_fns.CASES`), two steps each:
* w2_bf16_split (bf16 tables and state, rowwise AdaGrad; superhot tier in
  the one-hot group, hot tier on the dense sweep, cold tier on the sorted
  route): forward outputs bitwise (both packages at their default, the
  owner-partitioned forward: each slot's owned rows added in ascending row
  order with a rounding to bf16 after every add, and the two ranks' pools
  added in bf16, which commutes); tables in key order and each rank's
  storage and state within one bf16 ulp at the tables' scale (rtol 2^-7,
  atol 2^-7 x 0.1; state atol 1e-7): the updates sum in float32 in
  another order, so a value next to a rounding boundary may land on its
  neighbour;
* w2_dynamic_ftrl (FTRL, dense sweep) and w4_dynamic (rowwise AdaGrad,
  sorted route): each shard's key store bitwise equal to the JAX mesh's
  block of it; forward outputs rtol 1e-5 / atol 1e-6, tables and state
  rtol 1e-4 / atol 1e-5 (float32 sums in another order), FTRL weights
  whose z lies within 1e-6 of lambda1 left out (at most 1% of them);
* w4_partial (rowwise AdaGrad; t0 on 2 shards, 2 replicas each, on the
  dense sweep; t1 on 1 shard, 4 replicas, on the sorted route): as the
  float32 cases, and every replica of a shard bitwise equal to the others.
Every case: the route map exact, replicated groups bitwise equal.

One group of 2 ranks runs the W = 2 cases and one of 4 the W = 4 cases,
each once per module.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_fns as fns
from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.core.types import Combiner_t as JComb
from hugectr_tpu.core.types import Optimizer_t as JOpt
from hugectr_tpu.embedding.collection import EmbeddingCollection as JEC
from hugectr_tpu.optim.params import OptParams as JOptParams
from hugectr_tpu.parallel import plan as jplan
from hugectr_tpu_torch.tools import hybrid

from test_torch_optimizers import assert_ftrl_close

torch.set_num_threads(1)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_ULP = 2.0**-7
BF16_TOL = dict(rtol=BF16_ULP, atol=BF16_ULP * 0.1)
EMPTY = 2**31 - 1
B, LR, STEPS = 48, 0.3, 2

# name: (world, optimizer, case of torch_rank_fns.CASES)
EC_CASES = {
    "w2_bf16_split": (2, "rowwise_adagrad", "split"),
    "w2_dynamic_ftrl": (2, "ftrl", "dynamic"),
    "w4_partial": (4, "rowwise_adagrad", "partial"),
    "w4_dynamic": (4, "rowwise_adagrad", "dynamic_sorted"),
}
ROUTES = {
    "w2_bf16_split": {"onehot_ev8": "onehot", "mp_ev8": "dense", "mp_ev8_big::cold": "sorted"},
    "w2_dynamic_ftrl": {"mp_ev8": "dense", "onehot_ev8": "onehot"},
    "w4_partial": {"mp_ev8_x2": "dense", "mp_ev8_x1": "sorted"},
    "w4_dynamic": {"mp_ev8": "sorted", "onehot_ev8": "onehot"},
}
def _ec_inputs(name):
    _w, optimizer, case = EC_CASES[name]
    return fns.ec_inputs(optimizer, B, STEPS, LR, case)


def _jax_collection(name):
    """JAX's collection of a case on its mesh, the same two steps: the
    outputs of each step, the static tables in key order, the global storage
    (key stores too) and state, the JAX plan."""
    world, optimizer, case = EC_CASES[name]
    c = fns.CASES[case]
    inputs = _ec_inputs(name)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in c["env"].items():
            mp.setenv(k, v)
        pl = jplan.compile_plan(fns.ec_lookups(jplan, JComb, case), jplan.ShardingPlan(c["strategy"]), world,
                                c["shard_counts"])
        dt = jnp.bfloat16 if c["dtype"] == "bfloat16" else jnp.float32
        jec = JEC(pl, JaxResourceManager.create(num_devices=world), JOptParams(JOpt(optimizer), **fns.OPT_HYPER),
                  dtype=dt)
        jt = jec.init(jax.random.key(0))
        for g in pl.groups:
            if g.slot_is_dynamic.any():
                jt[g.name] = jnp.zeros_like(jt[g.name])
        for t, values in inputs["tables"].items():
            jt = jec.import_table(jt, t, values)
        js = jec.init_optimizer(jt)
        fwd, bwd = jax.jit(jec.forward), jax.jit(jec.backward_and_update)
        outs = {}
        for step in range(1, STEPS + 1):
            outs[str(step)] = {k: np.asarray(v.astype(jnp.float32)) for k, v in fwd(jt, inputs["keys"]).items()}
            d = {k: jnp.asarray(v, dt) for k, v in inputs["d"][str(step)].items()}
            jt, js = bwd(jt, js, inputs["keys"], d, jnp.asarray(LR), jnp.asarray(step))
        tables = {t: np.asarray(jec.export_table(jt, t)).astype(np.float32) for t in inputs["tables"]}
    host = lambda a: np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a)  # noqa: E731
    return (outs, tables, {k: host(v) for k, v in jt.items()},
            {g: {k: host(v) for k, v in st.items()} for g, st in js.items()}, pl)


@pytest.fixture(scope="module")
def port_w2():
    inputs = {"ec": {n: _ec_inputs(n) for n, (w, *_r) in EC_CASES.items() if w == 2},
              "calls": json.dumps({"ec": "collection_cases"})}
    return [r["ec"] for r in hybrid.run(fns.several, 2, inputs, device="cpu")]


@pytest.fixture(scope="module")
def port_w4():
    inputs = {"ec": {n: _ec_inputs(n) for n, (w, *_r) in EC_CASES.items() if w == 4},
              "calls": json.dumps({"ec": "collection_cases"})}
    return [r["ec"] for r in hybrid.run(fns.several, 4, inputs, device="cpu")]


@pytest.fixture(scope="module")
def jax_ec():
    """JAX's results of each collection case, made once."""
    return {}


@pytest.fixture
def ec_case(request, port_w2, port_w4, jax_ec):
    """(name, the ranks' results, JAX's results) of one case."""
    name = request.param
    world = EC_CASES[name][0]
    ranks = [r[name] for r in (port_w4 if world == 4 else port_w2)]
    if name not in jax_ec:
        jax_ec[name] = _jax_collection(name)
    return name, ranks, jax_ec[name]


def _tols(name):
    if fns.CASES[EC_CASES[name][2]]["dtype"] == "bfloat16":
        return dict(rtol=0, atol=0), BF16_TOL
    return FWD_TOL, TOL


def _close(got, want, z, tol, what):
    if z is not None:
        assert_ftrl_close(got, want, z, fns.OPT_HYPER["lambda1"], tol, what)
    else:
        np.testing.assert_allclose(got, want, **tol, err_msg=what)


@pytest.mark.parametrize("ec_case", list(EC_CASES), indirect=True)
def test_collection_forward_matches_jax(ec_case):
    name, ranks, (jouts, *_rest) = ec_case
    fwd_tol, _tol = _tols(name)
    n = B // len(ranks)
    for step, want in jouts.items():
        for r, res in enumerate(ranks):
            for top, w in want.items():
                np.testing.assert_allclose(res["fwd"][step][top], w[r * n : (r + 1) * n], **fwd_tol,
                                           err_msg=f"{name} step {step} rank {r} {top}")


@pytest.mark.parametrize("ec_case", list(EC_CASES), indirect=True)
def test_collection_update_matches_jax(ec_case):
    """Static tables in key order on every rank, and each rank's storage,
    key store and state against its block of JAX's global arrays (the whole
    array for a replicated group); key stores bit for bit."""
    name, ranks, (_o, jtables, jstore, jstate, pl) = ec_case
    _fwd, tol = _tols(name)
    ftrl = EC_CASES[name][1] == "ftrl"
    for r, res in enumerate(ranks):
        for t, want in jtables.items():
            np.testing.assert_allclose(res["tables"][t], want, **tol, err_msg=f"{name} rank {r} table {t}")
        for g in pl.groups:
            n = res["storage"][g.name].shape[0]
            sl = slice(r * n, (r + 1) * n) if g.is_model_parallel else slice(None)
            if g.slot_is_dynamic.any():
                store = res["storage"][f"{g.name}#keys"]
                np.testing.assert_array_equal(store, jstore[f"{g.name}#keys"][sl], err_msg=f"{name} rank {r}")
                assert (store != EMPTY).sum() > 10
            z = jstate[g.name]["z"][sl] if ftrl else None
            _close(res["storage"][g.name], jstore[g.name][sl], z, tol, f"{name} rank {r} storage {g.name}")
            for k, v in res["state"][g.name].items():
                st_tol = dict(tol, atol=1e-7) if tol is BF16_TOL else tol
                _close(v, jstate[g.name][k][sl], None, st_tol, f"{name} rank {r} state {g.name}/{k}")


@pytest.mark.parametrize("ec_case", list(EC_CASES), indirect=True)
def test_collection_routes_and_replicas(ec_case):
    """Each group's route is the one the JAX package's rules pick at W; a
    replicated group (one-hot) and every replica of a shard (a partial
    placement's) hold bitwise-equal storage and state; a dynamic group's
    shards hold disjoint keys of each table."""
    name, ranks, (*_r, pl) = ec_case
    assert {g.name for g in pl.groups} == set(ROUTES[name])
    for res in ranks:
        assert res["routes"] == ROUTES[name]
    w = len(ranks)
    for g in pl.groups:
        f = g.num_shards if g.is_model_parallel else 1
        for r in range(f, w):  # rank r holds the same shard as rank r % f
            a, b = ranks[r], ranks[r % f]
            np.testing.assert_array_equal(a["storage"][g.name], b["storage"][g.name], err_msg=f"{g.name} rank {r}")
            for k, v in a["state"][g.name].items():
                np.testing.assert_array_equal(v, b["state"][g.name][k], err_msg=f"{g.name}/{k} rank {r}")
        if g.slot_is_dynamic.any() and f > 1:
            for ti, t in enumerate(g.tables):
                off, rows = int(g.local_offsets[ti]), int(g.rows_per_shard[ti])
                held = [res["storage"][f"{g.name}#keys"][off : off + rows] for res in ranks[:f]]
                held = np.concatenate([h[h != EMPTY] for h in held])
                assert held.size == np.unique(held).size, f"{t.name}: a key in two shards"
    if name == "w4_partial":
        assert [(g.name, g.num_shards, g.num_replicas) for g in pl.groups] == [("mp_ev8_x2", 2, 2),
                                                                              ("mp_ev8_x1", 1, 4)]
