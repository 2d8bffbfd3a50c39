"""Hybrid-parallel training over W ranks, against the JAX package on a
W-device CPU mesh: the port's ranks are spawned gloo processes
(`hugectr_tpu_torch.tools.hybrid.run`, rank functions in
`tests/torch_rank_fns.py` and `tools/hybrid.py::train_model`); JAX runs in
this process. Each rank reads its block of the global batch.

* The embedding collection (one-hot, model-parallel sorted and dense sweep,
  data-parallel rowop; Sum, Mean and Concat lookups; rowwise AdaGrad and
  FTRL, whose touch counts cross
  the shards) at W = 2, and rowwise AdaGrad at W = 4: forward outputs of
  two steps rtol 1e-5 / atol 1e-6 (float32 sums in another order, partial
  pools summed over ranks), tables and state after two updates rtol 1e-4 /
  atol 1e-5, route maps exact, replicated groups bitwise equal across
  ranks. FTRL weights whose z lies within 1e-6 of lambda1 may take either
  side of the threshold: they are left out, at most 1% of them.
* The tiny DLRM-DCNv2 `Model` at W = 2 from JAX's carried state, 3 steps
  and an eval: losses rtol 1e-4, tables and dense parameters rtol 1e-4 /
  atol 1e-5, AUC within 1e-6; replicas bitwise equal across ranks; and the
  same against the port itself at W = 1 from the same state.

Two groups are spawned (W = 2 runs every W = 2 case, W = 4 one case), each
once per module.
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
from hugectr_tpu.tools import flagship as jflagship
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.tools import flagship as tflagship
from hugectr_tpu_torch.tools import hybrid
from hugectr_tpu_torch.tools.carry import load_jax_state

torch.set_num_threads(1)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
B, LR, STEPS = 48, 0.3, 2
EC_CASES = {"w2_rowwise_adagrad": (2, "rowwise_adagrad"), "w2_ftrl": (2, "ftrl"),
            "w4_rowwise_adagrad": (4, "rowwise_adagrad")}
ROUTES = {"onehot_ev8": "onehot", "mp_ev8_t2": "sorted", "mp_ev8": "dense", "dp_ev8": "dense"}
# the tiny DLRM-DCNv2 as test_torch_model.py runs it: one-hot for vocab <=
# 100, the rest one model-parallel group on the sorted segscan route
MODEL_ENV = {"HCTR_TPU_ONEHOT_VOCAB": "100", "HCTR_TPU_DENSE_UPDATE_ROWS": "0",
             "HCTR_TPU_DENSE_KEY_RATIO": "0", "HCTR_TPU_ONEHOT_KERNEL": "xla", "HCTR_TPU_HOT_ROWS": "0",
             "HCTR_BENCH_OPT": "rowwise_adagrad"}
MODEL_KW = dict(batchsize=64, onehot_vocab=100, dense_update_rows=0, dense_key_ratio=0.0)


def _ec_inputs(optimizer):
    return fns.ec_inputs(optimizer, B, STEPS, LR)


def _jax_collection(world, optimizer, inputs):
    """JAX's collection on a `world`-device mesh, the same two steps: the
    outputs of each step, the tables in key order, the global storage and
    state, the JAX plan."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in fns.EC_ENV.items():
            mp.setenv(k, v)
        return _jax_steps(world, optimizer, inputs)


def _jax_steps(world, optimizer, inputs):
    pl = jplan.compile_plan(fns.ec_lookups(jplan, JComb), jplan.ShardingPlan(fns.EC_STRATEGY), world)
    jec = JEC(pl, JaxResourceManager.create(num_devices=world), JOptParams(JOpt(optimizer), **fns.OPT_HYPER))
    jt = jec.init(jax.random.key(0))
    for name, values in inputs["tables"].items():
        jt = jec.import_table(jt, name, values)
    js = jec.init_optimizer(jt)
    fwd, bwd = jax.jit(jec.forward), jax.jit(jec.backward_and_update)
    outs = {}
    for step in range(1, STEPS + 1):
        outs[str(step)] = jax.device_get(fwd(jt, inputs["keys"]))
        jt, js = bwd(jt, js, inputs["keys"], inputs["d"][str(step)], jnp.asarray(LR), jnp.asarray(step))
    tables = {t: jec.export_table(jt, t) for t in inputs["tables"]}
    return outs, tables, jax.device_get(jt), jax.device_get(js), pl


@pytest.fixture(scope="module")
def port_w2():
    """One spawned group of 2 ranks runs every W = 2 case: the collection
    with each optimizer, and the tiny model from JAX's carried state."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in MODEL_ENV.items():
            mp.setenv(k, v)
        mp.delenv("HCTR_TPU_EMB_DTYPE", raising=False)
        jm = jflagship.build_tiny_dlrm(JaxResourceManager.create(num_devices=2), batchsize=64)
    st = jax.device_get(jm.state)
    state = {k: st[k] for k in ("emb_tables", "eopt", "dense_params", "dopt", "step")}
    cfg = dict(builder="build_tiny_dlrm", kwargs=MODEL_KW, steps=3, eval=True)
    inputs = {"ec": {n: _ec_inputs(o) for n, (w, o) in EC_CASES.items() if w == 2},
              "model": {"config": json.dumps(cfg), "state": state}}
    inputs = {"calls": json.dumps({"ec": "collection_cases", "model": "train_model"}), **inputs}
    res = hybrid.run(fns.several, 2, inputs, device="cpu")
    return {"ec": [r["ec"] for r in res], "model": [r["model"] for r in res], "jax_model": jm, "state": state}


@pytest.fixture(scope="module")
def port_w4():
    inputs = _ec_inputs("rowwise_adagrad")
    return {"w4_rowwise_adagrad": hybrid.run(fns.collection_steps, 4, inputs, device="cpu")}


@pytest.fixture(scope="module")
def jax_ec():
    """JAX's results of each collection case, made once."""
    return {}


@pytest.fixture
def ec_case(request, port_w2, port_w4, jax_ec):
    """(world, optimizer, the ranks' results, JAX's results) of one case."""
    world, optimizer = EC_CASES[request.param]
    ranks = port_w4[request.param] if world == 4 else [r[request.param] for r in port_w2["ec"]]
    if request.param not in jax_ec:
        jax_ec[request.param] = _jax_collection(world, optimizer, _ec_inputs(optimizer))
    return world, optimizer, ranks, jax_ec[request.param]


def _close(got, want, z, optimizer, tol, what):
    """FTRL weights whose z lies within 1e-6 of lambda1 are left out (at
    most 1% of them); everything else within `tol`."""
    near = np.zeros(want.shape, bool)
    if optimizer == "ftrl" and z is not None:
        near = np.abs(np.abs(z) - fns.OPT_HYPER["lambda1"]) <= 1e-6
        assert near.sum() <= max(2, near.size // 100), f"{what}: {near.sum()} at the threshold"
    np.testing.assert_allclose(np.where(near, 0, got), np.where(near, 0, want), **tol, err_msg=what)


@pytest.mark.parametrize("ec_case", list(EC_CASES), indirect=True)
def test_collection_forward_matches_jax(ec_case):
    world, _opt, ranks, (jouts, *_rest) = ec_case
    n = B // world
    for step, want in jouts.items():
        for r, res in enumerate(ranks):
            for top, w in want.items():
                np.testing.assert_allclose(res["fwd"][step][top], np.asarray(w)[r * n : (r + 1) * n],
                                           **FWD_TOL, err_msg=f"step {step} rank {r} {top}")


@pytest.mark.parametrize("ec_case", list(EC_CASES), indirect=True)
def test_collection_update_matches_jax(ec_case):
    """Tables in key order on every rank, and each rank's storage and state
    against its block of JAX's global arrays (the whole array for a
    replicated group)."""
    world, optimizer, ranks, (_o, jtables, jstore, jstate, pl) = ec_case
    for r, res in enumerate(ranks):
        for t, want in jtables.items():
            np.testing.assert_allclose(res["tables"][t], want, **TOL, err_msg=f"rank {r} table {t}")
        for g in pl.groups:
            n = res["storage"][g.name].shape[0]
            sl = slice(r * n, (r + 1) * n) if g.is_model_parallel else slice(None)
            zs = np.asarray(jstate[g.name]["z"])[sl] if optimizer == "ftrl" else None
            _close(res["storage"][g.name], np.asarray(jstore[g.name])[sl], zs, optimizer, TOL,
                   f"rank {r} storage {g.name}")
            for k, v in res["state"][g.name].items():
                _close(v, np.asarray(jstate[g.name][k])[sl], None, optimizer, TOL, f"rank {r} state {g.name}/{k}")


@pytest.mark.parametrize("ec_case", list(EC_CASES), indirect=True)
def test_collection_routes_and_replicas(ec_case):
    """Each group's route is the one the JAX package's rules pick at W, and
    the replicated groups (one-hot, data-parallel) hold bitwise-equal
    storage and state on every rank."""
    world, _opt, ranks, (*_r, pl) = ec_case
    assert [g.name for g in pl.groups] == list(ROUTES)
    for res in ranks:
        assert res["routes"] == ROUTES
    for g in ("onehot_ev8", "dp_ev8"):
        for res in ranks[1:]:
            np.testing.assert_array_equal(res["storage"][g], ranks[0]["storage"][g])
            for k, v in res["state"][g].items():
                np.testing.assert_array_equal(v, ranks[0]["state"][g][k])


def test_model_matches_jax_on_two_devices(port_w2, monkeypatch):
    """The tiny DLRM-DCNv2 at W = 2 against the JAX Model on a 2-device mesh
    from the same state: 3 steps and an eval."""
    for k, v in MODEL_ENV.items():
        monkeypatch.setenv(k, v)
    jm = port_w2["jax_model"]
    jl = [jm.train() for _ in range(3)]
    jev = jm.eval()
    ranks = port_w2["model"]
    for res in ranks:
        np.testing.assert_allclose(res["losses"], jl, rtol=1e-4)
        assert abs(res["eval"]["auc"] - jev["auc"]) <= 1e-6
        assert res["routes"] == {"mp_ev16": "sorted", "onehot_ev16": "onehot"}
    state = jax.device_get(jm.state)
    for layer, ps in state["dense_params"].items():
        for k, v in ps.items():
            np.testing.assert_allclose(ranks[0]["dense"][f"{layer}.{k}"], v, **TOL, err_msg=f"{layer}/{k}")
    for i in range(26):
        want = jm.ec.export_table(jm.state["emb_tables"], str(i))
        for r, res in enumerate(ranks):
            np.testing.assert_allclose(res["tables"][str(i)], want, **TOL, err_msg=f"rank {r} table {i}")


def test_model_replicas_bitwise_equal(port_w2):
    """Dense parameters and their state, the one-hot tables and their state:
    the same bits on both ranks after 3 steps; and every kernel's plain
    version ran on each rank (one-hot forward per step and eval batch,
    backward per one-hot table and step, segscan per step)."""
    a, b = port_w2["model"]
    assert set(a["replicated"]) == set(b["replicated"])
    assert any(k.startswith("table:onehot") for k in a["replicated"])
    for k, v in a["replicated"].items():
        np.testing.assert_array_equal(b["replicated"][k], v, err_msg=k)
    for res in (a, b):
        assert res["plain_calls"] == {"segscan": 3, "onehot_fwd": 3, "onehot_bwd": 3 * 6}
        assert res["eval_counts"]["plain_calls"] == {"segscan": 0, "onehot_fwd": 8, "onehot_bwd": 0}


def test_model_two_ranks_match_one(port_w2):
    """The port at W = 2 against the port at W = 1 (this process) from the
    same carried state."""
    m1 = tflagship.build_tiny_dlrm(ResourceManager.create(device="cpu"), **MODEL_KW)
    load_jax_state(m1, port_w2["state"], num_shards=2)
    losses = [m1.train() for _ in range(3)]
    ev = m1.eval()
    res = port_w2["model"][0]
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
    assert abs(res["eval"]["auc"] - ev["auc"]) <= 1e-6
    for i in range(26):
        np.testing.assert_allclose(res["tables"][str(i)], m1.ec.export_table(m1.tables, str(i)), **TOL,
                                   err_msg=f"table {i}")
    for layer, ps in m1.network.param_tree().items():
        for k, p in ps.items():
            np.testing.assert_allclose(res["dense"][f"{layer}.{k}"], p.detach().numpy(), **TOL)
