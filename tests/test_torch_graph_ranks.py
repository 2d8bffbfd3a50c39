"""The hybrid-parallel step as one program on each rank, on the CPU.

On W NCCL ranks each rank captures its train step and eval forward,
collectives inside (`Model._replay`), as the JAX package jits its shard_map
step. What such a capture runs must read nothing on the host and size
nothing by the data: here the ranks run over gloo at W 2 and W 4 with the
model's step body and eval forward (`Model._train_body`,
`Model._eval_step`) and the collection's passes (`forward`,
`backward_and_update`) under `torch_rank_fns._Refuse`, the dispatch mode of
tests/test_torch_graph_step.py (no `.item()`, nonzero, masked_select,
unique or boolean index; `torch_rank_fns.refused_ranks`). Each case is held
against the JAX package on its W-device CPU mesh by the checks of the test
it comes from, at that test's tolerances:

* the tiny f32 flagship at W 2 (tests/test_torch_hybrid.py: losses rtol
  1e-4, AUC within 1e-6, tables and dense parameters rtol 1e-4 / atol
  1e-5), the tiny dynamic DLRM-FTRL at W 2
  (tests/test_torch_hybrid_models.py), a column split (factor 4, the
  sorted route) at W 2 (tests/test_torch_meshes.py: losses rtol 1e-5,
  sub-tables rtol 1e-5 / atol 1e-6); the tiny bench-configured model in
  tests/test_torch_graph_ranks_bench.py;
* the collection with the capacity factor (at W 2 a cut that drops keys;
  at W 4 the table on 2 shards), the
  unique-key dense exchange with lists that fit (64 rows) and lists that
  overflow (2 rows), at W 2 and W 4 (tests/test_torch_exchange.py), and
  on the (dcn, ici) (2, 2) mesh with Hierarchical communication and the
  ("data", "ev") (2, 2) mesh (tests/test_torch_meshes.py).

The port's ranks are two spawned gloo groups (one of 2, one of 4), each
started from a thread while JAX runs in this process. Beside them:
`_graph_refusal` on a device faked as CUDA (the refusal reads the device's
type and the group's backend, nothing of the card): NCCL ranks capture,
gloo ranks refuse by name; and a replay adds the collectives' calls and
bytes its capture made (`replay_counts`, the CUDA graph stood in for on
the CPU).
"""
import concurrent.futures
import json

import jax
import pytest
import torch

import test_torch_exchange as tx
import test_torch_hybrid as th
import test_torch_hybrid_models as thm
import test_torch_meshes as tmesh
import torch_rank_fns as fns
from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.tools import flagship as jflagship
from hugectr_tpu_torch.core import mesh
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.tools import flagship as tflagship
from hugectr_tpu_torch.tools import hybrid

torch.set_num_threads(1)
# the collection's cases of tests/test_torch_exchange.py and of
# tests/test_torch_meshes.py run here, by world
EXCHANGE = {2: ("w2_cap_skew", "w2_dx64_adagrad", "w2_dx2_adagrad"),
            4: ("w4_cap_partial_skew", "w4_dx64_adagrad", "w4_dx2_adagrad")}
MESHES = ("hier_f32", "ev_f32")


def _tiny_jax():
    """tests/test_torch_hybrid.py's tiny JAX model on 2 devices and its
    carried state."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in th.MODEL_ENV.items():
            mp.setenv(k, v)
        mp.delenv("HCTR_TPU_EMB_DTYPE", raising=False)
        jm = jflagship.build_tiny_dlrm(JaxResourceManager.create(num_devices=2), batchsize=64)
    st = jax.device_get(jm.state)
    return jm, {k: st[k] for k in ("emb_tables", "eopt", "dense_params", "dopt", "step")}


@pytest.fixture(scope="module")
def runs():
    """The ranks' runs, each spawned group in a thread of its own while the
    JAX package computes in this one: a gloo group of 4 (the exchange's and
    the meshes' collection cases) at once; then, from the JAX models'
    states (the tiny flagship, the column run at factor 4, the dynamic
    DLRM-FTRL of tests/test_torch_hybrid_models.py, each on 2 CPU devices),
    a group of 2 (its collection cases, the three models and
    `replay_counts`). Futures of each group's results, and the JAX side."""
    pool = concurrent.futures.ThreadPoolExecutor(2)
    ec4 = {**{n: tx._inputs(n) for n in EXCHANGE[4]}, **{n: tmesh._ec_inputs(n) for n in MESHES}}
    w4 = pool.submit(hybrid.run, fns.refused_ranks, 4, {"ec": ec4, "calls": json.dumps({"ec": "collection_cases"})},
                     device="cpu")
    jm, state = _tiny_jax()
    factor, engine, env = tmesh.COLUMN_RUNS["col4"]
    with pytest.MonkeyPatch.context() as mp:
        column = tmesh._jax_column(2, factor, env, mp)
    jf = thm._jax_ftrl_model()
    ftrl = dict(builder="build_tiny_dlrm_ftrl", kwargs=dict(dynamic=True), steps=3, eval=True, storage=True,
                export=False)
    tiny = dict(builder="build_tiny_dlrm", kwargs=th.MODEL_KW, steps=3, eval=True)
    inputs = {
        "ec": {n: tx._inputs(n) for n in EXCHANGE[2]},
        "model": {"config": json.dumps(tiny), "state": state},
        "ftrl": {"config": json.dumps(ftrl), "state": thm._state_tree(jf["state"])},
        "col4": {"config": tmesh._model_config(factor, engine=engine), "state": column[0]},
        "rc": {"unused": 0},
        "calls": json.dumps({"ec": "collection_cases", "rc": "replay_counts",
                             **{k: "train_model" for k in ("model", "ftrl", "col4")}}),
    }
    w2 = pool.submit(hybrid.run, fns.refused_ranks, 2, inputs, device="cpu")
    yield {"w2": w2, "w4": w4, "tiny": jm, "column": {"col4": column}, "ftrl": jf}
    pool.shutdown()


@pytest.mark.parametrize("name", MESHES)
def test_mesh_cases_under_refuse_match_jax(name, runs):
    """The hierarchical and ("data", "ev") meshes at W 4 without a host
    read: tests/test_torch_meshes.py's check."""
    want = tmesh._jax_collection(name)
    tmesh.test_mesh_collection_matches_jax((name, [r["ec"][name] for r in runs["w4"].result()], want))


@pytest.mark.parametrize("name", [*EXCHANGE[4], *EXCHANGE[2]])
def test_exchange_cases_under_refuse_match_jax(name, runs):
    """The capacity factor and the dense exchange's two branches, without a
    host read: tests/test_torch_exchange.py's forward and update checks."""
    want = tx._jax_collection(name)
    ranks = [r["ec"][name] for r in runs["w4" if name.startswith("w4") else "w2"].result()]
    case = (name, ranks, want)
    tx.test_forward_matches_jax_default(case)
    tx.test_update_matches_jax_default(case)


def test_the_step_bodies_ran_under_the_refusing_mode(runs):
    """Every rank ran the step body, the eval forward and the collection's
    passes under `_Refuse`, and nothing in them raised."""
    for res in runs["w2"].result():
        assert res["refused"]["_train_body"] >= 3 and res["refused"]["_eval_step"] >= 1
    for res in (*runs["w2"].result(), *runs["w4"].result()):
        assert res["refused"]["forward"] > 0 and res["refused"]["backward_and_update"] > 0


def test_tiny_model_under_refuse_matches_jax(runs, monkeypatch):
    """tests/test_torch_hybrid.py's check of the tiny f32 flagship at W 2."""
    th.test_model_matches_jax_on_two_devices(
        {"jax_model": runs["tiny"], "model": [r["model"] for r in runs["w2"].result()]}, monkeypatch)


def test_dynamic_ftrl_model_under_refuse_matches_jax(runs):
    """tests/test_torch_hybrid_models.py's check of the tiny dynamic
    DLRM-FTRL at W 2."""
    thm.test_dynamic_ftrl_model_on_two_ranks_matches_jax({"ftrl": [r["ftrl"] for r in runs["w2"].result()]},
                                                         {"ftrl": runs["ftrl"]})


def test_column_split_under_refuse_matches_jax(runs):
    """tests/test_torch_meshes.py's check of the column split (factor 4)
    at W 2."""
    tmesh.test_column_split_over_two_ranks_matches_jax((runs["column"], runs["w2"].result()), "col4")


def test_a_replay_adds_the_collectives_of_its_capture(runs):
    """The capture's collectives are counted once for each replay, the
    first (which captures) included: each replay adds the eager step's
    calls and bytes, so a step's counts read the same captured or not."""
    for res in runs["w2"].result():
        rc = res["rc"]
        eager = rc["eager"]
        assert eager["calls"] and rc["captures"] == 1
        assert rc["capture"] == eager
        assert rc["replays"]["calls"] == {k: 3 * v for k, v in eager["calls"].items()}
        assert rc["replays"]["bytes"] == {k: 3 * v for k, v in eager["bytes"].items()}


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_graph_refusal_over_ranks_on_a_faked_card(backend, monkeypatch):
    """On a CUDA device (faked: the refusal reads the device's type) at W 2
    the step and the eval forward capture over NCCL; over gloo, whose
    collectives go through the host, both refuse by name. The other
    refusals stay: `use_cuda_graph=False` first."""
    tm = tflagship.build_tiny_dlrm(ResourceManager.create(device="cpu"), **th.MODEL_KW)
    monkeypatch.setattr(tm, "device", torch.device("cuda"))
    monkeypatch.setattr(tm.rm, "world_size", 2)
    monkeypatch.setattr(mesh, "backend", lambda: backend)
    if backend == "nccl":
        assert tm.step_mode == "graph" and tm._graph_refusal(train=False) is None
    else:
        assert tm.step_mode == "eager: the gloo backend"
        assert tm._graph_refusal(train=False) == "the gloo backend"
    tm.solver.use_cuda_graph = False
    assert tm.step_mode == "eager: use_cuda_graph=False"


@pytest.mark.parametrize("takes, picked", [
    # the replayed GMF eval on the card: records gained in the 2nd and 4th
    # traces; the 1st and 3rd agree, so the 3rd is kept
    ([(35.333, 0.06069), (40.0, 0.04112), (35.333, 0.06044), (41.0, 0.06930)], 2),
    # records lost in one trace (busy 6.86 against 14.4-14.5): the next two agree
    ([(3393.0, 14.46), (2100.0, 6.86), (3393.0, 14.45)], 2),
    # no two of the takes agree: no trace is kept
    ([(100.0 + 10 * i, 1.0 + i) for i in range(6)], None),
])
def test_whole_trace_keeps_a_trace_an_earlier_one_confirms(takes, picked):
    """`graph_ab.whole_trace` keeps the first trace that an earlier one
    agrees with (events and busy ms within TRACE_AGREE), in a row or not,
    and gives None after TRACE_TAKES traces of which no two agree."""
    from hugectr_tpu_torch.tools import graph_ab

    it = iter(enumerate(takes))

    def take():
        i, (events, busy) = next(it)
        return {"device_events_per_step": events, "compute_busy_ms_per_step": busy, "i": i}

    r, seen = graph_ab.whole_trace(take)
    if picked is None:
        assert r is None and len(seen) == graph_ab.TRACE_TAKES == len(takes)
    else:
        assert r["i"] == picked and seen == takes[:picked + 1]
