"""The exchanges of model-parallel groups over W ranks against the JAX
package on a W-device CPU mesh, each package at its default forward (the
owner-partitioned one) unless a case sets another: the port's ranks are one
spawned gloo group per W (`tools/hybrid.py::run`, the cases of
`tests/torch_rank_fns.py::CASES`), JAX runs in this process. Each rank
reads its block of the global batch; two steps each.

* The partitioned forward: bf16 tables and state with Sum, Mean and Concat
  lookups at W = 2 and 4, a bf16 partial placement at W = 4 (a table on 2
  shards with 2 replicas each, one on 1 shard), a bf16 dynamic group at
  W = 2, the bf16 base case at W = 4 with and without its one-hot group.
  Forward outputs bitwise at W = 2: both packages pool each slot's
  owned rows in ascending row order with a rounding after every add, and
  a + b commutes in the reduce over 2 ranks. At W = 4 gloo's reduce-scatter
  and JAX's `psum_scatter` add the four bf16 partial pools in other orders,
  rounding after each add: 53 of 384 outputs of one lookup differed, by
  one ulp of the output or, where the partials cancel, of the partials
  (2^-9 at 0.36, and at 0.018); held at rtol 2^-7 with atol 2^-8, one ulp
  of partial pools below 1. Tables and state within one bf16 ulp at the
  tables' scale (rtol 2^-7, atol 2^-7 x 0.1; state atol 1e-7), as
  tests/test_torch_hybrid_configs.py holds bf16 updates. JAX sums the
  sorted route's segments in float32 here (HCTR_TPU_SEGSUM=xla), as the
  port does (`torch_rank_fns._bf16`).
* The one-hot group's bf16 update at W = 4 (`w4_bf16_onehot`). Its
  gradient is all-reduced in bf16; gloo's all_reduce rounds after every
  add, in an order of its own, where JAX's psum on the CPU mesh rounds the
  four ranks' sum once (`test_bf16_sum_over_four_ranks_rounds_after_each_add`
  shows both on 1 + 3 x 2^-9). The same case in float32 agrees within
  1.2e-7 on every group, and every other group of the bf16 case is
  bitwise, so the gap is that rounding. Its weights (up to 1.4 in size)
  differed by at most 2^-8 on six seeds and 2^-7 on one (of seeds 47 and
  100-105; up to 52 of 1,256 stored weights), one bf16 ulp of the weights'
  scale even where a weight nears zero: held at atol 2^-7 with rtol 2^-7.
* The capacity factor (`Solver.mp_capacity_factor`, JAX's
  HCTR_TPU_MP_CAPACITY_FACTOR) on the table of JAX's
  test_mp_capacity_slicing_matches_uncapped, AdaGrad: a factor that drops
  nothing (uniform keys at W = 2), equal to no factor bit for bit; even
  keys that overflow the loaded shard's list, on the sorted route and on
  the dense sweep; and at W = 4 the table on 2 shards, where the forward
  cuts at n = 4 ranks and the backward at f = 2 shards. float32 forward
  outputs rtol 1e-6 (atol 1e-7), tables and state rtol 1e-4 / atol 1e-5
  (the update sums in another order).
* The unique-key dense exchange (`Solver.dense_exchange_cap`, JAX's
  HCTR_TPU_DENSE_EXCHANGE_CAP) on tests/test_dense_exchange.py's concat
  tables, SGD and AdaGrad, lists of 64 rows (the compressed branch over
  `all_to_all`, counted) and of 2 (every list overflows: the masked forward
  and the full update, no `all_to_all`): step 1's outputs bitwise (each
  output is one row), updates as above. Its gate refuses a frozen table.
Step 2's outputs read the updated tables and are held at the update's
tolerance.
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
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Combiner_t, Optimizer_t
from hugectr_tpu_torch.embedding.collection import EmbeddingCollection
from hugectr_tpu_torch.optim.params import OptParams
from hugectr_tpu_torch.parallel import plan as tplan
from hugectr_tpu_torch.tools import hybrid

torch.set_num_threads(1)
B, LR, STEPS = 48, 0.3, 2
F32_FWD_TOL = dict(rtol=1e-6, atol=1e-7)
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_ULP = 2.0**-7
BF16_TOL = dict(rtol=BF16_ULP, atol=BF16_ULP * 0.1)
# one ulp of the output, or of the partial pools (below 1 here) where they cancel
BF16_W4_FWD_TOL = dict(rtol=BF16_ULP, atol=2.0**-8)
# the one-hot group's weights after a bf16 gradient sum over 4 ranks that
# rounds otherwise than JAX's: one ulp of the weights' scale (up to 1.4)
BF16_SUM_ORDER_TOL = dict(rtol=BF16_ULP, atol=BF16_ULP)
# the JAX package's variables of the exchanges, cleared before a case sets its own
EXCHANGE_ENV = ("HCTR_TPU_FWD_PARTITION", "HCTR_TPU_MP_CAPACITY_FACTOR", "HCTR_TPU_DENSE_EXCHANGE",
                "HCTR_TPU_DENSE_EXCHANGE_CAP", "HCTR_TPU_EMB_STATE_DTYPE")

# name: (world, optimizer, case of torch_rank_fns.CASES)
EC_CASES = {
    "w2_bf16_base": (2, "rowwise_adagrad", "bf16_base"),
    "w2_bf16_dynamic": (2, "rowwise_adagrad", "bf16_dynamic"),
    "w2_cap": (2, "adagrad", "cap"),
    "w2_cap_skew": (2, "adagrad", "cap_skew"),
    "w2_cap_skew_dense": (2, "adagrad", "cap_skew_dense"),
    "w2_dx64_sgd": (2, "sgd", "dx64"),
    "w2_dx64_adagrad": (2, "adagrad", "dx64"),
    "w2_dx2_sgd": (2, "sgd", "dx2"),
    "w2_dx2_adagrad": (2, "adagrad", "dx2"),
    "w4_bf16_base": (4, "rowwise_adagrad", "bf16_base_mp"),
    "w4_bf16_onehot": (4, "rowwise_adagrad", "bf16_base"),
    "w4_bf16_partial": (4, "rowwise_adagrad", "bf16_partial"),
    "w4_cap_partial_skew": (4, "adagrad", "cap_partial_skew"),
    "w4_dx64_adagrad": (4, "adagrad", "dx64"),
    "w4_dx2_adagrad": (4, "adagrad", "dx2"),
}
# run by the port only: the capacity cases without a factor
PORT_ONLY = {"w2_cap_none": (2, "adagrad", "cap_none"), "w2_cap_skew_none": (2, "adagrad", "cap_skew_none")}


def _inputs(name):
    _w, optimizer, case = {**EC_CASES, **PORT_ONLY}[name]
    return fns.ec_inputs(optimizer, fns.CASES[case].get("batch", B), STEPS, LR, case)


def _jax_collection(name):
    """JAX's collection of a case on its mesh, the same two steps: the
    outputs of each step, the static tables in key order, the global storage
    and state (float32 arrays), the JAX plan."""
    world, optimizer, case = EC_CASES[name]
    c = fns.CASES[case]
    inputs = _inputs(name)
    with pytest.MonkeyPatch.context() as mp:
        for k in EXCHANGE_ENV:
            mp.delenv(k, raising=False)
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
        dense_ex = [g.name for g in pl.groups if jec._dense_exchange_ok(g)]
    host = lambda a: np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a)  # noqa: E731
    return dict(outs=outs, tables=tables, store={k: host(v) for k, v in jt.items()},
                state={g: {k: host(v) for k, v in st.items()} for g, st in js.items()}, plan=pl, dense_ex=dense_ex)


# [ranks, 4]: column c holds 1.0 on rank c and 2^-9 on the other ranks
SUM_ORDERS = np.where(np.eye(4, dtype=bool), 1.0, 2.0**-9).astype(np.float32)


def _port(world):
    names = [n for n, (w, *_r) in {**EC_CASES, **PORT_ONLY}.items() if w == world]
    inputs = {"ec": {n: _inputs(n) for n in names}, "sum": {"x": SUM_ORDERS},
              "calls": json.dumps({"ec": "collection_cases", "sum": "bf16_sum"})}
    return hybrid.run(fns.several, world, inputs, device="cpu")


@pytest.fixture(scope="module")
def port_w2():
    return _port(2)


@pytest.fixture(scope="module")
def port_w4():
    return _port(4)


@pytest.fixture(scope="module")
def jax_ec():
    """JAX's results of each case, made once."""
    return {}


@pytest.fixture
def ec_case(request, port_w2, port_w4, jax_ec):
    """(name, the ranks' results, JAX's results) of one case."""
    name = request.param
    world = EC_CASES[name][0]
    if name not in jax_ec:
        jax_ec[name] = _jax_collection(name)
    return name, [r["ec"][name] for r in (port_w4 if world == 4 else port_w2)], jax_ec[name]


def _key_rows(g, rank: int) -> np.ndarray:
    """The rows of a static model-parallel group's storage on `rank` that
    hold a key (the others are padding, drawn by each package's own
    generator)."""
    f = g.num_shards
    rows = []
    for ti in range(len(g.tables)):
        keys = np.arange(int(g.table_vocab[ti]))
        mine = (keys + int(g.table_rotation[ti]) % f) % f == rank % f
        rows.append(int(g.local_offsets[ti]) + keys[mine] // f)
    return np.concatenate(rows)


def _bf16(name):
    return fns.CASES[EC_CASES[name][2]]["dtype"] == "bfloat16"


@pytest.mark.parametrize("ec_case", list(EC_CASES), indirect=True)
def test_forward_matches_jax_default(ec_case):
    """Step 1's outputs of every rank's block against JAX's from the same
    tables: bitwise for bf16 at W = 2 and for the dense exchange; bf16 at
    W = 4 within one ulp of the output; float32 rtol 1e-6. Step 2 reads
    the tables after an update, at the update's tolerance (the one-hot
    group's of `w4_bf16_onehot`: its weights')."""
    name, ranks, want = ec_case
    world = len(ranks)
    if name.startswith(("w2_dx", "w4_dx")) or (_bf16(name) and world == 2):
        tol = None
    else:
        tol = BF16_W4_FWD_TOL if _bf16(name) else F32_FWD_TOL
    n = fns.CASES[EC_CASES[name][2]].get("batch", B) // world
    # step 2's outputs of the one-hot group read its weights of above
    onehot = {lm.top_name for g in want["plan"].groups if g.compute_kind == "onehot" for lm in g.lookups}
    for step, outs in want["outs"].items():
        if step != "1":
            tol = BF16_TOL if _bf16(name) else TOL
        for r, res in enumerate(ranks):
            for top, w in outs.items():
                got, exp = res["fwd"][step][top], w[r * n : (r + 1) * n]
                msg = f"{name} step {step} rank {r} {top}"
                if tol is None:
                    np.testing.assert_array_equal(got, exp, err_msg=msg)
                elif step != "1" and name == "w4_bf16_onehot" and top in onehot:
                    np.testing.assert_allclose(got, exp, **BF16_SUM_ORDER_TOL, err_msg=msg)
                else:
                    np.testing.assert_allclose(got, exp, **tol, err_msg=msg)


@pytest.mark.parametrize("ec_case", list(EC_CASES), indirect=True)
def test_update_matches_jax_default(ec_case):
    """Static tables in key order on every rank, and each rank's storage,
    key store (bitwise) and state against its block of JAX's global arrays;
    every replica of a shard bitwise equal; JAX's dense-exchange gate opens
    on the "dx" cases only (the port's: `all_to_all` counted below)."""
    name, ranks, want = ec_case
    tol = BF16_TOL if _bf16(name) else TOL
    onehot = {t.name for g in want["plan"].groups if g.compute_kind == "onehot" for t in g.tables}
    sum_order = name == "w4_bf16_onehot"
    for r, res in enumerate(ranks):
        for t, w in want["tables"].items():
            t_tol = BF16_SUM_ORDER_TOL if sum_order and t in onehot else tol
            np.testing.assert_allclose(res["tables"][t], w, **t_tol, err_msg=f"{name} rank {r} table {t}")
        for g in want["plan"].groups:
            tol = BF16_SUM_ORDER_TOL if sum_order and g.compute_kind == "onehot" else BF16_TOL if _bf16(name) else TOL
            n = res["storage"][g.name].shape[0]
            sl = slice(r * n, (r + 1) * n) if g.is_model_parallel else slice(None)
            got, exp = res["storage"][g.name], want["store"][g.name][sl]
            if g.slot_is_dynamic.any():
                np.testing.assert_array_equal(res["storage"][f"{g.name}#keys"], want["store"][f"{g.name}#keys"][sl])
            elif g.is_model_parallel:
                got, exp = got[_key_rows(g, r)], exp[_key_rows(g, r)]
            np.testing.assert_allclose(got, exp, **tol, err_msg=f"{name} rank {r} storage {g.name}")
            for k, v in res.get("state", {}).get(g.name, {}).items():  # SGD keeps none
                st_tol = dict(tol, atol=1e-7) if tol in (BF16_TOL, BF16_SUM_ORDER_TOL) else tol
                np.testing.assert_allclose(v, want["state"][g.name][k][sl], **st_tol,
                                           err_msg=f"{name} rank {r} state {g.name}/{k}")
    world = len(ranks)
    for g in want["plan"].groups:
        f = g.num_shards if g.is_model_parallel else 1
        for r in range(f, world):
            np.testing.assert_array_equal(ranks[r]["storage"][g.name], ranks[r % f]["storage"][g.name])
    assert bool(want["dense_ex"]) == name.startswith(("w2_dx", "w4_dx"))


def test_capacity_factor_drops_only_what_overflows(port_w2):
    """A factor whose cut holds every owned key gives the uncapped results
    bit for bit; on the skewed batch the cut drops keys, so the results
    differ from the uncapped ones (and equal JAX's, above)."""
    for res in (r["ec"] for r in port_w2):
        for part in ("fwd", "tables", "storage"):
            a, b = res["w2_cap"][part], res["w2_cap_none"][part]
            for k in a:
                if part == "fwd":
                    for top in a[k]:
                        np.testing.assert_array_equal(a[k][top], b[k][top])
                else:
                    np.testing.assert_array_equal(a[k], b[k])
        assert not np.array_equal(res["w2_cap_skew"]["fwd"]["1"]["e0"], res["w2_cap_skew_none"]["fwd"]["1"]["e0"])
        assert not np.array_equal(res["w2_cap_skew"]["tables"]["big"], res["w2_cap_skew_none"]["tables"]["big"])
        assert res["w2_cap_skew"]["routes"] == {"mp_ev8": "sorted"}
        assert res["w2_cap_skew_dense"]["routes"] == {"mp_ev8": "dense"}


def test_dense_exchange_branches_and_counts(port_w2, port_w4):
    """Lists of 64 rows take the compressed branch: one all_to_all in each
    forward and backward, the rows in the table's type and the gradient sums
    in float32, W x 64 rows a rank and call; lists of 2 overflow on every
    step: no all_to_all, the overflow flag's all_reduce in each pass."""
    for ranks, world in ((port_w2, 2), (port_w4, 4)):
        for res in (r["ec"] for r in ranks):
            for name in (f"w{world}_dx64_adagrad", f"w{world}_dx2_adagrad"):
                calls, nbytes = res[name]["collective_calls"], res[name]["collective_bytes"]
                if "dx64" in name:
                    assert calls["all_to_all"] == 2 * STEPS
                    assert nbytes["all_to_all"] == 2 * STEPS * world * 64 * 8 * 4
                else:
                    assert "all_to_all" not in calls
                assert calls["all_reduce"] >= 2 * STEPS


def test_dense_exchange_gate_refuses_a_frozen_table():
    """The gate opens for the all-Concat group at full placement with a cap,
    and closes for a frozen table, a cap of 0 (the setting off) or one rank
    (`_dense_exchange_ok`, collection.py:953-983)."""
    c = fns.CASES["dx64"]
    plan = tplan.compile_plan(fns.ec_lookups(tplan, Combiner_t, "dx64"), tplan.ShardingPlan(c["strategy"]), 2,
                              onehot_vocab=0, split_vocab=0)
    rm = ResourceManager(torch.device("cpu"), rank=0, world_size=2)
    (g,) = plan.groups

    def ec(**kw):
        return EmbeddingCollection(plan, rm, OptParams(Optimizer_t.SGD), **dict(dict(dense_exchange_cap=64), **kw))

    assert ec()._dense_exchange_ok(g)
    frozen = ec()
    frozen.frozen_tables.add("t1")
    assert not frozen._dense_exchange_ok(g)
    assert not ec(dense_exchange_cap=0)._dense_exchange_ok(g)
    one = EmbeddingCollection(plan, ResourceManager(torch.device("cpu")), OptParams(Optimizer_t.SGD),
                              dense_exchange_cap=64)
    assert not one._dense_exchange_ok(g)


def test_bf16_sum_over_four_ranks_rounds_after_each_add(port_w4):
    """1.0 on one rank and 2^-9 on the three others: JAX's psum on the CPU
    mesh rounds the sum once (1 + 3 x 2^-9 -> 1.0078125) wherever the 1.0
    is; the port's all_reduce over gloo rounds after every add, so where it
    adds the 1.0 before two of the 2^-9 it gives 1.0: equal on every rank,
    each column one of the sums taken in some order with a rounding after
    each add."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:4]), ("d",))
    psum = shard_map(lambda v: jax.lax.psum(v, "d"), mesh=mesh, in_specs=P("d"), out_specs=P())
    jax_sum = np.asarray(jax.jit(psum)(jnp.asarray(SUM_ORDERS, jnp.bfloat16)).astype(jnp.float32))
    np.testing.assert_array_equal(jax_sum, np.full((1, 4), 1.0078125, np.float32))
    got = [r["sum"]["y"] for r in port_w4]
    for y in got[1:]:
        np.testing.assert_array_equal(y, got[0])
    assert set(got[0].tolist()) <= {1.0, 1.0078125} and 1.0 in got[0].tolist()
