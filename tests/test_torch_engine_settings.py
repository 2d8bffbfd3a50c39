"""The two engine settings of the JAX package that change the plan or the
numbers, as `Solver` fields of the port, against the JAX package with its
variables set: `onehot_scatter_ratio` / `onehot_scatter_maxv`
(HCTR_TPU_ONEHOT_SCATTER_RATIO / _MAXV, hugectr_tpu/parallel/plan.py:499-560)
and `dense_grad_dtype` (HCTR_TPU_DENSE_GRAD_DTYPE,
hugectr_tpu/embedding/sparse_optimizer.py:206-218, :471-489).

Tolerances: plan fields exact. The bf16 gradient buffer bitwise: on the CPU
the port adds in the JAX package's order and rounds after every add, as
XLA's sorted scatter does. Tables and optimizer state after an update rtol
1e-4 / atol 1e-5 (float32 arithmetic in another order); bf16 tables one
bf16 ulp. The tiny model with the bf16 buffer: tables atol 2 lr x 2^-7
(a cotangent a float32 ulp apart can round to the other bf16 neighbour).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.core.types import Combiner_t as JComb
from hugectr_tpu.core.types import Optimizer_t as JOpt
from hugectr_tpu.embedding import sparse_optimizer as jso
from hugectr_tpu.embedding.collection import EmbeddingCollection as JEC
from hugectr_tpu.optim.params import OptParams as JOptParams
from hugectr_tpu.parallel import plan as jplan
from hugectr_tpu.tools import flagship as jflagship
from hugectr_tpu.tools.flagship import MLPERF_MULTI_HOT_SIZES, MLPERF_TABLE_SIZES

import hugectr_tpu_torch as th
from hugectr_tpu_torch import ops
from hugectr_tpu_torch.core.config import PORT_SOLVER_SETTINGS
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Combiner_t as TComb
from hugectr_tpu_torch.core.types import Optimizer_t as TOpt
from hugectr_tpu_torch.embedding import sparse_optimizer as tso
from hugectr_tpu_torch.embedding.collection import EmbeddingCollection as TEC
from hugectr_tpu_torch.optim.params import OptParams as TOptParams
from hugectr_tpu_torch.parallel import plan as tplan
from hugectr_tpu_torch.tools import flagship as tflagship
from hugectr_tpu_torch.tools.carry import load_jax_state

torch.set_num_threads(1)
CPU = ResourceManager.create(device="cpu")
F32_TOL = dict(rtol=1e-4, atol=1e-5)


def _env(monkeypatch, **kv):
    for k, v in kv.items():
        monkeypatch.setenv(k, str(v))


def _flagship_lookups(pkg, comb, cap):
    return [
        pkg.LookupConfig(i, pkg.EmbeddingTableConfig(str(i), min(v, cap), 128), f"data{i}", f"sparse_embedding:{i}",
                         comb.Sum, MLPERF_MULTI_HOT_SIZES[i])
        for i, v in enumerate(MLPERF_TABLE_SIZES)
    ]


# bench.py's split with the ratio of the JAX docstring's measurement
# (plan.py:503-507): table 20's hot tier (130,048 rows, h 100) and table 14
# (11,938 rows, h 9) join the one-hot group; a maxv below the hot tier
# keeps it on its rowop group
PLAN_CASES = {
    "bench_ratio2000": dict(cap=2_000_000, onehot=8192, split=16384, hot=131072, shot=1024, ratio=2000,
                            maxv=131072),
    "bench_ratio2000_maxv65536": dict(cap=2_000_000, onehot=8192, split=16384, hot=131072, shot=1024, ratio=2000,
                                      maxv=65536),
    "unsplit_ratio30": dict(cap=20000, onehot=64, split=0, hot=0, shot=0, ratio=30, maxv=131072),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_scatter_ratio_plan_matches_jax(monkeypatch, case):
    c = PLAN_CASES[case]
    _env(monkeypatch, HCTR_TPU_ONEHOT_VOCAB=c["onehot"], HCTR_TPU_SPLIT_VOCAB=c["split"],
         HCTR_TPU_HOT_ROWS=c["hot"], HCTR_TPU_SUPERHOT_ROWS=c["shot"], HCTR_TPU_WARM_ROWS=0,
         HCTR_TPU_ONEHOT_SCATTER_RATIO=c["ratio"], HCTR_TPU_ONEHOT_SCATTER_MAXV=c["maxv"])
    names = [str(i) for i in range(26)]
    counts = {n: 1 for n in names}
    jp = jplan.compile_plan(_flagship_lookups(jplan, JComb, c["cap"]), jplan.ShardingPlan([("mp", names)]), 1,
                            counts)
    kw = dict(onehot_vocab=c["onehot"], split_vocab=c["split"], hot_rows=c["hot"], superhot_rows=c["shot"],
              onehot_scatter_ratio=c["ratio"], onehot_scatter_maxv=c["maxv"])
    tp = tplan.compile_plan(_flagship_lookups(tplan, TComb, c["cap"]), tplan.ShardingPlan([("mp", names)]), 1,
                            counts, **kw)
    assert [g.name for g in tp.groups] == [g.name for g in jp.groups]
    for jg, tg in zip(jp.groups, tp.groups):
        assert (tg.compute_kind, tg.placement.value) == (jg.compute_kind, jg.placement.value)
        assert [(t.name, t.vocabulary_size) for t in tg.tables] == [(t.name, t.vocabulary_size) for t in jg.tables]
        for f in ("total_local_rows", "hotness_total", "out_width"):
            assert getattr(tg, f) == getattr(jg, f), f
        for f in ("table_vocab", "local_offsets", "slot_table", "slot_vocab"):
            np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f), err_msg=f)
        assert [(lm.top_name, lm.key_lo, lm.key_hi) for lm in tg.lookups] == [
            (lm.top_name, lm.key_lo, lm.key_hi) for lm in jg.lookups]
    assert tp.table_splits == jp.table_splits
    onehot = {t.name for g in tp.groups if g.compute_kind == "onehot" for t in g.tables}
    if case == "bench_ratio2000":
        assert {"20::hot", "14"} <= onehot and max(t.vocabulary_size for g in tp.groups
                                                    if g.compute_kind == "onehot" for t in g.tables) == 130048
    elif case == "bench_ratio2000_maxv65536":
        assert "20::hot" not in onehot and "14" in onehot
    # the plan's options rebuild the same plan, as the collection's recompile does
    opts = dict(tp.options)
    assert opts["onehot_scatter_ratio"] == c["ratio"] and opts["onehot_scatter_maxv"] == c["maxv"]
    opts.pop("column_factors")
    again = tplan.compile_plan(_flagship_lookups(tplan, TComb, c["cap"]), tplan.ShardingPlan([("mp", names)]), 1,
                               counts, **opts)
    assert [(g.name, g.compute_kind) for g in again.groups] == [(g.name, g.compute_kind) for g in tp.groups]


def _ratio_lookups(pkg, comb):
    """A 3,000-row table read by two lookups of hotness 20 (total 40: 40 x
    100 >= 3,000 takes the one-hot engine at ratio 100) and a 60-row one."""
    big = pkg.EmbeddingTableConfig("big", 3000, 8)
    small = pkg.EmbeddingTableConfig("small", 60, 8)
    return [pkg.LookupConfig(0, big, "f0", "e0", comb.Sum, 20), pkg.LookupConfig(1, small, "f1", "e1", comb.Sum, 3),
            pkg.LookupConfig(2, big, "f2", "e2", comb.Mean, 20)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_ratio_step_matches_jax(monkeypatch, dtype):
    """One forward and update of the collection with the 3,000-row table on
    the one-hot engine by the ratio: outputs, table and state."""
    _env(monkeypatch, HCTR_TPU_ONEHOT_VOCAB=128, HCTR_TPU_ONEHOT_SCATTER_RATIO=100, HCTR_TPU_HOT_ROWS=0,
         HCTR_TPU_EMB_STATE_DTYPE=dtype)
    rng = np.random.default_rng(5)
    b = 32
    feats = {"f0": rng.integers(-1, 3000, (b, 20)).astype(np.int32), "f1": rng.integers(-1, 60, (b, 3)).astype(
        np.int32), "f2": rng.integers(0, 40, (b, 20)).astype(np.int32)}
    values = {"big": (rng.normal(size=(3000, 8)) * 0.1).astype(np.float32),
              "small": (rng.normal(size=(60, 8)) * 0.1).astype(np.float32)}
    d_outs = {f"e{i}": rng.normal(size=(b, 8)).astype(np.float32) for i in range(3)}
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    mesh1 = JaxResourceManager.create(num_devices=1)
    jpl = jplan.compile_plan(_ratio_lookups(jplan, JComb), jplan.ShardingPlan([]), 1)
    jec = JEC(jpl, mesh1, JOptParams(JOpt.RowWiseAdaGrad, initial_accu_value=0.0), dtype=jdt)
    jt = jec.init(jax.random.key(0))
    for n, v in values.items():
        jt = jec.import_table(jt, n, v)
    js = jec.init_optimizer(jt)
    jout = jax.jit(jec.forward)(jt, feats)
    jt, js = jax.jit(jec.backward_and_update)(jt, js, feats, {k: jnp.asarray(v, jdt) for k, v in d_outs.items()},
                                              jnp.asarray(0.3), jnp.asarray(1))
    tpl = tplan.compile_plan(_ratio_lookups(tplan, TComb), tplan.ShardingPlan([]), 1, onehot_vocab=128,
                             onehot_scatter_ratio=100)
    assert [(g.name, g.compute_kind) for g in tpl.groups] == [(g.name, g.compute_kind) for g in jpl.groups] == [
        ("onehot_ev8", "onehot")]
    tec = TEC(tpl, CPU, TOptParams(TOpt.RowWiseAdaGrad, initial_accu_value=0.0), dtype=tdt, state_dtype=tdt)
    tt = tec.init(CPU.generator(0))
    for n, v in values.items():
        tt = tec.import_table(tt, n, v)
    ts = tec.init_optimizer(tt)
    tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    ops.reset_counts()
    tout = tec.forward(tt, tfeats)
    tec.backward_and_update(tt, ts, tfeats, {k: torch.from_numpy(v).to(tdt) for k, v in d_outs.items()},
                            torch.tensor(0.3))
    assert ops.plain_counts()["onehot_fwd"] == 1 and ops.plain_counts()["onehot_bwd"] == 3  # one a lookup
    tol = F32_TOL if dtype == "float32" else dict(rtol=2.0**-7, atol=2.0**-7 * 0.1)
    for k in jout:
        np.testing.assert_allclose(tout[k].float().numpy(), np.asarray(jout[k].astype(jnp.float32)), **tol,
                                   err_msg=k)
    for n in values:
        np.testing.assert_allclose(tec.export_table(tt, n), np.asarray(jec.export_table(jt, n)).astype(np.float32),
                                   **tol, err_msg=n)


def _dense_inputs(rng, rows=64, k=3000, e=16):
    """Power-law rows with many duplicates (a few hundred on row 0), the
    sentinel `rows` for a tenth of the keys, gradients over four decades."""
    idx = np.minimum((rng.pareto(1.2, k) * 2).astype(np.int64), rows - 1)
    idx[rng.random(k) < 0.1] = rows
    src = rng.permutation(k)
    dsrc = (rng.normal(size=(k, e)) * 10.0 ** rng.uniform(-3, 1, (k, 1))).astype(np.float32)
    return idx, src, dsrc


def test_bf16_row_sums_bitwise_jax():
    """The bf16 buffer: JAX's stable sort by row, then `.at[sidx].add` into
    bfloat16 with indices_are_sorted (sparse_optimizer.py:477-489)."""
    rng = np.random.default_rng(11)
    idx, src, dsrc = _dense_inputs(rng)
    rows = 64
    sidx, ssrc = jax.lax.sort((jnp.asarray(idx), jnp.asarray(src)), num_keys=1)
    ext = jnp.asarray(dsrc).at[ssrc].get(mode="fill", fill_value=0).astype(jnp.bfloat16)
    want = jnp.zeros((rows, 16), jnp.bfloat16).at[sidx].add(ext, mode="drop", indices_are_sorted=True)
    valid = idx < rows
    got = tso.bf16_row_sums(torch.from_numpy(idx[valid]), torch.from_numpy(src[valid]), torch.from_numpy(dsrc), rows)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    f32 = np.zeros((rows, 16), np.float32)
    np.add.at(f32, idx[valid], dsrc[src[valid]])
    assert not np.array_equal(got.float().numpy(), f32)  # the buffer did round


def _opts(kind):
    kw = dict(lr=0.01, initial_accu_value=0.1) if kind != "adam" else dict(lr=0.01)
    return JOptParams(JOpt(kind), **kw), TOptParams(TOpt(kind), **kw)


@pytest.mark.parametrize("kind", ["adagrad", "rowwise_adagrad", "adam"])
def test_dense_grad_dtype_update_matches_jax(kind):
    """One dense-sweep update with the bf16 gradient buffer: AdaGrad and
    RowWiseAdaGrad take it, Adam keeps float32 and its touch count, as in
    the JAX package (sparse_optimizer.py:471-476); the port's Adam with the
    setting equals its Adam without it bitwise."""
    rng = np.random.default_rng(12)
    idx, src, dsrc = _dense_inputs(rng)
    rows = 64
    table = (rng.normal(size=(rows, 16)) * 0.5).astype(np.float32)
    jopt, topt = _opts(kind)
    tt = torch.from_numpy(table.copy())
    ts = tso.init_state(topt, rows, 16)
    jt, js = jso.apply_sparse(
        jopt, jnp.asarray(table), jso.init_state(jopt, rows, 16),
        jnp.asarray(idx), jnp.asarray(src), jnp.asarray(dsrc), jnp.asarray(0.01, jnp.float32), jnp.asarray(1),
        dense_rows=1000, dense_grad_dtype=jnp.bfloat16, dense_ratio=0.0)
    ref_t, ref_s = tt.clone(), {k: v.clone() for k, v in ts.items()}
    route = tso.apply_sparse(topt, tt, ts, torch.from_numpy(idx), torch.from_numpy(src), torch.from_numpy(dsrc),
                             torch.tensor(0.01), dense_rows=1000, dense_ratio=0.0, grad_dtype=torch.bfloat16)
    assert route == "dense"
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **F32_TOL)
    for k in ts:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), **F32_TOL, err_msg=k)
    tso.apply_sparse(topt, ref_t, ref_s, torch.from_numpy(idx), torch.from_numpy(src), torch.from_numpy(dsrc),
                     torch.tensor(0.01), dense_rows=1000, dense_ratio=0.0)
    assert torch.equal(ref_t, tt) == (kind == "adam")


def test_solver_settings_reach_the_collection_and_graph_file(tmp_path):
    for k in ("onehot_scatter_ratio", "onehot_scatter_maxv", "dense_grad_dtype"):
        assert k in PORT_SOLVER_SETTINGS
    m = tflagship.build_tiny_dlrm(CPU, batchsize=32, onehot_vocab=100, onehot_scatter_ratio=300,
                                  dense_grad_dtype="bfloat16")
    assert m.ec.dense_grad_dtype == torch.bfloat16
    assert m.ec.plan.options["onehot_scatter_ratio"] == 300
    # tables of 100 < V <= 1,000 rows with H x 300 >= V joined the one-hot group
    onehot = [t for g in m.ec.plan.groups if g.compute_kind == "onehot" for t in g.tables]
    assert max(t.vocabulary_size for t in onehot) > 100
    path = str(tmp_path / "g.json")
    m.graph_to_json(path)
    again = th.Model.construct_from_json(path, resource_manager=CPU)
    assert (again.solver.onehot_scatter_ratio, again.solver.dense_grad_dtype) == (300, "bfloat16")
    with pytest.raises(ValueError, match="dense_grad_dtype"):
        th.CreateSolver(dense_grad_dtype="float16").grad_dtype


@pytest.mark.parametrize("setting", ["scatter_ratio", "bf16_grad_adagrad", "bf16_grad_rowwise"])
def test_setting_trains_the_tiny_dlrm_as_jax(monkeypatch, setting):
    """Two steps of the tiny DLRM-DCNv2 from carried state with the setting
    on in both packages: the scatter ratio puts the tables of 100 < V <=
    1,000 rows with H x 300 >= V on the one-hot engine; the bf16 buffer
    runs on the dense sweep (shards of <= 100,000 rows)."""
    env = {"HCTR_TPU_ONEHOT_VOCAB": "100", "HCTR_TPU_HOT_ROWS": "0", "HCTR_TPU_DENSE_KEY_RATIO": "0",
           "HCTR_TPU_SEGSUM": "scan"}
    port = dict(onehot_vocab=100, dense_key_ratio=0.0)
    if setting == "scatter_ratio":
        env.update(HCTR_TPU_ONEHOT_SCATTER_RATIO="300", HCTR_TPU_DENSE_UPDATE_ROWS="0",
                   HCTR_BENCH_OPT="rowwise_adagrad")
        port.update(onehot_scatter_ratio=300, dense_update_rows=0, optimizer="rowwise_adagrad")
    else:
        opt = "adagrad" if setting == "bf16_grad_adagrad" else "rowwise_adagrad"
        env.update(HCTR_TPU_DENSE_GRAD_DTYPE="bfloat16", HCTR_TPU_DENSE_UPDATE_ROWS="100000", HCTR_BENCH_OPT=opt)
        port.update(dense_grad_dtype="bfloat16", dense_update_rows=100000, optimizer=opt)
    _env(monkeypatch, **env)
    monkeypatch.delenv("HCTR_TPU_EMB_DTYPE", raising=False)
    jm = jflagship.build_tiny_dlrm(JaxResourceManager.create(num_devices=1), batchsize=64)
    tm = tflagship.build_tiny_dlrm(CPU, batchsize=64, **port)
    assert [(g.name, g.compute_kind) for g in tm.ec.plan.groups] == [(g.name, g.compute_kind) for g in jm.ec.plan.groups]
    load_jax_state(tm, jax.device_get(jm.state))
    for step in range(2):
        jl, tl = jm.train(), tm.train()
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"loss at step {step + 1}")
    s = jax.device_get(jm.state)
    # the bf16 buffer: a cotangent a few float32 ulps from the other package's
    # may round to the neighbouring bf16 value, a gradient 2^-8 off, and an
    # AdaGrad step (lr x g / sqrt(accum)) up to lr x 2^-8 off: 2 lr x 2^-7
    # over two steps
    tol = F32_TOL if setting == "scatter_ratio" else dict(rtol=1e-4, atol=2 * 0.005 * 2.0**-7)
    for i in range(26):
        np.testing.assert_allclose(tm.ec.export_table(tm.tables, str(i)), jm.ec.export_table(s["emb_tables"], str(i)),
                                   **tol, err_msg=f"table {i}")
    if setting != "scatter_ratio":
        assert set(tm.ec.group_routes.values()) == {"onehot", "dense"}
