"""The packed table-and-state layouts of the port against the JAX package on
the CPU: AdaGrad's [R, 2E] (HCTR_TPU_PACKED_STATE, the port's
`packed_state`) and RowWiseAdaGrad's [R, E + 1] (HCTR_TPU_ROWWISE_PACK,
`rowwise_pack`), as tests/test_packed_state.py and tests/test_rowwise_pack.py
set them up, and their snapshots (`packed_<group>.npy`).

Tolerances, and why:
- the collection, 3 steps from the same tables: float32 rtol 1e-5 / atol
  1e-6 (float32 segment sums in another order); bfloat16 one bfloat16 ulp
  (2^-7 relative, 2^-7 x 0.5 absolute at the tables' scale): both packages
  compute in float32 and round each add to bfloat16, so a value next to a
  rounding boundary may land on its neighbour. The accumulator columns are
  held to the same;
- the model: the snapshot's files byte for byte, the loaded state bitwise;
  the losses of 2 steps after the load rtol 1e-4 in float32 (the tolerance
  of tests/test_torch_persistence.py) and, from bf16 tables, 1e-5 for the
  first and 5e-3 for the second (tests/test_torch_bench.py's tolerances);
- the compact forward (the ordered pool through the packed rows' stride):
  bitwise the same weights' forward stored apart.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hugectr_tpu as jh
from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.core.types import Combiner_t as JComb
from hugectr_tpu.core.types import Optimizer_t as JOpt
from hugectr_tpu.embedding.collection import EmbeddingCollection as JEC
from hugectr_tpu.optim.params import OptParams as JOptParams
from hugectr_tpu.parallel import plan as jplan
from hugectr_tpu.tools import flagship as jflagship
from hugectr_tpu_torch import ops
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Combiner_t as TComb
from hugectr_tpu_torch.core.types import Optimizer_t as TOpt
from hugectr_tpu_torch.embedding.collection import EmbeddingCollection as TEC
from hugectr_tpu_torch.optim.params import OptParams as TOptParams
from hugectr_tpu_torch.parallel import plan as tplan
from hugectr_tpu_torch.tools import flagship as tflagship
from hugectr_tpu_torch.tools.carry import load_jax_state

from test_embedding_collection import random_keys
from test_torch_bench import JAX_ENV as BENCH_ENV
from test_torch_bench import SPLIT as BENCH_SPLIT
from test_torch_bench import TINY as BENCH_TINY
from test_torch_model import ENGINE as F32_ENGINE
from test_torch_model import JAX_ENV as F32_ENV
from test_torch_persistence import assert_same_snapshot, skip_batches

torch.set_num_threads(1)
CPU = ResourceManager.create(device="cpu")
# layout: (JAX variable, the port's Solver field, JAX / port optimizer)
LAYOUTS = {
    "full": ("HCTR_TPU_PACKED_STATE", "packed_state", JOpt.AdaGrad, TOpt.AdaGrad),
    "rowwise": ("HCTR_TPU_ROWWISE_PACK", "rowwise_pack", JOpt.RowWiseAdaGrad, TOpt.RowWiseAdaGrad),
}


def _lookups(pkg, comb):
    t0 = pkg.EmbeddingTableConfig(name="t0", max_vocabulary_size=96, ev_size=8)
    t1 = pkg.EmbeddingTableConfig(name="t1", max_vocabulary_size=64, ev_size=8)
    return [pkg.LookupConfig(0, t0, "f0", "e0", comb.Sum, 4), pkg.LookupConfig(1, t1, "f1", "e1", comb.Mean, 3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["full", "rowwise"])
def test_packed_collection_three_steps_match_jax(mesh1, monkeypatch, layout, dtype):
    """The two tables of tests/test_packed_state.py in one packed group
    (every lookup on the sorted route), 3 forward + update steps from the
    same tables in both packages: the outputs, the whole packed storage
    (weights and accumulators) after each step, and the weights export."""
    var, field, jopt, topt = LAYOUTS[layout]
    for k, v in {"HCTR_TPU_DENSE_UPDATE_ROWS": "0", "HCTR_TPU_ONEHOT_VOCAB": "0", "HCTR_TPU_SEGSUM": "xla",
                 "HCTR_TPU_UCAP_FACTOR": "0", "HCTR_TPU_PACKED_STATE": "", "HCTR_TPU_ROWWISE_PACK": "0",
                 var: "1"}.items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(51)
    b = 32
    feats = {"f0": random_keys(rng, b, 4, 96), "f1": random_keys(rng, b, 3, 64)}
    values = {"t0": (rng.normal(size=(96, 8)) * 0.5).astype(np.float32),
              "t1": (rng.normal(size=(64, 8)) * 0.5).astype(np.float32)}
    d_outs = [{f"e{i}": rng.normal(size=(b, 8)).astype(np.float32) for i in range(2)} for _ in range(3)]
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    strategy = [("mp", ["t0", "t1"])]

    jec = JEC(jplan.compile_plan(_lookups(jplan, JComb), jplan.ShardingPlan(strategy=strategy), 1), mesh1,
              JOptParams(jopt, lr=0.3, initial_accu_value=0.0, epsilon=1e-7), dtype=jdt)
    tec = TEC(tplan.compile_plan(_lookups(tplan, TComb), tplan.ShardingPlan(strategy=strategy), 1, onehot_vocab=0),
              CPU, TOptParams(topt, lr=0.3, initial_accu_value=0.0, epsilon=1e-7), dtype=tdt, dense_update_rows=0,
              **{field: True})
    assert tec.packed_kind == jec.packed_kind == {"mp_ev8": layout}
    jt = jec.init(jax.random.key(3))
    tt = tec.init(CPU.generator(3))
    width = 16 if layout == "full" else 9
    assert tuple(tt["mp_ev8"].shape) == tuple(jt["mp_ev8"].shape) == (160, width)
    for n, v in values.items():
        jt = jec.import_table(jt, n, v)
        tec.import_table(tt, n, v)
    js, ts = jec.init_optimizer(jt), tec.init_optimizer(tt)
    assert js == {"mp_ev8": {}} and ts == {"mp_ev8": {}}
    tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    if dtype == "float32":
        tol = dict(rtol=1e-5, atol=1e-6)
    else:
        tol = dict(rtol=2.0**-7, atol=2.0**-7 * 0.5)
    ops.reset_counts()
    for step in range(3):
        jout = jax.jit(jec.forward)(jt, feats)
        tout = tec.forward(tt, tfeats)
        for k in jout:
            np.testing.assert_allclose(tout[k].float().numpy(), np.asarray(jout[k]).astype(np.float32), **tol,
                                       err_msg=f"{k} at step {step + 1}")
        jt, js = jax.jit(jec.backward_and_update)(
            jt, js, feats, {k: jnp.asarray(v, jdt) for k, v in d_outs[step].items()}, jnp.asarray(0.3),
            jnp.asarray(step + 1))
        tec.backward_and_update(tt, ts, tfeats, {k: torch.from_numpy(v).to(tdt) for k, v in d_outs[step].items()},
                                torch.tensor(0.3), step + 1)
        assert tec.group_routes == {"mp_ev8": "sorted"}
        np.testing.assert_allclose(tt["mp_ev8"].float().numpy(), np.asarray(jt["mp_ev8"]).astype(np.float32),
                                   **tol, err_msg=f"packed storage after step {step + 1}")
    assert ops.plain_counts()["segscan"] == 3
    for n in values:
        got, want = tec.export_table(tt, n), np.asarray(jec.export_table(jt, n)).astype(np.float32)
        assert got.shape == want.shape == values[n].shape
        np.testing.assert_allclose(got, want, **tol, err_msg=n)
    # importing weights keeps the accumulators (tests/test_packed_state.py:124-141)
    acc = tt["mp_ev8"][:, 8:].clone()
    tec.import_table(tt, "t0", np.zeros((96, 8), np.float32))
    assert torch.equal(tt["mp_ev8"][:, 8:], acc) and not tec.export_table(tt, "t0").any()


def _jax_model(mp, layout: str):
    """The JAX tiny model of a layout: the float32 tiny DLRM-DCNv2 with
    AdaGrad packed [R, 2E], or the tiny bench-configured model (bf16) with
    its RowWiseAdaGrad cold tiers packed [R, E + 1]."""
    if layout == "full":
        for k, v in dict(F32_ENV, HCTR_BENCH_OPT="adagrad", HCTR_TPU_PACKED_STATE="1").items():
            mp.setenv(k, v)
        mp.delenv("HCTR_TPU_EMB_DTYPE", raising=False)
        return jflagship.build_tiny_dlrm(JaxResourceManager.create(num_devices=1), batchsize=64)
    for k, v in dict(BENCH_ENV, HCTR_TPU_ROWWISE_PACK="1").items():
        mp.setenv(k, v)
    reader = jh.DataReaderParams(data_reader_type="synthetic", synthetic_num_batches=3, synthetic_alpha=1.05,
                                 synthetic_learnable=True)
    return jflagship.build_dlrm_dcnv2(JaxResourceManager.create(num_devices=1), reader=reader, **BENCH_TINY)


def _port_model(layout: str):
    if layout == "full":
        return tflagship.build_tiny_dlrm(CPU, batchsize=64, optimizer="adagrad", packed_state=True, **F32_ENGINE)
    kw = dict(tflagship.bench_settings(), **BENCH_TINY, **BENCH_SPLIT, unique_cap_factor=0, rowwise_pack=True)
    return tflagship.build_dlrm_dcnv2(CPU, onehot_vocab=64, synthetic_learnable=True, **kw)


@pytest.mark.parametrize("layout", ["full", "rowwise"])
def test_packed_snapshot_writes_jax_bytes_loads_and_resumes(monkeypatch, tmp_path, layout):
    """A model with packed groups: the JAX model takes one step and writes
    its snapshot (`packed_<group>.npy` beside the usual files); the port,
    carrying that state, writes the same files byte for byte; a fresh port
    model loads the JAX snapshot (the packed storage bitwise) and its next
    two losses are the JAX model's."""
    jm = _jax_model(monkeypatch, layout)
    jm.train()
    jm.download_params_to_files(str(tmp_path / "jax"), 1)
    state = jax.device_get(jm.state)
    packed = sorted(jm.ec.packed_groups)
    assert packed
    tm = _port_model(layout)
    assert sorted(tm.ec.packed_groups) == packed and tm.ec.packed_kind == jm.ec.packed_kind
    load_jax_state(tm, state)
    tm.download_params_to_files(str(tmp_path / "port"), 1)
    rels = assert_same_snapshot(str(tmp_path / "port_iter1"), str(tmp_path / "jax_iter1"))
    assert {f"packed_{g}.npy" for g in packed} <= set(rels)
    fresh = _port_model(layout)
    fresh.load_params_from_files(str(tmp_path / "jax_iter1"))
    for g in packed:
        np.testing.assert_array_equal(fresh.tables[g].float().numpy(),
                                      np.asarray(state["emb_tables"][g]).astype(np.float32), err_msg=g)
        assert fresh.eopt[g] == {}
    skip_batches(fresh, 1)
    for step in range(2):
        jl, tl = jm.train(), fresh.train()
        rtol = 1e-4 if layout == "full" else (1e-5 if step == 0 else 5e-3)
        np.testing.assert_allclose(tl, jl, rtol=rtol, err_msg=f"loss {step + 1} after the load")
    assert all(fresh.ec.group_routes[g] == "sorted" for g in packed)


@pytest.mark.parametrize("layout", ["full", "rowwise"])
def test_compact_forward_reads_the_packed_rows(layout):
    """The compact forward (the ordered pool) on a packed group reads the
    first E columns of its rows through their stride: bitwise the forward
    of the same weights stored apart, bf16."""
    _var, field, _jopt, topt = LAYOUTS[layout]
    rng = np.random.default_rng(9)
    feats = {"f0": torch.from_numpy(random_keys(rng, 32, 4, 96)), "f1": torch.from_numpy(random_keys(rng, 32, 3, 64))}
    values = {"t0": rng.normal(size=(96, 8)).astype(np.float32), "t1": rng.normal(size=(64, 8)).astype(np.float32)}
    outs = []
    for packed in (False, True):
        plan = tplan.compile_plan(_lookups(tplan, TComb), tplan.ShardingPlan(strategy=[("mp", ["t0", "t1"])]), 1,
                                  onehot_vocab=0)
        ec = TEC(plan, CPU, TOptParams(topt), dtype=torch.bfloat16, dense_update_rows=0, **{field: packed})
        ec.valid_caps["mp_ev8"] = 1  # any valid cap below the key list sends the group to the compact forward
        tables = ec.init(CPU.generator(0))
        for n, v in values.items():
            ec.import_table(tables, n, v)
        assert (ec.packed_kind == {"mp_ev8": layout}) == packed
        ops.reset_counts()
        outs.append(ec.forward(tables, feats))
        assert ops.plain_counts()["ordered_pool"] == 1
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
