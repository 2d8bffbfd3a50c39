"""The meshes the JAX Solver can ask for, on the port against the JAX
package on its CPU mesh, from the same numpy inputs and carried weights.

* Mesh facts: the hierarchical ("dcn", "ici") and ("data", "ev") layouts
  against `ResourceManager.create` of the JAX package (exact).
* The collection over 4 gloo ranks (`tests/torch_rank_fns.py::CASES`
  "base" and "bf16_base", two rowwise-AdaGrad steps): the hierarchical
  (2, 2) mesh with Uniform and Hierarchical communication, and the
  ("data", "ev") (2, 2) mesh, against JAX's collection on the same mesh
  of 4 CPU devices. float32: outputs rtol 1e-6 (atol 1e-7), tables,
  storage and state rtol 1e-4 / atol 1e-5 (the update sums in another
  order); bf16: outputs bitwise (each level of the hierarchical exchange
  sums two bf16 partials in float32 and rounds once, as JAX's two
  psum_scatter calls do), updates within one bf16 ulp (rtol 2^-7, atol
  2^-7 x 0.1, state atol 1e-7). The ev replicas bitwise equal. The DCN
  level's reduce-scatter carries 1 / I of the flat one's bytes.
* Column-wise sharding (tests/test_column_sharding.py's model,
  `tools/flagship.py::build_tiny_column`): structure, 3 steps against JAX
  at factors 2 and 4 on one device and on 2 ranks (factor 4 on the sorted
  route), losses rtol 1e-5, tables rtol 1e-5 / atol 1e-6; the split
  table's output bitwise the unsplit one's from the same columns; a
  snapshot's files and sub-table rows the same as JAX's (bitwise).
* `group_rows` (tests/test_group_binning.py): the binned plans equal
  JAX's at 1, 2 and 8 shards; binned and unbinned collections agree
  within 1e-6.
* The multi-host rule: ranks on 2 hosts of 2 (LOCAL_WORLD_SIZE 2), each
  rank's synthetic batch bitwise the JAX package's SyntheticReader's
  block at (B / 2, seed + 7919 h), and 3 steps' losses (rtol 1e-5) against
  JAX fed the same global batches, flat and on the ("data", "ev") mesh.
  The Norm reader over 2 ranks of one host hands each rank the rows a
  one-process JAX mesh puts on its device (bitwise).
"""
import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_fns as fns
import hugectr_tpu as jh
from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.core.types import CommunicationStrategy as JComm
from hugectr_tpu.core.types import Combiner_t as JComb
from hugectr_tpu.core.types import Optimizer_t as JOpt
from hugectr_tpu.data import reader as jreader
from hugectr_tpu.embedding.collection import EmbeddingCollection as JEC
from hugectr_tpu.optim.params import OptParams as JOptParams
from hugectr_tpu.parallel import plan as jplan
import hugectr_tpu_torch as th
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Combiner_t, Optimizer_t
from hugectr_tpu_torch.embedding.collection import EmbeddingCollection
from hugectr_tpu_torch.optim.params import OptParams
from hugectr_tpu_torch.parallel import plan as tplan
from hugectr_tpu_torch.tools import flagship as tflagship
from hugectr_tpu_torch.tools import hybrid
from hugectr_tpu_torch.tools.carry import load_jax_state

from test_column_sharding import _model as jax_column_model
from test_torch_exchange import _key_rows
from test_torch_file_model import generate, reader_fields

torch.set_num_threads(1)
B, LR, STEPS = 48, 0.3, 2
F32_FWD_TOL = dict(rtol=1e-6, atol=1e-7)
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2.0**-7, atol=2.0**-7 * 0.1)
MODEL_TOL = dict(rtol=1e-5, atol=1e-6)
# name: (case of torch_rank_fns.CASES, the mesh, the communication strategy)
MESH_CASES = {
    "hier_uniform_f32": ("base", {"num_slices": 2}, "uniform"),
    "hier_f32": ("base", {"num_slices": 2}, "hierarchical"),
    "hier_uniform_bf16": ("bf16_base", {"num_slices": 2}, "uniform"),
    "hier_bf16": ("bf16_base", {"num_slices": 2}, "hierarchical"),
    "ev_f32": ("base", {"ev_parallelism": 2}, "uniform"),
    "ev_bf16": ("bf16_base", {"ev_parallelism": 2}, "uniform"),
}
# the engines of the column model, as Solver fields and as the JAX
# package's variables: the sorted route (the tests' JAX default), and the
# one-hot engine (factor 2)
SORTED = dict(onehot_vocab=0, dense_update_rows=0, dense_key_ratio=0.0)
SORTED_ENV = {"HCTR_TPU_ONEHOT_VOCAB": "0", "HCTR_TPU_DENSE_UPDATE_ROWS": "0", "HCTR_TPU_DENSE_KEY_RATIO": "0",
              "HCTR_TPU_SEGSUM": "xla"}
ONEHOT = dict(onehot_vocab=8192)
ONEHOT_ENV = {"HCTR_TPU_ONEHOT_VOCAB": "8192", "HCTR_TPU_ONEHOT_KERNEL": "xla"}
COLUMN_RUNS = {"col2": (2, ONEHOT, ONEHOT_ENV), "col4": (4, SORTED, SORTED_ENV)}


def _ec_inputs(name):
    case, mesh, comm = MESH_CASES[name]
    return fns.ec_inputs("rowwise_adagrad", B, STEPS, LR, case, mesh=mesh, comm=comm)


def _jax_state(jm):
    st = jax.device_get(jm.state)
    return {k: st[k] for k in ("emb_tables", "eopt", "dense_params", "dopt", "step")}


def _model_config(factor, steps=3, engine=None, mesh=None):
    cfg = dict(builder="build_tiny_column", steps=steps, eval=False, batch_out=True,
               kwargs=dict(factor=factor, **(engine or {})))
    return json.dumps(dict(cfg, mesh=mesh) if mesh else cfg)


def _host_batches(jm, hosts=2, n=4):
    """The global batches of the multi-host rule: host h's synthetic batch
    of B / H rows from seed + 7919 h, the hosts' batches one after another
    (the JAX package's process-local batches, model.py:506-527)."""
    spec = dataclasses.replace(jm.batch_spec, batch_size=jm.batch_spec.batch_size // hosts)
    readers = [iter(jreader.SyntheticReader(spec, jm._slot_vocabs(), num_batches=n, seed=1234 + 7919 * h))
               for h in range(hosts)]
    return [{k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
            for parts in (tuple(next(r) for r in readers) for _ in range(n))]


@pytest.fixture(scope="module")
def jax_fed():
    """JAX's column model on 4 CPU devices (sorted route), flat and on the
    ("data", "ev") mesh (factor 2), fed the multi-host global batches:
    (state before the steps, the losses of 3 steps, the global batches,
    the model)."""
    out = {}
    for name, rm, factor in (("flat", JaxResourceManager.create(num_devices=4), 1),
                             ("ev", JaxResourceManager.create(num_devices=4, ev_parallelism=2), 2)):
        jm = jax_column_model(rm, factor)
        state = _jax_state(jm)
        batches = _host_batches(jm)
        jm._train_iter = itertools.cycle([jm._put_batch(b) for b in batches])
        out[name] = (state, [jm.train() for _ in range(3)], batches, jm)
    return out


@pytest.fixture(scope="module")
def port_w4(jax_fed):
    """One spawned gloo group of 4 ranks started as 2 hosts of 2: the
    collection cases, the flat column model (factor 1) and the ev-mesh one
    (factor 2) from JAX's states."""
    inputs = {"ec": {n: _ec_inputs(n) for n in MESH_CASES},
              "mh": {"config": _model_config(1, engine=SORTED), "state": jax_fed["flat"][0]},
              "ev": {"config": _model_config(2, engine=SORTED, mesh={"ev_parallelism": 2}),
                     "state": jax_fed["ev"][0]},
              "calls": json.dumps({"ec": "collection_cases", "mh": "train_model", "ev": "train_model"})}
    return hybrid.run(fns.several, 4, inputs, device="cpu", hosts=2)


def _jax_column(world, factor, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jm = jax_column_model(JaxResourceManager.create(num_devices=world), factor)
    state = _jax_state(jm)
    losses = [jm.train() for _ in range(3)]
    st = jax.device_get(jm.state)
    tables = {t.name: np.asarray(jm.ec.export_table(st["emb_tables"], t.name))
              for g in jm.ec.plan.groups for t in g.tables}
    return state, losses, tables, jm


@pytest.fixture(scope="module")
def column_w2():
    """JAX's column runs on 2 CPU devices and the port's on 2 gloo ranks."""
    jax_runs, inputs = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        for name, (factor, engine, env) in COLUMN_RUNS.items():
            jax_runs[name] = _jax_column(2, factor, env, mp)
            inputs[name] = {"config": _model_config(factor, engine=engine), "state": jax_runs[name][0]}
    inputs["calls"] = json.dumps({n: "train_model" for n in COLUMN_RUNS})
    return jax_runs, hybrid.run(fns.several, 2, inputs, device="cpu")


def _jax_collection(name):
    """JAX's collection of a mesh case on its mesh of 4 devices: each
    step's outputs, the static tables, the global storage and state, the
    plan."""
    case, mesh, comm = MESH_CASES[name]
    c = fns.CASES[case]
    inputs = _ec_inputs(name)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in c["env"].items():
            mp.setenv(k, v)
        rm = JaxResourceManager.create(num_devices=4, **mesh)
        pl = jplan.compile_plan(fns.ec_lookups(jplan, JComb, case), jplan.ShardingPlan(c["strategy"]),
                                rm.data_parallel_size, c["shard_counts"])
        dt = jnp.bfloat16 if c["dtype"] == "bfloat16" else jnp.float32
        jec = JEC(pl, rm, JOptParams(JOpt.RowWiseAdaGrad, **fns.OPT_HYPER), dtype=dt, comm_strategy=JComm(comm))
        jt = jec.init(jax.random.key(0))
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
    host = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return dict(outs=outs, tables=tables, store={k: host(v) for k, v in jt.items()},
                state={g: {k: host(v) for k, v in st.items()} for g, st in js.items()}, plan=pl,
                blocks=rm.data_parallel_size)


# ---------------------------------------------------------------- mesh facts
@pytest.mark.parametrize("layout", ["hier", "ev", "flat"])
def test_mesh_facts_match_jax(layout):
    """The facts of each layout, and where rank r sits, against JAX's
    mesh of 8 devices (tests/test_hierarchical_mesh.py::test_mesh_facts)."""
    kw = {"hier": dict(num_slices=2), "ev": dict(ev_parallelism=2), "flat": {}}[layout]
    j = JaxResourceManager.create(num_devices=8, **kw)
    t = [ResourceManager(torch.device("cpu"), r, 8, **kw) for r in range(8)]
    for attr in ("num_devices", "is_hierarchical", "num_slices", "slice_size", "data_parallel_size",
                 "ev_parallel_size", "data_axes"):
        assert getattr(t[0], attr) == getattr(j, attr), attr
    # rank r is device r of the JAX mesh's reshape
    pos = {int(d.id): idx for idx, d in np.ndenumerate(j.mesh.devices)}
    for r, rm in enumerate(t):
        assert rm.data_index == (pos[r][0] if layout == "ev" else r)
        assert rm.ev_index == (pos[r][1] if layout == "ev" else 0)
        if layout == "hier":
            assert (r // rm.slice_size, r % rm.slice_size) == pos[r]


# ------------------------------------------------------ the collection at W 4
@pytest.fixture(scope="module")
def jax_ec():
    return {}


@pytest.fixture
def mesh_case(request, port_w4, jax_ec):
    name = request.param
    if name not in jax_ec:
        jax_ec[name] = _jax_collection(name)
    return name, [r["ec"][name] for r in port_w4], jax_ec[name]


def _bf16(name):
    return fns.CASES[MESH_CASES[name][0]]["dtype"] == "bfloat16"


@pytest.mark.parametrize("mesh_case", list(MESH_CASES), indirect=True)
def test_mesh_collection_matches_jax(mesh_case):
    """Each rank's outputs of its data block, its static tables, storage and
    state against JAX's on the same mesh; ranks holding the same storage
    (ev replicas, replicated groups) bitwise equal."""
    name, ranks, want = mesh_case
    bf16 = _bf16(name)
    n = B // want["blocks"]
    tol = BF16_TOL if bf16 else TOL
    for r, res in enumerate(ranks):
        d = r // 2 if name.startswith("ev") else r
        for step, outs in want["outs"].items():
            for top, w in outs.items():
                got, exp = res["fwd"][step][top], w[d * n : (d + 1) * n]
                msg = f"{name} step {step} rank {r} {top}"
                if step == "1" and bf16:
                    np.testing.assert_array_equal(got, exp, err_msg=msg)
                else:
                    np.testing.assert_allclose(got, exp, **(F32_FWD_TOL if step == "1" else tol), err_msg=msg)
        for t, w in want["tables"].items():
            np.testing.assert_allclose(res["tables"][t], w, **tol, err_msg=f"{name} rank {r} table {t}")
        for g in want["plan"].groups:
            m = res["storage"][g.name].shape[0]
            sl = slice(d * m, (d + 1) * m) if g.is_model_parallel else slice(None)
            got, exp = res["storage"][g.name], want["store"][g.name][sl]
            if g.is_model_parallel:
                got, exp = got[_key_rows(g, d)], exp[_key_rows(g, d)]
            np.testing.assert_allclose(got, exp, **tol, err_msg=f"{name} rank {r} storage {g.name}")
            for k, v in res["state"][g.name].items():
                np.testing.assert_allclose(v, want["state"][g.name][k][sl], **dict(tol, atol=1e-7) if bf16 else tol,
                                           err_msg=f"{name} rank {r} state {g.name}/{k}")
    for g in want["plan"].groups:
        holders = {}
        for r, res in enumerate(ranks):
            d = r // 2 if name.startswith("ev") else r
            key = d % g.num_shards if g.is_model_parallel else 0
            holders.setdefault(key, []).append(res["storage"][g.name])
        for arrays in holders.values():
            for a in arrays[1:]:
                np.testing.assert_array_equal(a, arrays[0], err_msg=f"{name} {g.name} replicas")


def test_hierarchical_levels_carry_their_bytes(port_w4):
    """Hierarchical on (2, 2): the forward's reduce-scatters go ICI then
    DCN, the DCN level at 1 / I of the flat (Uniform) reduce-scatter's
    bytes and the ICI level at all of them; the backward's gathers of the
    cotangents go DCN then ICI; the ev mesh's collectives run over the data
    group, and the one-hot gradient and the replicas' tables over the ev
    group (`broadcast_ev`)."""
    for res in port_w4:
        flat, hier = res["ec"]["hier_uniform_f32"]["collective_bytes"], res["ec"]["hier_f32"]["collective_bytes"]
        assert "reduce_scatter" not in hier and "reduce_scatter_dcn" not in flat
        assert hier["reduce_scatter_dcn"] * 2 == flat["reduce_scatter"] == hier["reduce_scatter_ici"]
        assert hier["all_gather_dcn"] * 2 == hier["all_gather_ici"]
        ev = res["ec"]["ev_f32"]["collective_calls"]
        assert ev["broadcast_ev"] > 0 and ev["reduce_scatter"] > 0


# -------------------------------------------------------- the multi-host rule
def test_multi_host_batches_are_the_jax_process_blocks(port_w4, jax_fed):
    """Rank r = 2 h + l reads rows [l B/4, (l + 1) B/4) of host h's batch
    of B / 2 rows from seed + 7919 h, bitwise; on the ("data", "ev") mesh
    rank r's data block r // 2 is host r // 2's whole batch."""
    glob = jax_fed["flat"][2][0]
    for r, res in enumerate(port_w4):
        for k, want in glob.items():
            np.testing.assert_array_equal(res["mh"]["first_batch"][k], want[r * 16 : (r + 1) * 16], err_msg=k)
            np.testing.assert_array_equal(res["ev"]["first_batch"][k], want[(r // 2) * 32 : (r // 2 + 1) * 32],
                                          err_msg=k)


@pytest.mark.parametrize("layout", ["mh", "ev"])
def test_multi_host_losses_match_jax_fed_the_global_batches(port_w4, jax_fed, layout):
    """3 steps on 2 hosts of 2 ranks against JAX on 4 devices fed the same
    global batches: losses rtol 1e-5 on every rank, tables rtol 1e-5 / atol
    1e-6; on the ev mesh each pair of ev replicas bitwise equal."""
    _state, losses, _b, jm = jax_fed["flat" if layout == "mh" else "ev"]
    st = jax.device_get(jm.state)
    for r, res in enumerate(port_w4):
        np.testing.assert_allclose(res[layout]["losses"], losses, rtol=1e-5, err_msg=f"rank {r}")
        for t, got in res[layout]["tables"].items():
            np.testing.assert_allclose(got, jm.ec.export_table(st["emb_tables"], t), **MODEL_TOL, err_msg=t)
    if layout == "ev":
        for a, b in ((0, 1), (2, 3)):
            for part in ("replicated", "shards"):
                for k, v in port_w4[a][layout][part].items():
                    np.testing.assert_array_equal(port_w4[b][layout][part][k], v, err_msg=f"{part} {k}")


def test_norm_reader_blocks_on_one_host_are_the_jax_mesh_blocks(tmp_path):
    """Two ranks on one host read the Norm files as one JAX process does
    (every file, the global batch of 64) and keep their blocks of 32
    (`BlockReader`), the rows a one-process JAX mesh puts on each device;
    before, each rank read every other file."""
    p = generate(str(tmp_path), "norm")
    fields = reader_fields("norm", p)
    want = None
    for r in range(2):
        rm = ResourceManager(torch.device("cpu"), r, 2)
        m = tflagship.build_tiny_dlrm(rm, batchsize=64, reader=th.DataReaderParams(**fields))
        got = next(iter(m.train_reader))
        if want is None:
            spec = jreader.BatchSpec(**{f.name: getattr(m.batch_spec, f.name)
                                        for f in dataclasses.fields(m.batch_spec) if f.name != "sparse"},
                                     sparse=tuple(jreader.SparseFeatureSpec(f.name, f.slot_nnz)
                                                  for f in m.batch_spec.sparse))
            want = next(iter(jreader.NormReader(fields["source"][0], spec, repeat=False,
                                                slot_size_array=fields["slot_size_array"])))
        assert m.train_reader.block == (r, 2)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v[r * 32 : (r + 1) * 32], err_msg=k)
        m._close_readers()


# ------------------------------------------------------- column-wise sharding
@pytest.mark.parametrize("factor", [2, 4])
def test_column_split_structure_and_training_match_jax(factor, monkeypatch):
    """Table t0 split into `factor` sub-tables of ev / factor (JAX's names
    and widths, the user top still 16 wide), 3 steps from JAX's state
    against JAX's (factor 4 on the sorted route) on one device."""
    engine, env = COLUMN_RUNS[f"col{factor}"][1:]
    state, losses, tables, jm = _jax_column(1, factor, env, monkeypatch)
    tm = tflagship.build_tiny_column(ResourceManager.create(device="cpu"), factor=factor, **engine)
    names = [t.name for g in tm.ec.plan.groups for t in g.tables]
    assert names == [t.name for g in jm.ec.plan.groups for t in g.tables] == [f"t0#col{j}" for j in range(factor)]
    assert [g.ev_size for g in tm.ec.plan.groups] == [g.ev_size for g in jm.ec.plan.groups] == [16 // factor]
    assert sum(lk.out_width for lk in tm.ec.plan.lookups) == 16  # the user top's width
    load_jax_state(tm, state)
    np.testing.assert_allclose([tm.train() for _ in range(3)], losses, rtol=1e-5)
    for t, w in tables.items():
        np.testing.assert_allclose(tm.ec.export_table(tm.tables, t), w, **MODEL_TOL, err_msg=t)
    if factor == 4:
        assert set(tm.ec.group_routes.values()) == {"sorted"}
    assert 0.0 <= tm.eval()["auc"] <= 1.0


@pytest.mark.parametrize("run", list(COLUMN_RUNS))
def test_column_split_over_two_ranks_matches_jax(column_w2, run):
    """Factors 2 and 4 on 2 gloo ranks against JAX on 2 devices from the
    same state: losses rtol 1e-5 on each rank, every sub-table in key
    order rtol 1e-5 / atol 1e-6."""
    jax_runs, ranks = column_w2
    _state, losses, tables, _jm = jax_runs[run]
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[run]["losses"], losses, rtol=1e-5, err_msg=f"rank {r}")
        for t, w in tables.items():
            np.testing.assert_allclose(res[run]["tables"][t], w, **MODEL_TOL, err_msg=f"rank {r} {t}")


def test_column_split_matches_unsplit_forward():
    """The split lookup is the unsplit one with the table's columns
    partitioned: the same keys give the concatenated halves, bitwise
    (tests/test_column_sharding.py::test_column_split_matches_unsplit_forward)."""
    rm = ResourceManager.create(device="cpu")
    m1, m2 = tflagship.build_tiny_column(rm, 1), tflagship.build_tiny_column(rm, 2)
    full = m1.ec.export_table(m1.tables, "t0")
    m2.ec.import_table(m2.tables, "t0#col0", full[:, :8])
    m2.ec.import_table(m2.tables, "t0#col1", full[:, 8:])
    keys = np.random.default_rng(0).integers(0, 100, (64, 2)).astype(np.int32)
    keys[1, 1] = -1
    batch = {"label": np.zeros((64, 1), np.float32), "dense": np.zeros((64, 4), np.float32), "d0": keys}
    np.testing.assert_array_equal(m1.check_out_tensor("emb", batch), m2.check_out_tensor("emb", batch))


@pytest.mark.parametrize("bad", ["ev", "concat"])
def test_column_split_refuses_what_jax_refuses(bad):
    """An ev size the factor does not divide, and a Concat lookup, raise
    JAX's errors (model.py:260-275)."""
    model = th.Model(th.CreateSolver(batchsize=8, batchsize_eval=8), None, th.CreateOptimizer(), device="cpu")
    model.add(th.Input(label_dim=1, label_name="label", dense_dim=1, dense_name="dense",
                       data_reader_sparse_param_array=[th.DataReaderSparseParam("d0", 1, True, 1)]))
    ebc = th.EmbeddingCollectionConfig()
    ebc.embedding_lookup(th.EmbeddingTableConfig(name="t0", max_vocabulary_size=10, ev_size=6), "d0", "emb",
                         "concat" if bad == "concat" else "sum")
    ebc.shard(shard_matrix=[["t0"]], shard_strategy=[("mp", ["t0"])], column_factors={"t0": 4 if bad == "ev" else 2})
    model.add(ebc)
    err, match = (ValueError, "not divisible by column factor 4") if bad == "ev" else \
        (NotImplementedError, "column-wise sharding with concat combiner")
    with pytest.raises(err, match=match):
        model.compile()


# ---------------------------------------------------------------- group_rows
def _many_tables(pkg, comb, n=8, vocab=1000):
    tables = [pkg.EmbeddingTableConfig(f"t{i}", vocab, 8) for i in range(n)]
    return [pkg.LookupConfig(i, t, f"f{i}", f"e{i}", comb.Sum, 3) for i, t in enumerate(tables)]


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_group_rows_plans_match_jax(shards, monkeypatch):
    """Eight 1,000-row tables binned at 2,000 rows a shard: the port's groups
    (names, tables, rows a shard, offsets) equal JAX's under
    HCTR_TPU_GROUP_ROWS (tests/test_group_binning.py); one bin keeps the
    unbinned name."""
    strategy = [("mp", [f"t{i}" for i in range(8)])]
    monkeypatch.setenv("HCTR_TPU_GROUP_ROWS", "2000")
    want = jplan.compile_plan(_many_tables(jplan, JComb), jplan.ShardingPlan(strategy), shards)
    got = tplan.compile_plan(_many_tables(tplan, Combiner_t), tplan.ShardingPlan(strategy), shards, onehot_vocab=0,
                             group_rows=2000)
    assert [g.name for g in got.groups] == [g.name for g in want.groups]
    for a, b in zip(got.groups, want.groups):
        assert [t.name for t in a.tables] == [t.name for t in b.tables]
        np.testing.assert_array_equal(a.rows_per_shard, b.rows_per_shard)
        np.testing.assert_array_equal(a.local_offsets, b.local_offsets)
        assert a.total_local_rows <= 2000 or len(a.tables) == 1
    assert len(got.groups) == {1: 4, 2: 2, 8: 1}[shards]


def test_group_rows_binning_is_exact():
    """The binned collection's outputs and tables equal the unbinned one's
    from the same tables and keys (within 1e-6: per-row math is the
    same), and `Solver.group_rows` reaches the Model's plan."""
    rng = np.random.default_rng(5)
    lookups = _many_tables(tplan, Combiner_t)
    strategy = tplan.ShardingPlan([("mp", [f"t{i}" for i in range(8)])])
    keys = {f"f{i}": torch.from_numpy(rng.integers(0, 1000, (32, 3)).astype(np.int32)) for i in range(8)}
    d = {f"e{i}": torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32)) for i in range(8)}
    values = {f"t{i}": rng.normal(size=(1000, 8)).astype(np.float32) for i in range(8)}
    res = []
    for cap in (0, 2000):
        plan = tplan.compile_plan(lookups, strategy, 1, onehot_vocab=0, group_rows=cap)
        ec = EmbeddingCollection(plan, ResourceManager.create(device="cpu"), OptParams(Optimizer_t.AdaGrad, lr=0.1))
        tables = ec.init(torch.Generator().manual_seed(0))
        for t, v in values.items():
            ec.import_table(tables, t, v)
        state = ec.init_optimizer(tables)
        fwd = ec.forward(tables, keys)
        ec.backward_and_update(tables, state, keys, d, torch.tensor(0.1), 1)
        res.append((len(plan.groups), fwd, {t: ec.export_table(tables, t) for t in values}))
    assert (res[0][0], res[1][0]) == (1, 4)
    for k in res[0][1]:
        np.testing.assert_allclose(res[1][1][k].numpy(), res[0][1][k].numpy(), rtol=1e-6, atol=0)
    for t in values:
        np.testing.assert_allclose(res[1][2][t], res[0][2][t], rtol=1e-6, atol=1e-7)
    m = tflagship.build_tiny_dlrm(ResourceManager.create(device="cpu"), batchsize=8, onehot_vocab=100,
                                  group_rows=800)
    binned = [g for g in m.ec.plan.groups if "_bin" in g.name]
    assert binned and all(g.total_local_rows <= 800 or len(g.tables) == 1 for g in binned)


def test_column_split_snapshot_names_and_rows_match_jax(tmp_path, monkeypatch):
    """A snapshot of the column model (factor 2) from JAX's state: the same
    files in both packages (`sparse_t0#col0/`, `sparse_t0#col1/`, the
    groups' state), each sub-table's rows the same bytes; unknown to the
    collection, the unsplit name "t0" cannot be frozen in either."""
    import os

    _state, _losses, _tables, jm = _jax_column(1, 2, ONEHOT_ENV, monkeypatch)
    tm = tflagship.build_tiny_column(ResourceManager.create(device="cpu"), factor=2, **ONEHOT)
    load_jax_state(tm, _jax_state(jm))
    jm.download_params_to_files(str(tmp_path / "jax"), 0)
    tm.download_params_to_files(str(tmp_path / "port"), 0)

    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)

    jdir, tdir = str(tmp_path / "jax_iter0"), str(tmp_path / "port_iter0")
    assert files(tdir) == files(jdir)
    for j in range(2):
        name = f"sparse_t0#col{j}/emb_vector.npy"
        assert name in files(tdir)
        np.testing.assert_array_equal(np.load(os.path.join(tdir, name)), np.load(os.path.join(jdir, name)))
    for m in (jm, tm):
        with pytest.raises(KeyError):
            m.freeze_embedding("t0")
