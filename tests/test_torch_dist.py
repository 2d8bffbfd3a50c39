"""The pieces of hybrid parallelism that need no group, or one: the owner
rotation and the compiled plans at 2, 4 and 8 shards against the JAX
package's, the owner and row of a key against JAX's `_slot_placement`, the
collectives of `core/mesh.py` over a gloo group of 2 spawned ranks and
without a group, the route rule of a sharded group, each rank's block of a
batch, and what over more than one rank still raises; the plans of a
partial placement (`shard_matrix` giving tables fewer shards than ranks) at
2, 4 and 8 shards, with and without bench.py's split. All exact.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import torch_rank_fns as fns
from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.core.types import Combiner_t as JComb
from hugectr_tpu.core.types import Optimizer_t as JOpt
from hugectr_tpu.embedding.collection import EmbeddingCollection as JEC
from hugectr_tpu.optim.params import OptParams as JOptParams
from hugectr_tpu.parallel import plan as jplan
from hugectr_tpu.tools.flagship import MLPERF_MULTI_HOT_SIZES, MLPERF_TABLE_SIZES
import hugectr_tpu_torch as hugectr
from hugectr_tpu_torch.core import mesh
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Combiner_t as TComb
from hugectr_tpu_torch.core.types import Optimizer_t as TOpt
from hugectr_tpu_torch.data import reader as treader
from hugectr_tpu_torch.embedding.collection import EmbeddingCollection as TEC
from hugectr_tpu_torch.optim.params import OptParams as TOptParams
from hugectr_tpu_torch.parallel import plan as tplan
from hugectr_tpu_torch.tools import flagship as tflagship
from hugectr_tpu_torch.tools import hybrid


def _rm(world, rank=0, local=None):
    """A manager of `world` ranks without a group: plans, placement and
    configuration checks make no collective."""
    return ResourceManager(torch.device("cpu"), rank, world, local)


@pytest.mark.parametrize("name", ["0", "20", "20::cold", "20::shot", "t3#col1", "big::hot#col0", "user_id"])
def test_table_shard_rotation_matches_jax(name, monkeypatch):
    assert tplan.table_shard_rotation(name) == jplan.table_shard_rotation(name)
    monkeypatch.setenv("HCTR_TPU_SHARD_ROTATION", "0")
    assert tplan.table_shard_rotation(name, rotate=False) == jplan.table_shard_rotation(name) == 0


# (vocab cap, ev, one-hot threshold, hotness) of the flagship, the tiny
# DLRM-DCNv2 of the tests and DLRM-FTRL (hotness 1, its slot sizes)
MODELS = {
    "flagship": (2_000_000, 128, 8192, MLPERF_TABLE_SIZES, MLPERF_MULTI_HOT_SIZES),
    "tiny": (1000, 16, 100, MLPERF_TABLE_SIZES, MLPERF_MULTI_HOT_SIZES),
    "ftrl": (400_000, 128, 8192, tflagship.FTRL_SLOT_SIZES, [1] * 26),
}


def _lookups(pkg, comb, model):
    cap, ev, _oh, sizes, hot = MODELS[model]
    return [
        pkg.LookupConfig(i, pkg.EmbeddingTableConfig(str(i), min(v, cap), ev), f"data{i}",
                         f"sparse_embedding:{i}", comb.Sum, hot[i])
        for i, v in enumerate(sizes)
    ]


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("model", list(MODELS))
def test_compiled_plans_match_jax(monkeypatch, model, shards):
    """Group names (`_x{f}` only for partial placement), kinds, rows per
    shard, offsets and rotations, as `Model` compiles them over W ranks
    (every table on every rank: shard counts W)."""
    onehot = MODELS[model][2]
    monkeypatch.setenv("HCTR_TPU_ONEHOT_VOCAB", str(onehot))
    monkeypatch.setenv("HCTR_TPU_SPLIT_VOCAB", str(256 * 1024))
    names = [str(i) for i in range(26)]
    counts = {n: shards for n in names}
    jp = jplan.compile_plan(_lookups(jplan, JComb, model), jplan.ShardingPlan([("mp", names)]), shards, counts)
    tp = tplan.compile_plan(_lookups(tplan, TComb, model), tplan.ShardingPlan([("mp", names)]), shards, counts,
                            onehot_vocab=onehot)
    assert [g.name for g in tp.groups] == [g.name for g in jp.groups]
    assert not any("_x" in g.name for g in tp.groups)
    for jg, tg in zip(jp.groups, tp.groups):
        assert (tg.compute_kind, tg.placement.value) == (jg.compute_kind, jg.placement.value)
        for f in ("num_shards", "mesh_size", "num_replicas", "total_local_rows", "total_storage_rows"):
            assert getattr(tg, f) == getattr(jg, f), f
        for f in ("rows_per_shard", "local_offsets", "table_rotation", "slot_rotation", "slot_local_offset"):
            np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f), err_msg=f)
    if model == "flagship":
        assert [g.name for g in tflagship.flagship_plan(num_shards=shards).groups] == [g.name for g in tp.groups]


# shard counts of a partial placement: table 0 on one shard, 9 on 3 (the
# plan widens it to the next divisor of W), 20 on 2 and 21 on 5; the others
# on every rank
PARTIAL_COUNTS = {"0": 1, "9": 3, "20": 2, "21": 5}


@pytest.mark.parametrize("bench", [False, True], ids=["plain", "bench_plan"])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_partial_plans_match_jax(monkeypatch, shards, bench):
    """The flagship's plan with a partial placement (`PARTIAL_COUNTS`)
    against the JAX package's `compile_plan` (plan.py:584) and
    `_shard_count_of` (:566-581): group names (`_x{f}`), the tables of each
    group, shards, replicas, rows per shard, offsets, rotations; with
    `BENCH_PLAN`, the split's sub-tables on their parents' shard counts,
    the merges and the splits."""
    plan_kw = tflagship.BENCH_PLAN if bench else {}
    for k, v in {"HCTR_TPU_ONEHOT_VOCAB": 8192, "HCTR_TPU_SPLIT_VOCAB": plan_kw.get("split_vocab", 256 * 1024),
                 "HCTR_TPU_HOT_ROWS": plan_kw.get("hot_rows", 0),
                 "HCTR_TPU_SUPERHOT_ROWS": plan_kw.get("superhot_rows", 0)}.items():
        monkeypatch.setenv(k, str(v))
    names = [str(i) for i in range(26)]
    matrix = tflagship.shard_matrix(names, shards, PARTIAL_COUNTS)
    counts = {n: sum(n in row for row in matrix) for n in names}
    assert counts["0"] == 1 and counts["9"] == min(3, shards) and counts["1"] == shards
    jp = jplan.compile_plan(_lookups(jplan, JComb, "flagship"), jplan.ShardingPlan([("mp", names)]), shards, counts)
    tp = tplan.compile_plan(_lookups(tplan, TComb, "flagship"), tplan.ShardingPlan([("mp", names)]), shards, counts,
                            onehot_vocab=8192, **plan_kw)
    assert [g.name for g in tp.groups] == [g.name for g in jp.groups]
    assert any(g.num_replicas > 1 and "_x" in g.name for g in tp.groups)
    for jg, tg in zip(jp.groups, tp.groups):
        assert [t.name for t in tg.tables] == [t.name for t in jg.tables]
        for f in ("num_shards", "mesh_size", "num_replicas", "total_local_rows", "total_storage_rows"):
            assert getattr(tg, f) == getattr(jg, f), f
        for f in ("rows_per_shard", "local_offsets", "table_rotation", "slot_rotation", "slot_local_offset",
                  "slot_vocab"):
            np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f), err_msg=f)
        if tg.is_model_parallel:
            f = tg.num_shards
            assert shards % f == 0 and tg.num_replicas == shards // f
            assert tg.name.endswith(f"_x{f}") == (f != shards)
    assert [(m.top_name, m.sub_tops) for m in tp.merges] == [(m.top_name, m.sub_tops) for m in jp.merges]
    assert tp.table_splits == jp.table_splits and bool(tp.table_splits) == bench


@pytest.mark.parametrize("int64", [False, True])
def test_slot_placement_owner_and_row_match_jax(monkeypatch, int64):
    """Owner and local row of every key at f = 4, -1 padding, negative keys,
    keys >= V and, as int64, keys >= 2^31 (cut to int32 first)."""
    for k, v in fns.EC_ENV.items():
        monkeypatch.setenv(k, v)
    jp = jplan.compile_plan(fns.ec_lookups(jplan, JComb), jplan.ShardingPlan(fns.EC_STRATEGY), 4)
    jec = JEC(jp, JaxResourceManager.create(num_devices=4), JOptParams(JOpt.RowWiseAdaGrad))
    tp = tplan.compile_plan(fns.ec_lookups(tplan, TComb), tplan.ShardingPlan(fns.EC_STRATEGY), 4,
                            onehot_vocab=128, split_vocab=4000)
    tec = TEC(tp, _rm(4), TOptParams(TOpt.RowWiseAdaGrad))
    rng = np.random.default_rng(41)
    for g in (g for g in tp.groups if g.is_model_parallel):
        v = int(g.slot_vocab.max())
        keys = rng.integers(-3 * v, 3 * v, size=(64, g.hotness_total))
        keys[rng.random(keys.shape) < 0.2] = -1
        if int64:
            keys[:8] = 2**31 + rng.integers(0, 2**31, size=(8, g.hotness_total))
            keys[8, :] = 2**32 - 1
        keys = keys.astype(np.int64 if int64 else np.int32)
        jv, jo, jr = jec._slot_placement(jec._meta[g.name], jnp.asarray(keys.astype(np.int32)), 4)
        tv, to, tr = tec._slot_placement(g.name, torch.from_numpy(keys))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        valid = tv.numpy()
        np.testing.assert_array_equal(to.numpy()[valid], np.asarray(jo)[valid])
        np.testing.assert_array_equal(tr.numpy()[valid], np.asarray(jr)[valid])


def test_sharded_group_key_ratio_matches_jax(monkeypatch):
    """A model-parallel group over f shards asks f x the keys of the
    key-ratio rule; windowed groups turn it off (`_opt_knobs`)."""
    env = dict(fns.EC_ENV, HCTR_TPU_DENSE_KEY_RATIO="0.3")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jp = jplan.compile_plan(fns.ec_lookups(jplan, JComb), jplan.ShardingPlan(fns.EC_STRATEGY), 4)
    jec = JEC(jp, JaxResourceManager.create(num_devices=4), JOptParams(JOpt.RowWiseAdaGrad))
    tp = tplan.compile_plan(fns.ec_lookups(tplan, TComb), tplan.ShardingPlan(fns.EC_STRATEGY), 4,
                            onehot_vocab=128, split_vocab=4000)
    tec = TEC(tp, _rm(4), TOptParams(TOpt.RowWiseAdaGrad), dense_key_ratio=0.3)
    for g in tp.groups:
        if g.compute_kind == "rowop":
            assert tec._opt_knobs(g)["dense_ratio"] == pytest.approx(jec._opt_knobs(g.name)["dense_ratio"]), g.name


@pytest.fixture(scope="module")
def gloo2():
    x = np.arange(24, dtype=np.float32).reshape(8, 3) - 5.0
    return x, hybrid.run(fns.collectives, 2, {"x": x}, device="cpu")


@pytest.mark.parametrize("op", ["all_gather", "reduce_scatter", "all_reduce", "broadcast", "all_to_all"])
def test_collectives_over_gloo_match_numpy(gloo2, op):
    """Rank r holds rows [4r, 4r + 4) (all_gather) or the whole x times
    r + 1 (reduce_scatter, all_reduce, broadcast, all_to_all: rank r gets
    rows [4s, 4s + 4) of rank s's, in float32 and in bfloat16)."""
    x, ranks = gloo2
    for r, res in enumerate(ranks):
        assert res["backend"] == "gloo"
        if op == "all_gather":
            np.testing.assert_array_equal(res["all_gather_i64"], x.astype(np.int64))
            np.testing.assert_array_equal(res["all_gather_f32"], x)
        elif op == "reduce_scatter":
            np.testing.assert_array_equal(res["reduce_scatter"], 3 * x[4 * r : 4 * r + 4])
        elif op == "all_reduce":
            np.testing.assert_array_equal(res["all_reduce"], 3 * x)
        elif op == "all_to_all":
            want = np.concatenate([(s + 1) * x[4 * r : 4 * r + 4] for s in range(2)])
            np.testing.assert_array_equal(res["all_to_all"], want)
            np.testing.assert_array_equal(res["all_to_all_bf16"], want)  # small integers: exact in bf16
        else:
            np.testing.assert_array_equal(res["broadcast"], x)
        # the whole buffer each covers on the rank: the int64 and float32
        # gathers' outputs, one scatter's input, one reduce's and one
        # broadcast's tensor, the float32 and bfloat16 all-to-alls' inputs
        assert res["bytes"] == {"all_gather": x.size * 8 + x.nbytes, "reduce_scatter": x.nbytes,
                                "all_reduce": x.nbytes, "broadcast": x.nbytes, "all_to_all": x.nbytes * 3 // 2}


def test_collectives_are_identities_without_a_group():
    t = torch.arange(6.0).reshape(3, 2)
    assert mesh.group_size() == 1 and mesh.backend() is None
    for op in (mesh.all_gather, mesh.reduce_scatter, mesh.all_reduce, mesh.broadcast, mesh.all_to_all):
        assert op(t) is t
    np.testing.assert_array_equal(t.numpy(), np.arange(6.0).reshape(3, 2))
    assert set(mesh.COLLECTIVE_NAMES) == {"all_gather", "reduce_scatter", "all_reduce", "broadcast", "all_to_all"}


def test_resource_manager_without_a_group():
    rm = ResourceManager.create(device="cpu")
    assert (rm.num_devices, rm.data_parallel_size, rm.rank, rm.is_master_process()) == (1, 1, 0, True)
    assert ResourceManager.create(num_devices=1, device="cpu").num_devices == 1
    with pytest.raises(ValueError, match="process group has 1 rank"):
        ResourceManager.create(num_devices=2, device="cpu")
    a, b = rm.generator(5), rm.generator(5)
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))


def test_reader_blocks_are_rows_of_the_global_batch():
    spec = treader.BatchSpec(batch_size=12, label_dims=(1,), label_names=("label",), dense_dim=3,
                             dense_name="dense", sparse=(treader.SparseFeatureSpec("data0", (2, 1)),))
    vocabs = {"data0": [50, 7]}
    whole = iter(treader.SyntheticReader(spec, vocabs, num_batches=2, alpha=1.05, seed=3))
    blocks = [iter(treader.SyntheticReader(spec, vocabs, num_batches=2, alpha=1.05, seed=3, block=(r, 3)))
              for r in range(3)]
    for _ in range(3):  # across the epoch boundary
        b = next(whole)
        parts = [next(it) for it in blocks]
        for k in b:
            np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), b[k])


def _tiny(rm, **kw):
    return tflagship.build_tiny_dlrm(rm, batchsize=8, **kw)


def _weighted_plans_over_ranks():
    """`embedding_lookup(sp_weight_name=)` at 2 ranks: the plans of weighted
    Sum, Mean and Concat lookups (a split table with a superhot tier among
    them) equal the JAX package's, weights and merges included."""
    def lookups(pkg, comb):
        big = pkg.EmbeddingTableConfig("big", 400, 4)
        t = pkg.EmbeddingTableConfig("t", 10, 4)
        return [pkg.LookupConfig(0, big, "f0", "e0", comb.Mean, 3, sp_weight_name="w0"),
                pkg.LookupConfig(1, t, "f1", "e1", comb.Sum, 2, sp_weight_name="w1"),
                pkg.LookupConfig(2, t, "f2", "e2", comb.Concat, 2)]

    cfg = hugectr.EmbeddingCollectionConfig()
    cfg.embedding_lookup(hugectr.EmbeddingTableConfig("t", 10, 4), "d", "e", "sum", sp_weight_name="w")
    assert cfg.build_lookup_configs()[0].sp_weight_name == "w"
    env = {"HCTR_TPU_HOT_ROWS": "16", "HCTR_TPU_SUPERHOT_ROWS": "8", "HCTR_TPU_ONEHOT_VOCAB": "8",
           "HCTR_TPU_SPLIT_VOCAB": "0"}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        jp = jplan.compile_plan(lookups(jplan, JComb), jplan.ShardingPlan([]), 2)
    tp = tplan.compile_plan(lookups(tplan, TComb), tplan.ShardingPlan([]), 2, hot_rows=16, superhot_rows=8,
                            onehot_vocab=8, split_vocab=0)
    assert [(m.top_name, m.sp_weight_name) for m in tp.merges] == [(m.top_name, m.sp_weight_name) for m in jp.merges]
    for tg, jg in zip(tp.groups, jp.groups, strict=True):
        assert (tg.name, tg.has_weights, tg.num_shards) == (jg.name, jg.has_weights, jg.num_shards)
        assert [lm.sp_weight_name for lm in tg.lookups] == [lm.sp_weight_name for lm in jg.lookups]


def _upkeep_over_ranks(what):
    """`evict` / `grow_dynamic_capacity` on each of 2 ranks (no group: the
    dynamic tables' upkeep and a static table's eviction make no
    collective) from the blocks of the JAX package's 2-device storage after
    a step: each rank's storage, store and state equal JAX's block of the
    rank after the same call, bit for bit (the rows of keys; fresh rows
    start from each package's init)."""
    def lookups(pkg, comb):
        dyn = pkg.EmbeddingTableConfig("dyn", -1, 4, dynamic_capacity=16)
        st = pkg.EmbeddingTableConfig("st", 30, 4)
        out = [pkg.LookupConfig(0, dyn, "f0", "e0", comb.Sum, 2)]
        return out + ([pkg.LookupConfig(1, st, "f1", "e1", comb.Sum, 2)] if what == "eviction" else [])

    rng = np.random.default_rng(12)
    feats = {"f0": rng.integers(0, 60, (8, 2)).astype(np.int32), "f1": rng.integers(0, 30, (8, 2)).astype(np.int32)}
    d = {"e0": rng.normal(size=(8, 4)).astype(np.float32), "e1": rng.normal(size=(8, 4)).astype(np.float32)}
    if what != "eviction":
        feats, d = {"f0": feats["f0"]}, {"e0": d["e0"]}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in {"HCTR_TPU_ONEHOT_VOCAB": "0", "HCTR_TPU_DENSE_UPDATE_ROWS": "0"}.items():
            mp.setenv(k, v)
        jpl = jplan.compile_plan(lookups(jplan, JComb), jplan.ShardingPlan([]), 2)
        jec = JEC(jpl, JaxResourceManager.create(num_devices=2), JOptParams(JOpt.AdaGrad, lr=0.5))
        import jax

        jt = jec.init(jax.random.key(0))
        js = jec.init_optimizer(jt)
        jt, js = jax.jit(jec.backward_and_update)(jt, js, feats, d, jnp.asarray(0.5), jnp.asarray(1))
        g = jpl.groups[0]
        r_loc = g.total_local_rows
        block = lambda a, r: torch.from_numpy(np.array(a[r * r_loc:(r + 1) * r_loc]))  # noqa: E731
        ports = []
        for r in range(2):
            tec = TEC(tplan.compile_plan(lookups(tplan, TComb), tplan.ShardingPlan([]), 2, onehot_vocab=0),
                      _rm(2, r), TOptParams(TOpt.AdaGrad, lr=0.5))
            tt = {k: block(v, r) for k, v in jt.items()}
            ts = {gn: {k: block(v, r) for k, v in st.items()} for gn, st in js.items()}
            ports.append((tec, tt, ts))
        if what == "eviction":
            keys = np.concatenate([np.unique(feats["f0"])[:5], [777]])
            jt, js = jec.evict(jt, js, "dyn", keys)
            jt, js = jec.evict(jt, js, "st", np.array([0, 1, 2, 3, 29]))
            for tec, tt, ts in ports:
                tec.evict(tt, ts, "dyn", keys)
                tec.evict(tt, ts, "st", np.array([0, 1, 2, 3, 29]))
        else:
            jec, jt, js = jec.grow_dynamic_capacity(jt, js, "dyn", 64)
            ports = [tec.grow_dynamic_capacity(tt, ts, "dyn", 64) for tec, tt, ts in ports]
            g = jec.plan.groups[0]
            r_loc = g.total_local_rows
    for r, (tec, tt, ts) in enumerate(ports):
        assert tec.plan.groups[0].total_local_rows == r_loc
        ks = tt[f"{g.name}#keys"].numpy()
        np.testing.assert_array_equal(ks, block(jt[f"{g.name}#keys"], r).numpy())
        rows = torch.from_numpy(ks != 2**31 - 1) if what != "eviction" else slice(None)
        assert torch.equal(tt[g.name][rows], block(jt[g.name], r)[rows])
        for k, v in ts[g.name].items():
            assert torch.equal(v[rows], block(js[g.name][k], r)[rows])


# What raised over two ranks before the port had it: each is now held
# against the JAX package over two ranks
DEFERRED = {
    "weighted_lookup": _weighted_plans_over_ranks,
    "eviction": lambda: _upkeep_over_ranks("eviction"),
    "capacity_growth": lambda: _upkeep_over_ranks("capacity_growth"),
}


@pytest.mark.parametrize("what", list(DEFERRED))
def test_deferred_over_ranks_raise(what):
    """What raised over two ranks until it was ported, now held against the
    JAX package at 2 ranks: weighted lookups' plans, and each rank's
    eviction and capacity growth of its shard (the hierarchical mesh, its
    communication and the multi-host reader, which raised here before, are
    ported too: tests/test_torch_meshes.py)."""
    DEFERRED[what]()


def _model_of(**kw):
    """A Model of `CreateSolver(**kw)` on the CPU: its ResourceManager comes
    from the solver's mesh settings (model.py:162-166)."""
    return hugectr.Model(hugectr.CreateSolver(batchsize=64, **kw), None, hugectr.CreateOptimizer(), device="cpu")


# JAX `Solver` settings that the port cannot honour: the JAX package's own
# mesh errors (hugectr_tpu/core/mesh.py:70-88; over one rank the Model's
# ResourceManager raises them), num_devices other than the group's, and the
# one setting the port refuses on purpose, naming its ROADMAP queue
UNPORTED_SETTINGS = {
    "num_slices": (dict(num_slices=2), ValueError, "num_devices=1 not divisible by num_slices=2"),
    "ev_parallelism": (dict(ev_parallelism=2), ValueError, "num_devices=1 not divisible by ev_parallelism=2"),
    "both_meshes": (dict(num_slices=2, ev_parallelism=2), ValueError, "ev_parallelism and num_slices are exclusive"),
    "num_devices": (dict(num_devices=4), ValueError, "process group has 1 rank"),
    "segsum_scan_bf16": (dict(segsum_mode="scan", embedding_vec_dtype="bfloat16"), NotImplementedError,
                         "ROADMAP Queue 3"),
}
ACCEPTED_DEFAULTS = {"num_slices": dict(num_slices=1), "ev_parallelism": dict(ev_parallelism=1),
                     "both_meshes": dict(num_slices=1, ev_parallelism=1, group_rows=4096),
                     "num_devices": dict(num_devices=0),
                     "segsum_scan_bf16": dict(segsum_mode="scan", embedding_vec_dtype="float32")}


@pytest.mark.parametrize("setting", list(UNPORTED_SETTINGS))
def test_create_solver_refuses_unported_settings(setting):
    """`CreateSolver` (or the Model it configures, for a mesh that one rank
    cannot form) raises for a setting it cannot honour, where it used to
    drop it with a warning (ROADMAP Queue 3); at its default (and "scan"
    with float32 tables) the setting is accepted and the Model builds."""
    kw, err, match = UNPORTED_SETTINGS[setting]
    with pytest.raises(err, match=match):
        _model_of(**kw)
    assert _model_of(**ACCEPTED_DEFAULTS[setting]).solver.batchsize == 64


def test_create_solver_accepts_the_inert_fields_quietly(monkeypatch):
    """Every JAX `Solver` field that the JAX package never reads (or reads
    as an exact no-op) is accepted without a warning; the capacity factor,
    the unique-cap factor ("auto", or the JAX Solver's None for unset) and
    use_cuda_graph are fields; an unknown name keeps its warning."""
    import dataclasses as dc

    from hugectr_tpu.core.config import Solver as JSolver

    warned = []
    monkeypatch.setattr(hugectr, "get_logger", lambda: type("L", (), {"warning": warned.append})())
    jfields = {f.name: f.default if f.default is not dc.MISSING else f.default_factory() for f in dc.fields(JSolver)}
    inert = {k: jfields[k] for k in hugectr.INERT_SOLVER_FIELDS}
    s = hugectr.CreateSolver(mp_capacity_factor=1.5, num_devices=1, num_slices=1, ev_parallelism=1,
                             unique_cap_factor="auto", **inert)
    assert warned == [] and s.mp_capacity_factor == 1.5 and s.unique_cap_factor == "auto"
    assert "unique_cap_factor" not in hugectr.INERT_SOLVER_FIELDS
    # the port honours use_cuda_graph (the JAX Solver's default, True)
    assert "use_cuda_graph" not in hugectr.INERT_SOLVER_FIELDS and s.use_cuda_graph is jfields["use_cuda_graph"]
    assert hugectr.CreateSolver(use_cuda_graph=False).use_cuda_graph is False
    assert hugectr.CreateSolver(unique_cap_factor=None).unique_cap_factor == 0.0
    missing = {f.name for f in dc.fields(JSolver)} - {f.name for f in dc.fields(hugectr.Solver)}
    assert missing == set(hugectr.INERT_SOLVER_FIELDS) | {"num_devices"}
    hugectr.CreateSolver(no_such_setting=1)
    assert len(warned) == 1 and "no_such_setting" in warned[0]


def test_table_state_carries_between_placements():
    """`export_table_state` / `load_table_state` (carry by user table, in
    key order): a tiny partial-placement model's tables, sparse state and
    dense parameters land in another model bit for bit; at 4 ranks its
    groups differ from one card's, so the group-level carry refuses it."""
    from hugectr_tpu_torch.tools.carry import export_state, export_table_state, load_jax_state, load_table_state

    cpu = ResourceManager.create(device="cpu")
    a = tflagship.build_tiny_partial(cpu, seed=1)
    a.train()
    b = tflagship.build_tiny_partial(cpu, seed=2)
    load_table_state(b, export_table_state(a))
    sa, sb = export_state(a), export_state(b)
    for part in ("emb_tables", "eopt", "dense_params", "dopt"):
        assert repr(sorted(sa[part])) == repr(sorted(sb[part]))
    for g, arr in sa["emb_tables"].items():
        np.testing.assert_array_equal(sb["emb_tables"][g], arr)
        for k, v in sa["eopt"][g].items():
            np.testing.assert_array_equal(sb["eopt"][g][k], v)
    assert sb["step"] == sa["step"] == 1
    four = tflagship.build_tiny_partial(_rm(4))
    assert {g.name for g in four.ec.plan.groups} == {"mp_ev16_x2", "mp_ev16", "onehot_ev16", "mp_ev16_x1"}
    with pytest.raises(ValueError, match="carry it by table"):
        load_jax_state(four, sa, num_shards=1)


def test_dynamic_state_loads_at_its_own_rank_count():
    """A dynamic table's rows follow its hash over the shards: its state
    does not load at another rank count, and has no key order to carry by
    table."""
    from hugectr_tpu_torch.tools.carry import export_state, export_table_state, load_jax_state

    cpu = ResourceManager.create(device="cpu")
    m = tflagship.build_tiny_dlrm_ftrl(cpu, dynamic=True)
    state = export_state(m)
    load_jax_state(m, state)  # its own rank count
    with pytest.raises(ValueError, match="follow its hash"):
        load_jax_state(m, state, num_shards=2)
    with pytest.raises(ValueError, match="no key order"):
        export_table_state(m)


def test_two_rank_tiny_model_compiles_without_a_group():
    """The tiny model's layout at W = 2: the plan at 2 shards, each rank's
    storage its shard of a model-parallel group, the dense network and the
    metrics on the rank's half of the batch."""
    m = _tiny(_rm(2, rank=1), onehot_vocab=100)
    g = next(g for g in m.ec.plan.groups if g.is_model_parallel)
    assert g.num_shards == 2 and m.tables[g.name].shape[0] == g.total_local_rows
    assert m.eopt[g.name]["accum"].shape[0] == g.total_local_rows
    assert m.metrics.batch_size == 4 and m.train_reader.block == (1, 2)
    assert dataclasses.asdict(m.ec.plan.groups[-1])["num_shards"] == 1  # the one-hot group
