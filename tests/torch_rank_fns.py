"""Rank functions of the port's multi-rank tests, run by
`hugectr_tpu_torch.tools.hybrid.run` in spawned processes.

Each spawned rank imports this module, so it imports no JAX (the test files
that compare with the JAX package do). Inputs and results are numpy trees.
"""
import json
import os

import numpy as np
import torch

from hugectr_tpu_torch.core import mesh
from hugectr_tpu_torch.core.types import Combiner_t, Optimizer_t
from hugectr_tpu_torch.embedding.collection import EmbeddingCollection
from hugectr_tpu_torch.optim.params import OptParams
from hugectr_tpu_torch.parallel import plan as tplan
from hugectr_tpu_torch.tools import hybrid

# the collection of the multi-rank tests, ev 8: (table, vocab, feature, top,
# combiner, hotness). t0 and t1 take the one-hot engine (vocab <= 128); t2
# gets a storage group of its own (vocab >= 4,000) on the sorted route; t3
# and t5 (Sum, Mean and Concat lookups) share a model-parallel group on the
# dense sweep; t4 is
# data-parallel (a replicated rowop group, dense sweep)
EC_SPEC = [
    ("t0", 57, "f0", "e0", "sum", 3),
    ("t1", 100, "f1", "e1", "mean", 2),
    ("t2", 5000, "f2", "e2", "sum", 4),
    ("t3", 700, "f3", "e3", "mean", 2),
    ("t2", 5000, "f4", "e4", "sum", 1),
    ("t4", 300, "f5", "e5", "sum", 3),
    ("t5", 400, "f6", "e6", "sum", 3),
    ("t5", 400, "f7", "e7", "concat", 2),
]
EC_STRATEGY = [("dp", ["t4"]), ("mp", ["t0", "t1", "t2", "t3", "t5"])]
# engine settings, as Solver fields and as the JAX package's variables
EC_ENGINE = dict(onehot_vocab=128, split_vocab=4000, dense_update_rows=1000, dense_key_ratio=0.0)
EC_ENV = {"HCTR_TPU_ONEHOT_VOCAB": "128", "HCTR_TPU_SPLIT_VOCAB": "4000",
          "HCTR_TPU_DENSE_UPDATE_ROWS": "1000", "HCTR_TPU_DENSE_KEY_RATIO": "0",
          "HCTR_TPU_ONEHOT_KERNEL": "xla", "HCTR_TPU_HOT_ROWS": "0"}
# every term of FTRL counts; its threshold zeroes part of the rows
OPT_HYPER = dict(initial_accu_value=0.1, lambda1=0.01, lambda2=0.01, ftrl_beta=0.1)

# the other collections of the multi-rank tests, each a dict of: `spec`
# (rows as EC_SPEC's; a vocab -c makes a dynamic table of capacity c),
# `strategy`, `shard_counts`, the port's `engine` settings and the JAX
# package's `env`, the tables' and the state's `dtype`.
# * "split": bf16 tables and state; "big" (3,000 rows, Sum and Mean
#   lookups) split into a superhot tier [0, 64) in the one-hot group
#   beside "small", a hot tier [64, 256) sharing the dense sweep with
#   "mid", and a cold tier [256, 3,000) on the sorted route
#   (tests/test_torch_split.py's collection);
# * "dynamic": a dynamic table of 96 rows (Sum and Mean lookups, keys below
#   200, so the shards' stores fill and drop keys) beside a static one in
#   one model-parallel group, and a one-hot table;
# * "partial": tests/test_partial_placement.py:57's tables, t0 on 2 of the
#   ranks (replicas over 4) on the dense sweep, t1 on one (on every rank) on
#   the sorted route.
CASES = {
    "base": dict(spec=EC_SPEC, strategy=EC_STRATEGY, shard_counts=None, engine=EC_ENGINE, env=EC_ENV,
                 dtype="float32"),
    "split": dict(
        spec=[("big", 3000, "f0", "e0", "mean", 6), ("small", 57, "f1", "e1", "sum", 3),
              ("mid", 700, "f2", "e2", "sum", 2), ("big", 3000, "f3", "e3", "sum", 2)],
        strategy=[("mp", ["big", "small", "mid"])], shard_counts=None,
        engine=dict(onehot_vocab=128, split_vocab=1024, hot_rows=256, superhot_rows=64, dense_update_rows=1000,
                    dense_key_ratio=0.3),
        env={"HCTR_TPU_ONEHOT_VOCAB": "128", "HCTR_TPU_HOT_ROWS": "256", "HCTR_TPU_SUPERHOT_ROWS": "64",
             "HCTR_TPU_SPLIT_VOCAB": "1024", "HCTR_TPU_SEGSUM": "xla", "HCTR_TPU_UCAP_FACTOR": "0",
             "HCTR_TPU_DENSE_UPDATE_ROWS": "1000", "HCTR_TPU_DENSE_KEY_RATIO": "0.3",
             "HCTR_TPU_EMB_STATE_DTYPE": "bfloat16", "HCTR_TPU_ONEHOT_KERNEL": "xla"},
        dtype="bfloat16"),
    "dynamic": dict(
        spec=[("dyn", -96, "f0", "e0", "sum", 3), ("dyn", -96, "f1", "e1", "mean", 2),
              ("st", 50, "f2", "e2", "sum", 2), ("oh", 40, "f3", "e3", "sum", 2)],
        strategy=[("mp", ["dyn", "st", "oh"])], shard_counts=None,
        engine=dict(onehot_vocab=64, split_vocab=0, dense_update_rows=1000, dense_key_ratio=0.0),
        env={"HCTR_TPU_ONEHOT_VOCAB": "64", "HCTR_TPU_SPLIT_VOCAB": "0", "HCTR_TPU_DENSE_UPDATE_ROWS": "1000",
             "HCTR_TPU_DENSE_KEY_RATIO": "0", "HCTR_TPU_SEGSUM": "scan", "HCTR_TPU_ONEHOT_KERNEL": "xla",
             "HCTR_TPU_HOT_ROWS": "0"},
        dtype="float32"),
    "partial": dict(
        spec=[("t0", 96, "f0", "e0", "sum", 4), ("t1", 64, "f1", "e1", "mean", 3)],
        strategy=[("mp", ["t0", "t1"])], shard_counts={"t0": 2, "t1": 1},
        engine=dict(onehot_vocab=0, split_vocab=0, dense_update_rows=50, dense_key_ratio=0.0),
        env={"HCTR_TPU_ONEHOT_VOCAB": "0", "HCTR_TPU_SPLIT_VOCAB": "0", "HCTR_TPU_DENSE_UPDATE_ROWS": "50",
             "HCTR_TPU_DENSE_KEY_RATIO": "0", "HCTR_TPU_SEGSUM": "scan", "HCTR_TPU_HOT_ROWS": "0"},
        dtype="float32"),
}
# the sorted route of a dynamic group, and of W = 4's: no dense sweep
CASES["dynamic_sorted"] = dict(CASES["dynamic"], engine=dict(CASES["dynamic"]["engine"], dense_update_rows=0),
                               env=dict(CASES["dynamic"]["env"], HCTR_TPU_DENSE_UPDATE_ROWS="0"))


def _bf16(case):
    """A case with bf16 tables and state; JAX sums the sorted route's
    segments in float32 (HCTR_TPU_SEGSUM=xla), as the port does: its
    "scan" mode stores bf16 rows' segment sums in bf16."""
    env = dict(CASES[case]["env"], HCTR_TPU_EMB_STATE_DTYPE="bfloat16", HCTR_TPU_SEGSUM="xla")
    return dict(CASES[case], dtype="bfloat16", env=env)


# The exchanges over ranks (tests/test_torch_exchange.py), each package at
# its default forward (the owner-partitioned one) unless a case says:
# * "bf16_base", "bf16_partial", "bf16_dynamic": those cases with bf16
#   tables and state; "bf16_base_mp" with every table model-parallel (no
#   one-hot group);
# * "cap": the table of the JAX package's test_mp_capacity_slicing_matches_uncapped
#   (tests/test_embedding_collection.py:240-272) on the sorted route with
#   capacity factor 1.25, which cuts a sorted list of K keys at
#   ceil512(1.25 K / n) (n = W in the forward, f shards in the backward)
#   and drops nothing from uniform keys at W = 2; "cap_none" the same
#   without a factor; "cap_skew" (and "cap_skew_dense", on the dense sweep)
#   with even keys, which an even number of shards places on half of them,
#   so their lists overflow and drop keys ("cap_skew_none": no factor);
#   "cap_partial_skew" the table on 2 of 4 ranks at factor 1.0, where the
#   forward cuts at ceil512(K / 4) and the backward at ceil512(K / 2);
# * "dx": the concat tables of tests/test_dense_exchange.py:27-50 in one
#   model-parallel group, the unique-key dense exchange with lists of 64
#   rows ("dx64": no list overflows) or of 2 ("dx2": every step takes the
#   overflow branch).
CASES["bf16_base"] = _bf16("base")
CASES["bf16_base_mp"] = dict(CASES["bf16_base"], engine=dict(CASES["bf16_base"]["engine"], onehot_vocab=0),
                             env=dict(CASES["bf16_base"]["env"], HCTR_TPU_ONEHOT_VOCAB="0"))
CASES["bf16_partial"] = _bf16("partial")
CASES["bf16_dynamic"] = _bf16("dynamic")
_CAP_ENV = {"HCTR_TPU_ONEHOT_VOCAB": "0", "HCTR_TPU_SPLIT_VOCAB": "0", "HCTR_TPU_DENSE_UPDATE_ROWS": "0",
            "HCTR_TPU_DENSE_KEY_RATIO": "0", "HCTR_TPU_SEGSUM": "scan", "HCTR_TPU_HOT_ROWS": "0"}
CASES["cap_none"] = dict(spec=[("big", 4096, "f0", "e0", "sum", 4)], strategy=[("mp", ["big"])], shard_counts=None,
                         engine=dict(onehot_vocab=0, split_vocab=0, dense_update_rows=0, dense_key_ratio=0.0),
                         env=_CAP_ENV, dtype="float32", batch=512)
CASES["cap"] = dict(CASES["cap_none"], engine=dict(CASES["cap_none"]["engine"], capacity_factor=1.25),
                    env=dict(_CAP_ENV, HCTR_TPU_MP_CAPACITY_FACTOR="1.25"))
CASES["cap_skew"] = dict(CASES["cap"], skew=True)
CASES["cap_skew_dense"] = dict(CASES["cap_skew"], engine=dict(CASES["cap"]["engine"], dense_update_rows=4096),
                               env=dict(CASES["cap"]["env"], HCTR_TPU_DENSE_UPDATE_ROWS="4096"))
CASES["cap_skew_none"] = dict(CASES["cap_none"], skew=True)
CASES["cap_partial_skew"] = dict(CASES["cap_skew"], shard_counts={"big": 2},
                                 engine=dict(CASES["cap"]["engine"], capacity_factor=1.0),
                                 env=dict(_CAP_ENV, HCTR_TPU_MP_CAPACITY_FACTOR="1.0"))
_DX_ENV = {"HCTR_TPU_ONEHOT_VOCAB": "0", "HCTR_TPU_SPLIT_VOCAB": "0", "HCTR_TPU_DENSE_UPDATE_ROWS": "1000",
           "HCTR_TPU_DENSE_KEY_RATIO": "0", "HCTR_TPU_HOT_ROWS": "0"}
for _cap in (64, 2):
    CASES[f"dx{_cap}"] = dict(
        spec=[("t0", 96, "f0", "e0", "concat", 4), ("t1", 64, "f1", "e1", "concat", 3),
              ("t0", 96, "f2", "e2", "concat", 2)],
        strategy=[("mp", ["t0", "t1"])], shard_counts=None,
        engine=dict(onehot_vocab=0, split_vocab=0, dense_update_rows=1000, dense_key_ratio=0.0,
                    dense_exchange_cap=_cap),
        env=dict(_DX_ENV, HCTR_TPU_DENSE_EXCHANGE_CAP=str(_cap)), dtype="float32", batch=32)
# Weighted lookups (tests/test_torch_weighted.py): a spec row's seventh
# entry names its per-key weight feature. "weighted": the lookups of the JAX
# package's tests/test_weighted_lookup.py:24-34 (weighted Sum, Mean and
# Concat lookups beside an unweighted Sum one), every table model-parallel
# on the sorted route, so that W = 2 takes the owner-partitioned forward with
# the weights riding its sort; "weighted_bf16" with bf16 tables and state;
# "weighted_onehot" with t0 and t1 in the replicated one-hot group;
# "weighted_dx64": weighted Concat lookups on the unique-key dense exchange.
_W_SPEC = [("t0", 100, "f0", "e0", "sum", 4, "w0"), ("t1", 57, "f1", "e1", "mean", 3, "w1"),
           ("t0", 100, "f2", "e2", "sum", 2), ("t2", 31, "f3", "e3", "concat", 2, "w3")]
_W_ENV = {"HCTR_TPU_ONEHOT_VOCAB": "0", "HCTR_TPU_SPLIT_VOCAB": "0", "HCTR_TPU_DENSE_UPDATE_ROWS": "0",
          "HCTR_TPU_DENSE_KEY_RATIO": "0", "HCTR_TPU_SEGSUM": "xla", "HCTR_TPU_HOT_ROWS": "0",
          "HCTR_TPU_ONEHOT_KERNEL": "xla"}
CASES["weighted"] = dict(spec=_W_SPEC, strategy=[("mp", ["t0", "t1", "t2"])], shard_counts=None,
                         engine=dict(onehot_vocab=0, split_vocab=0, dense_update_rows=0, dense_key_ratio=0.0),
                         env=_W_ENV, dtype="float32", batch=32, seed=53)
CASES["weighted_bf16"] = dict(CASES["weighted"], dtype="bfloat16",
                              env=dict(_W_ENV, HCTR_TPU_EMB_STATE_DTYPE="bfloat16"))
CASES["weighted_onehot"] = dict(CASES["weighted"], engine=dict(CASES["weighted"]["engine"], onehot_vocab=128),
                                env=dict(_W_ENV, HCTR_TPU_ONEHOT_VOCAB="128"))
CASES["weighted_dx64"] = dict(
    spec=[("t0", 96, "f0", "e0", "concat", 4, "w0"), ("t1", 64, "f1", "e1", "concat", 3, "w1"),
          ("t0", 96, "f2", "e2", "concat", 2)],
    strategy=[("mp", ["t0", "t1"])], shard_counts=None,
    engine=dict(onehot_vocab=0, split_vocab=0, dense_update_rows=1000, dense_key_ratio=0.0, dense_exchange_cap=64),
    env=dict(_DX_ENV, HCTR_TPU_DENSE_EXCHANGE_CAP="64"), dtype="float32", batch=32, seed=59)
# the settings of the exchanges, as `EmbeddingCollection` takes them
EXCHANGE_SETTINGS = ("fwd_partition", "capacity_factor", "dense_exchange_cap")


def ec_lookups(pkg, comb, case="base"):
    """The collection's lookups in `pkg` (either package's plan module)."""
    tables = {}
    out = []
    for i, (t, v, f, top, c, h, *w) in enumerate(CASES[case]["spec"]):
        cfg = pkg.EmbeddingTableConfig(t, v, 8) if v > 0 else pkg.EmbeddingTableConfig(t, -1, 8, dynamic_capacity=-v)
        tables.setdefault(t, cfg)
        out.append(pkg.LookupConfig(i, tables[t], f, top, comb(c), h, sp_weight_name=w[0] if w else ""))
    return out


def ec_weights(b: int, case: str):
    """The per-key weights of a case's weighted lookups: signed normal
    weights, a Mean lookup's positive, its sample 1 all 0 (the zero-sum
    guard), from a stream of their own, so the other inputs stay as they
    were."""
    rng = np.random.default_rng(CASES[case].get("seed", 0) + 101)
    out = {}
    for _t, _v, _f, _top, c, h, *w in CASES[case]["spec"]:
        if not w:
            continue
        if c == "mean":
            out[w[0]] = (rng.random((b, h)) + 0.1).astype(np.float32)
            out[w[0]][1] = 0.0
        else:
            out[w[0]] = rng.normal(size=(b, h)).astype(np.float32)
    return out


def ec_keys(rng, b, case="base"):
    """Every lookup's [B, h] keys: -1 padding, negative keys and keys >= V
    beside valid ones (a dynamic table's keys below twice its capacity);
    sample 0 all padding."""
    feats = {}
    for _t, v, f, _top, _c, h, *_w in CASES[case]["spec"]:
        if v < 0:
            k = rng.integers(0, -2 * v, size=(b, h)).astype(np.int32)
            k[rng.random((b, h)) < 0.15] = -1
            k[0] = -1
            feats[f] = k
            continue
        k = rng.integers(0, v, size=(b, h)).astype(np.int32)
        if CASES[case].get("skew"):
            k = 2 * rng.integers(0, v // 2, size=(b, h)).astype(np.int32)
        r = rng.random((b, h))
        k[r < 0.15] = -1
        k[(r >= 0.15) & (r < 0.22)] = -rng.integers(2, 3 * v, size=int(((r >= 0.15) & (r < 0.22)).sum()))
        k[(r >= 0.22) & (r < 0.3)] += v
        if case == "split":  # keys of the superhot and hot tiers' windows
            low = (r >= 0.3) & (r < 0.55)
            k[low] = rng.integers(0, 300, size=int(low.sum()))
        k[0] = -1
        feats[f] = k
    return feats


def ec_inputs(optimizer, b, steps, lr, case="base", **layout):
    """Inputs of `collection_steps`: the static tables, a global batch of
    `b` keys and each step's cotangents, made from a seed of the optimizer
    and the case; `layout` may give the ranks' `mesh` ({"num_slices": d}
    or {"ev_parallelism": e}) and the collection's `comm` strategy."""
    seed = CASES[case].get("seed", {"base": 0, "split": 31, "dynamic": 37, "dynamic_sorted": 41,
                                    "partial": 43}.get(case, 47))
    rng = np.random.default_rng(seed + (23 if optimizer == "ftrl" else 29))
    spec = CASES[case]["spec"]
    tables = {t: (rng.normal(size=(v, 8)) * 0.1).astype(np.float32) for t, v, *_ in spec if v > 0}
    # a Concat lookup's output holds one ev-wide column block per slot
    d = {str(s): {top: rng.normal(size=(b, 8 * (h if c == "concat" else 1))).astype(np.float32)
                  for _t, _v, _f, top, c, h, *_w in spec}
         for s in range(1, steps + 1)}
    cfg = dict(optimizer=optimizer, steps=steps, lr=lr, case=case, **layout)
    out = {"config": json.dumps(cfg), "tables": tables, "keys": ec_keys(rng, b, case), "d": d}
    weights = ec_weights(b, case)
    if weights:
        out["w"] = weights
    return out


def block(arr: np.ndarray, rank: int, world: int) -> np.ndarray:
    n = arr.shape[0] // world
    return arr[rank * n : (rank + 1) * n]


def collectives(rm, inputs):
    """all_gather, reduce_scatter, all_reduce and broadcast of this rank's
    rows of inputs["x"] (int64 and float32); all_to_all of inputs["x"]
    times r + 1 (float32 and bfloat16)."""
    x = block(inputs["x"], rm.rank, rm.num_devices)
    out = {}
    for name, t in (("i64", torch.from_numpy(x.astype(np.int64))), ("f32", torch.from_numpy(x))):
        out[f"all_gather_{name}"] = mesh.all_gather(t).numpy()
    out["reduce_scatter"] = mesh.reduce_scatter(torch.from_numpy(inputs["x"] * (rm.rank + 1))).numpy()
    out["all_reduce"] = mesh.all_reduce(torch.from_numpy(inputs["x"] * (rm.rank + 1))).numpy()
    out["broadcast"] = mesh.broadcast(torch.from_numpy(inputs["x"] * (rm.rank + 1))).numpy()
    mine = torch.from_numpy(inputs["x"] * (rm.rank + 1))
    out["all_to_all"] = mesh.all_to_all(mine).numpy()
    out["all_to_all_bf16"] = mesh.all_to_all(mine.to(torch.bfloat16)).float().numpy()
    out["backend"] = mesh.backend()
    out["bytes"] = dict(mesh.COLLECTIVE_BYTES)
    return out


def collection_steps(rm, inputs):
    """A collection of `CASES` (inputs["config"]["case"]) over the group:
    dynamic groups' storage zeroed, the static tables imported from
    inputs["tables"], then per step the forward of this rank's block of the
    global batch inputs["keys"][f] and the fused update with its block of
    inputs["d"][step][top]. Returns each step's outputs, every static table
    in key order, this rank's storage (key stores too) and state, and the
    routes."""
    cfg = json.loads(inputs["config"])
    case = CASES[cfg.get("case", "base")]
    eng = case["engine"]
    rm = mesh.ResourceManager.create(device=rm.device, **cfg.get("mesh", {}))
    plan = tplan.compile_plan(
        ec_lookups(tplan, Combiner_t, cfg.get("case", "base")), tplan.ShardingPlan(case["strategy"]),
        rm.data_parallel_size, case["shard_counts"], onehot_vocab=eng["onehot_vocab"],
        split_vocab=eng["split_vocab"], hot_rows=eng.get("hot_rows", 0), superhot_rows=eng.get("superhot_rows", 0),
    )
    opt = OptParams(Optimizer_t(cfg["optimizer"]), **OPT_HYPER)
    dt = getattr(torch, case["dtype"])
    ec = EmbeddingCollection(plan, rm, opt, dtype=dt, state_dtype=dt, dense_update_rows=eng["dense_update_rows"],
                             dense_key_ratio=eng["dense_key_ratio"], comm_strategy=cfg.get("comm", "uniform"),
                             **{k: v for k, v in eng.items() if k in EXCHANGE_SETTINGS})
    tables = ec.init(rm.generator(0))
    for g in plan.groups:
        if g.slot_is_dynamic.any():
            tables[g.name].zero_()  # a fresh row's value depends on the layout
    for name, values in inputs.get("tables", {}).items():
        ec.import_table(tables, name, values)
    state = ec.init_optimizer(tables)
    w, r = rm.data_parallel_size, rm.data_index
    feats = {f: torch.from_numpy(block(k, r, w)).to(rm.device) for f, k in inputs["keys"].items()}
    fw = {n: torch.from_numpy(block(x, r, w)).to(rm.device) for n, x in inputs["w"].items()} if "w" in inputs else None
    out = {"fwd": {}}
    mesh.COLLECTIVE_CALLS.clear()
    mesh.COLLECTIVE_BYTES.clear()
    for step in range(1, cfg["steps"] + 1):
        outs = ec.forward(tables, feats, fw)
        out["fwd"][str(step)] = {k: v.float().cpu().numpy() for k, v in outs.items()}
        d = {k: torch.from_numpy(block(v, r, w)).to(rm.device, dt) for k, v in inputs["d"][str(step)].items()}
        ec.backward_and_update(tables, state, feats, d, torch.tensor(cfg["lr"]), step, fw)
    out["tables"] = {t: ec.export_table(tables, t) for t in sorted(inputs.get("tables", {}))}
    out["storage"] = {g: (t.float() if t.is_floating_point() else t).cpu().numpy() for g, t in tables.items()}
    out["state"] = {g: {k: t.float().cpu().numpy() for k, t in st.items()} for g, st in state.items()}
    out["routes"] = dict(ec.group_routes)
    out["collective_calls"] = dict(mesh.COLLECTIVE_CALLS)
    out["collective_bytes"] = dict(mesh.COLLECTIVE_BYTES)
    return out


def collection_cases(rm, inputs):
    """`collection_steps` of each case in `inputs`, by name."""
    return {name: collection_steps(rm, i) for name, i in inputs.items()}


def bf16_sum(rm, inputs):
    """`mesh.all_reduce` of this rank's row of inputs["x"] in bfloat16, and
    its `mesh.reduce_scatter` (rank r keeps column r)."""
    x = torch.from_numpy(inputs["x"][rm.rank]).to(torch.bfloat16)
    scattered = mesh.reduce_scatter(x.clone())
    return {"y": mesh.all_reduce(x).float().numpy(), "scattered": scattered.float().numpy()}


def several(rm, inputs):
    """Several rank functions in one group: inputs["calls"] (JSON) maps a
    key to a function of this module, `hybrid.train_model` or
    `hybrid.snapshot_round_trip`; each gets inputs[key] and its result goes
    under key."""
    calls = json.loads(inputs["calls"])
    fns = dict(collection_cases=collection_cases, bf16_sum=bf16_sum, train_model=hybrid.train_model,
               snapshot_round_trip=hybrid.snapshot_round_trip, replay_counts=replay_counts)
    return {key: fns[name](rm, inputs[key]) for key, name in calls.items()}


def sok_ranks(rm, inputs):
    """tests/test_torch_sok.py's ranks: a weighted `sok.LookupEngine` (tables
    a and b, Sum and Mean) with the tables of inputs, this rank's block of
    the keys looked up with their weights and one `OptimizerWrapper` update
    (rowwise AdaGrad) from its block of the cotangents; the tables in key
    order, then `sok.dump` to inputs["path"] (rank 0 writes); a dynamic
    variable updated from the rank's keys of k0, and its `size` over the
    ranks beside the batch's distinct keys."""
    from hugectr_tpu_torch import sok
    from hugectr_tpu_torch.parallel.plan import EmbeddingTableConfig

    settings = dict(onehot_vocab=0, dense_update_rows=0, dense_key_ratio=0.0)
    sok.init(rm)
    eng = sok.LookupEngine([EmbeddingTableConfig("a", 100, 8), EmbeddingTableConfig("b", 50, 8)], hotness=[3, 2],
                           combiners=["sum", "mean"], opt=OptParams(Optimizer_t.RowWiseAdaGrad, lr=0.1),
                           use_sp_weight=True, **settings)
    tables = eng.init(0)
    for name, values in inputs["tables"].items():
        eng.ec.import_table(tables, name, values)
    w, r = rm.data_parallel_size, rm.data_index
    keys = [block(inputs["k0"], r, w), block(inputs["k1"], r, w)]
    ws = [block(inputs["w0"], r, w), block(inputs["w1"], r, w)]
    ds = [block(inputs["d0"], r, w), block(inputs["d1"], r, w)]
    outs = sok.lookup_sparse(eng, tables, keys, sp_weights=ws)
    wrapper = sok.OptimizerWrapper(eng)
    wrapper.apply_gradients(tables, wrapper.initialize(tables), keys, ds, 0.1, 1, sp_weights=ws)
    out = {"out": {str(i): o.numpy() for i, o in enumerate(outs)},
           "tables": {n: eng.ec.export_table(tables, n) for n in ("a", "b")}}
    sok.dump(bytes(inputs["path"]).decode(), eng, tables)
    dv = sok.DynamicVariable(dimension=8, initial_capacity=256, max_hotness=3, **settings)
    dv.apply_gradients(keys[0], ds[0], lr=0.1)
    k0 = inputs["k0"]
    out["size"] = dv.size
    out["global_keys"] = int(np.unique(k0[k0 >= 0]).size)
    return out


# the tiny graph of tests/test_torch_graph_layers.py: the dense input read
# as GRU_SEQ steps of GRU_V features by a GRU, concatenated with a two-slot
# embedding, BatchNorm, a GELU MLP, a Gather that permutes the global batch,
# an InnerProduct logit and BCE with a regularizer
GRAPH_B = 16
GRU_SEQ, GRU_V, GRU_H = 4, 3, 6
GATHER = [3, 1, 0, 2, 11, 6, 4, 5, 15, 8, 9, 14, 12, 7, 13, 10]


def graph_layers_model(pkg, rm, reg="l2", lam=0.01, port_engine=None):
    """The tiny graph in `pkg` (hugectr_tpu or hugectr_tpu_torch): dense
    AdaGrad and sparse AdaGrad, synthetic batches of GRAPH_B rows;
    `port_engine` holds the port's engine fields (the JAX package reads
    its environment)."""
    L = pkg.Layer_t
    solver = pkg.CreateSolver(max_eval_batches=2, batchsize_eval=GRAPH_B, batchsize=GRAPH_B, lr=0.05,
                              repeat_dataset=True, **(port_engine or {}))
    reader = pkg.DataReaderParams(data_reader_type=pkg.DataReaderType_t.Synthetic, synthetic_num_batches=4)
    model = pkg.Model(solver, reader, pkg.CreateOptimizer(optimizer_type=pkg.Optimizer_t.AdaGrad),
                      resource_manager=rm)
    model.add(pkg.Input(label_dim=1, label_name="label", dense_dim=GRU_SEQ * GRU_V, dense_name="dense",
                        data_reader_sparse_param_array=[pkg.DataReaderSparseParam("d0", 1, True, 2)]))
    ebc = pkg.EmbeddingCollectionConfig()
    ebc.embedding_lookup([pkg.EmbeddingTableConfig(name="t0", max_vocabulary_size=50, ev_size=8)], ["d0"], "emb",
                         ["sum"])
    ebc.shard(shard_matrix=[["t0"]] * rm.num_devices, shard_strategy=[("mp", ["t0"])])
    model.add(ebc)
    DL = pkg.DenseLayer
    model.add(DL(layer_type=L.GRU, bottom_names=["dense"], top_names=["gru"], num_output=GRU_H,
                 SeqLength=GRU_SEQ, vector_size=GRU_V))
    model.add(DL(layer_type=L.Concat, bottom_names=["gru", "emb"], top_names=["c"]))
    model.add(DL(layer_type=L.BatchNorm, bottom_names=["c"], top_names=["bn"], factor=0.3))
    model.add(DL(layer_type=L.MLP, bottom_names=["bn"], top_names=["m"], num_outputs=[8],
                 act_type=pkg.Activation_t.Gelu))
    model.add(DL(layer_type=L.Gather, bottom_names=["m"], top_names=["g"], indices=GATHER))
    model.add(DL(layer_type=L.InnerProduct, bottom_names=["g"], top_names=["logit"], num_output=1))
    model.add(DL(layer_type=L.BinaryCrossEntropyLoss, bottom_names=["logit", "label"], top_names=["loss"],
                 use_regularizer=reg != "none", regularizer_type=reg, lambda_=lam))
    model.compile()
    return model


GRAPH_ENGINE = dict(onehot_vocab=0, dense_update_rows=0, dense_key_ratio=0.0, hot_rows=0)


def graph_layers_ranks(rm, inputs):
    """The tiny graph at W ranks from the JAX model's carried state
    (`inputs["state"]`, global arrays): three steps' losses, then the dense
    parameters, their state and the BatchNorm statistics, and this rank's
    rows of the table."""
    import hugectr_tpu_torch as pkg
    from hugectr_tpu_torch.tools.carry import load_jax_state

    rm = mesh.ResourceManager.create(device=rm.device)
    model = graph_layers_model(pkg, rm, reg=str(inputs["reg"]), port_engine=GRAPH_ENGINE)
    load_jax_state(model, inputs["state"])
    losses = [model.train() for _ in range(3)]
    out = {"losses": np.asarray(losses)}
    for layer, ps in model.network.param_tree().items():
        for k, p in ps.items():
            out[f"dense:{layer}.{k}"] = p.detach().numpy()
    for kind, tree in model.dopt.items():
        for layer, ps in tree.items():
            for k, t in ps.items():
                out[f"dopt:{kind}.{layer}.{k}"] = t.numpy()
    for layer, st in model.network.state_tree().items():
        for k, t in st.items():
            out[f"net_state:{layer}.{k}"] = t.numpy()
    for g, t in model.tables.items():
        out[f"table:{g}"] = t.numpy()
    return out


# ---------------------------------------- the captured step's body over ranks
# tests/test_torch_graph_ranks.py: what a captured W-rank step runs, on the
# CPU, under tests/test_torch_graph_step.py's `_Refuse`, the dispatch mode
# that raises where the step would read the card on the host or size a
# result by the data
REFUSED_CALLS: dict = {}


def _refusing(cls, name):
    from test_torch_graph_step import _Refuse  # imports no JAX

    fn = getattr(cls, name)

    def wrapped(*args, **kwargs):
        REFUSED_CALLS[name] = REFUSED_CALLS.get(name, 0) + 1
        with _Refuse():
            return fn(*args, **kwargs)

    setattr(cls, name, wrapped)


def refused_ranks(rm, inputs):
    """`several`, with what a captured step runs under `_Refuse`: the
    model's step body and eval forward (`Model._train_body`,
    `Model._eval_step`) and the collection's passes (`forward`,
    `backward_and_update`). Adds each one's calls under "refused"."""
    from hugectr_tpu_torch.model.model import Model

    for cls, names in ((Model, ("_train_body", "_eval_step")),
                       (EmbeddingCollection, ("forward", "backward_and_update"))):
        for name in names:
            _refusing(cls, name)
    out = several(rm, inputs)
    out["refused"] = dict(REFUSED_CALLS)
    return out


class _Graph:
    """A stand-in for `torch.cuda.CUDAGraph` on the CPU: the capture runs the
    step once, as a capture records it, and a replay runs nothing."""

    def replay(self):
        pass


def replay_counts(rm, inputs):
    """The collectives' calls and bytes a replay adds, against the eager
    step's, on the tiny model over the ranks (`Model._replay` with the CUDA
    graph stood in for on the CPU): (the eager step's, the first replay's,
    which captures, and three more replays')."""
    import contextlib

    from hugectr_tpu_torch.tools import flagship

    torch.cuda.CUDAGraph = _Graph
    torch.cuda.graph = lambda *a, **k: contextlib.nullcontext()
    torch.cuda.graph_pool_handle = lambda: None
    model = flagship.build_tiny_dlrm(rm, batchsize=64)
    model.start_data_reading()
    batch = model._next_train_batch()
    out = {}
    for what, run, n in (("eager", model._train_body, 1), ("capture", None, 1), ("replays", None, 3)):
        mesh.COLLECTIVE_CALLS.clear()
        mesh.COLLECTIVE_BYTES.clear()
        for _ in range(n):
            if run is not None:
                run(batch)
            else:
                model._replay("train", model._train_body, batch)
        out[what] = {"calls": dict(mesh.COLLECTIVE_CALLS), "bytes": dict(mesh.COLLECTIVE_BYTES)}
    out["captures"] = model._captures
    return out


# the tiny DLRM-DCNv2 of the parity checks (`hybrid.TINY_PARITY`)
TINY_KW = dict(batchsize=64, onehot_vocab=100, dense_update_rows=0, dense_key_ratio=0.0)


def _dx_collection(rm, inputs, cap):
    """CASES["dx64"]'s collection (AdaGrad, the dense sweep) with lists of
    `cap` rows, the tables of `inputs` imported: (collection, tables,
    state)."""
    case = CASES["dx64"]
    eng = dict(case["engine"], dense_exchange_cap=cap)
    plan = tplan.compile_plan(ec_lookups(tplan, Combiner_t, "dx64"), tplan.ShardingPlan(case["strategy"]),
                              rm.data_parallel_size, onehot_vocab=0, split_vocab=0)
    ec = EmbeddingCollection(plan, rm, OptParams(Optimizer_t.AdaGrad, **OPT_HYPER), dense_update_rows=1000,
                             dense_key_ratio=0.0, dense_exchange_cap=cap)
    tables = ec.init(rm.generator(0))
    for name, values in inputs["tables"].items():
        ec.import_table(tables, name, values)
    return ec, tables, ec.init_optimizer(tables)


def captured_ranks(rm, inputs):
    """The card tests of the captured step over NCCL ranks
    (tests/test_torch_gpu.py), in one group:

    * "ab": the tiny model trained 2 steps, then `tools/graph_ab.py::run`
      (eager against captured from one state, in turns), as JSON;
    * "dx": the dense exchange's passes captured once on a batch whose
      lists fit (keys folded into a few rows) and replayed on one whose
      lists overflow, against the same two steps eager from the same
      tables: each step's overflow flag, outputs and the tables after;
    * "load": the tiny model captured, a snapshot written at step 2 under
      inputs["path"], 3 replayed steps on fixed batches, the snapshot
      loaded and the same 3 batches replayed again, then `_build_steps`
      (every rank drops its graphs), the snapshot loaded and the 3 batches
      again, captured anew: the losses of each pass and the captures
      made."""
    from hugectr_tpu_torch.tools import flagship, graph_ab

    out = {}
    model = flagship.build_tiny_dlrm(rm, **TINY_KW)
    for _ in range(2):
        model.train()
    out["ab"] = json.dumps(graph_ab.run(model, "tiny_ranks"))

    # the dense exchange: one capture, its branch taken by the data
    w, r = rm.data_parallel_size, rm.data_index
    cap = int(inputs["dx_cap"])
    keys = {f: block(k, r, w) for f, k in inputs["dx"]["keys"].items()}
    batches = [{f: torch.from_numpy(np.where(k != -1, np.abs(k) % 3, -1)).to(rm.device) for f, k in keys.items()},
               {f: torch.from_numpy(k).to(rm.device) for f, k in keys.items()}]
    d = {k: torch.from_numpy(block(v, r, w)).to(rm.device) for k, v in inputs["dx"]["d"]["1"].items()}
    lr = torch.tensor(0.3, device=rm.device)
    res = {}
    for mode in ("eager", "graph"):
        ec, tables, state = _dx_collection(rm, inputs["dx"], cap)

        def step(feats):
            outs = ec.forward(tables, feats)
            ec.backward_and_update(tables, state, feats, d, lr, 1)
            return outs

        if mode == "eager":
            outs = [step(b) for b in batches]
            g = ec.plan.groups[0]
            res["over"] = np.asarray([bool(ec._dense_lists(g.name, ec._all_gather(ec._group_keys(g, b)))[1])
                                      for b in batches])
        else:
            kept = [t.clone() for t in (*tables.values(), *(a for st in state.values() for a in st.values()))]
            step(batches[0])  # warm-up, eager, on a state then put back
            for t, k in zip((*tables.values(), *(a for st in state.values() for a in st.values())), kept):
                t.copy_(k)
            static = {f: t.clone() for f, t in batches[0].items()}
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = step(static)
            outs = []
            for b in batches:
                for f, t in static.items():
                    t.copy_(b[f])
                graph.replay()
                outs.append({k: v.clone() for k, v in captured.items()})
        res[mode] = {"fwd": {str(i): {k: v.float().cpu().numpy() for k, v in o.items()} for i, o in enumerate(outs)},
                     "tables": {t: ec.export_table(tables, t) for t in sorted(inputs["dx"]["tables"])}}
    out["dx"] = res

    # a snapshot loaded between replays, then every rank's graphs dropped
    model = flagship.build_tiny_dlrm(rm, **TINY_KW)
    model.start_data_reading()
    fixed = [model._next_train_batch() for _ in range(3)]

    def three():
        losses = []
        for b in fixed:
            model._staged_train_batch = b
            losses.append(float(model.train_async()))
        return np.asarray(losses)

    model.train()
    model.train()
    prefix = os.path.join(bytes(inputs["path"]).decode(), "snap")
    model.save_params_to_files(prefix, 2)  # rank 0 writes, every rank returns once it is written
    first = three()
    model.load_params_from_files(f"{prefix}_iter2")
    again = three()
    model._build_steps()
    model.load_params_from_files(f"{prefix}_iter2")
    rebuilt = three()
    out["load"] = {"first": first, "again": again, "rebuilt": rebuilt, "captures": model._captures,
                   "step_mode": model.step_mode}
    return out
