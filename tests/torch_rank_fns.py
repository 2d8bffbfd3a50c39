"""Rank functions of the port's multi-rank tests, run by
`hugectr_tpu_torch.tools.hybrid.run` in spawned processes.

Each spawned rank imports this module, so it imports no JAX (the test files
that compare with the JAX package do). Inputs and results are numpy trees.
"""
import json

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
#   one-hot group, whose bf16 gradient sum over W > 2 ranks rounds
#   otherwise than JAX's psum: tests/test_torch_exchange.py);
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
# the settings of the exchanges, as `EmbeddingCollection` takes them
EXCHANGE_SETTINGS = ("fwd_partition", "capacity_factor", "dense_exchange_cap")


def ec_lookups(pkg, comb, case="base"):
    """The collection's lookups in `pkg` (either package's plan module)."""
    tables = {}
    out = []
    for i, (t, v, f, top, c, h) in enumerate(CASES[case]["spec"]):
        cfg = pkg.EmbeddingTableConfig(t, v, 8) if v > 0 else pkg.EmbeddingTableConfig(t, -1, 8, dynamic_capacity=-v)
        tables.setdefault(t, cfg)
        out.append(pkg.LookupConfig(i, tables[t], f, top, comb(c), h))
    return out


def ec_keys(rng, b, case="base"):
    """Every lookup's [B, h] keys: -1 padding, negative keys and keys >= V
    beside valid ones (a dynamic table's keys below twice its capacity);
    sample 0 all padding."""
    feats = {}
    for _t, v, f, _top, _c, h in CASES[case]["spec"]:
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


def ec_inputs(optimizer, b, steps, lr, case="base"):
    """Inputs of `collection_steps`: the static tables, a global batch of
    `b` keys and each step's cotangents, made from a seed of the optimizer
    and the case."""
    seed = CASES[case].get("seed", {"base": 0, "split": 31, "dynamic": 37, "dynamic_sorted": 41,
                                    "partial": 43}.get(case, 47))
    rng = np.random.default_rng(seed + (23 if optimizer == "ftrl" else 29))
    spec = CASES[case]["spec"]
    tables = {t: (rng.normal(size=(v, 8)) * 0.1).astype(np.float32) for t, v, *_ in spec if v > 0}
    # a Concat lookup's output holds one ev-wide column block per slot
    d = {str(s): {top: rng.normal(size=(b, 8 * (h if c == "concat" else 1))).astype(np.float32)
                  for _t, _v, _f, top, c, h in spec}
         for s in range(1, steps + 1)}
    cfg = dict(optimizer=optimizer, steps=steps, lr=lr, case=case)
    return {"config": json.dumps(cfg), "tables": tables, "keys": ec_keys(rng, b, case), "d": d}


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
    plan = tplan.compile_plan(
        ec_lookups(tplan, Combiner_t, cfg.get("case", "base")), tplan.ShardingPlan(case["strategy"]),
        rm.num_devices, case["shard_counts"], onehot_vocab=eng["onehot_vocab"], split_vocab=eng["split_vocab"],
        hot_rows=eng.get("hot_rows", 0), superhot_rows=eng.get("superhot_rows", 0),
    )
    opt = OptParams(Optimizer_t(cfg["optimizer"]), **OPT_HYPER)
    dt = getattr(torch, case["dtype"])
    ec = EmbeddingCollection(plan, rm, opt, dtype=dt, state_dtype=dt, dense_update_rows=eng["dense_update_rows"],
                             dense_key_ratio=eng["dense_key_ratio"],
                             **{k: v for k, v in eng.items() if k in EXCHANGE_SETTINGS})
    tables = ec.init(rm.generator(0))
    for g in plan.groups:
        if g.slot_is_dynamic.any():
            tables[g.name].zero_()  # a fresh row's value depends on the layout
    for name, values in inputs.get("tables", {}).items():
        ec.import_table(tables, name, values)
    state = ec.init_optimizer(tables)
    w, r = rm.num_devices, rm.rank
    feats = {f: torch.from_numpy(block(k, r, w)).to(rm.device) for f, k in inputs["keys"].items()}
    out = {"fwd": {}}
    mesh.COLLECTIVE_CALLS.clear()
    mesh.COLLECTIVE_BYTES.clear()
    for step in range(1, cfg["steps"] + 1):
        outs = ec.forward(tables, feats)
        out["fwd"][str(step)] = {k: v.float().cpu().numpy() for k, v in outs.items()}
        d = {k: torch.from_numpy(block(v, r, w)).to(rm.device, dt) for k, v in inputs["d"][str(step)].items()}
        ec.backward_and_update(tables, state, feats, d, torch.tensor(cfg["lr"]), step)
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
    """`mesh.all_reduce` of this rank's row of inputs["x"] in bfloat16."""
    x = torch.from_numpy(inputs["x"][rm.rank]).to(torch.bfloat16)
    return {"y": mesh.all_reduce(x).float().numpy()}


def several(rm, inputs):
    """Several rank functions in one group: inputs["calls"] (JSON) maps a
    key to a function of this module, `hybrid.train_model` or
    `hybrid.snapshot_round_trip`; each gets inputs[key] and its result goes
    under key."""
    calls = json.loads(inputs["calls"])
    fns = dict(collection_cases=collection_cases, bf16_sum=bf16_sum, train_model=hybrid.train_model,
               snapshot_round_trip=hybrid.snapshot_round_trip)
    return {key: fns[name](rm, inputs[key]) for key, name in calls.items()}
