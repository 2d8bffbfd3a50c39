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


def ec_lookups(pkg, comb):
    """The collection's lookups in `pkg` (either package's plan module)."""
    tables = {}
    out = []
    for i, (t, v, f, top, c, h) in enumerate(EC_SPEC):
        tables.setdefault(t, pkg.EmbeddingTableConfig(t, v, 8))
        out.append(pkg.LookupConfig(i, tables[t], f, top, comb(c), h))
    return out


def ec_keys(rng, b):
    """Every lookup's [B, h] keys: -1 padding, negative keys and keys >= V
    beside valid ones; sample 0 all padding."""
    feats = {}
    for _t, v, f, _top, _c, h in EC_SPEC:
        k = rng.integers(0, v, size=(b, h)).astype(np.int32)
        r = rng.random((b, h))
        k[r < 0.15] = -1
        k[(r >= 0.15) & (r < 0.22)] = -rng.integers(2, 3 * v, size=int(((r >= 0.15) & (r < 0.22)).sum()))
        k[(r >= 0.22) & (r < 0.3)] += v
        k[0] = -1
        feats[f] = k
    return feats


def ec_inputs(optimizer, b, steps, lr):
    """Inputs of `collection_steps`: tables, a global batch of `b` keys and
    each step's cotangents, made from a seed of the optimizer."""
    rng = np.random.default_rng(23 if optimizer == "ftrl" else 29)
    tables = {t: (rng.normal(size=(v, 8)) * 0.1).astype(np.float32) for t, v, *_ in EC_SPEC}
    # a Concat lookup's output holds one ev-wide column block per slot
    d = {str(s): {top: rng.normal(size=(b, 8 * (h if c == "concat" else 1))).astype(np.float32)
                  for _t, _v, _f, top, c, h in EC_SPEC}
         for s in range(1, steps + 1)}
    cfg = dict(optimizer=optimizer, steps=steps, lr=lr)
    return {"config": json.dumps(cfg), "tables": tables, "keys": ec_keys(rng, b), "d": d}


def block(arr: np.ndarray, rank: int, world: int) -> np.ndarray:
    n = arr.shape[0] // world
    return arr[rank * n : (rank + 1) * n]


def collectives(rm, inputs):
    """all_gather, reduce_scatter, all_reduce and broadcast of this rank's
    rows of inputs["x"] (int64 and float32)."""
    x = block(inputs["x"], rm.rank, rm.num_devices)
    out = {}
    for name, t in (("i64", torch.from_numpy(x.astype(np.int64))), ("f32", torch.from_numpy(x))):
        out[f"all_gather_{name}"] = mesh.all_gather(t).numpy()
    out["reduce_scatter"] = mesh.reduce_scatter(torch.from_numpy(inputs["x"] * (rm.rank + 1))).numpy()
    out["all_reduce"] = mesh.all_reduce(torch.from_numpy(inputs["x"] * (rm.rank + 1))).numpy()
    out["broadcast"] = mesh.broadcast(torch.from_numpy(inputs["x"] * (rm.rank + 1))).numpy()
    out["backend"] = mesh.backend()
    out["bytes"] = dict(mesh.COLLECTIVE_BYTES)
    return out


def collection_steps(rm, inputs):
    """The collection of `EC_SPEC` over the group: the tables imported from
    inputs["tables"], then per step the forward of this rank's block of the
    global batch inputs["keys"][f] and the fused update with its block of
    inputs["d"][step][top]. Returns each step's outputs, every table in key
    order, this rank's storage and state, and the routes."""
    cfg = json.loads(inputs["config"])
    plan = tplan.compile_plan(
        ec_lookups(tplan, Combiner_t), tplan.ShardingPlan(EC_STRATEGY), rm.num_devices,
        onehot_vocab=EC_ENGINE["onehot_vocab"], split_vocab=EC_ENGINE["split_vocab"],
    )
    opt = OptParams(Optimizer_t(cfg["optimizer"]), **OPT_HYPER)
    ec = EmbeddingCollection(plan, rm, opt, dense_update_rows=EC_ENGINE["dense_update_rows"],
                             dense_key_ratio=EC_ENGINE["dense_key_ratio"])
    tables = ec.init(rm.generator(0))
    for name, values in inputs["tables"].items():
        ec.import_table(tables, name, values)
    state = ec.init_optimizer(tables)
    w, r = rm.num_devices, rm.rank
    feats = {f: torch.from_numpy(block(k, r, w)).to(rm.device) for f, k in inputs["keys"].items()}
    out = {"fwd": {}}
    for step in range(1, cfg["steps"] + 1):
        outs = ec.forward(tables, feats)
        out["fwd"][str(step)] = {k: v.cpu().numpy() for k, v in outs.items()}
        d = {k: torch.from_numpy(block(v, r, w)).to(rm.device) for k, v in inputs["d"][str(step)].items()}
        ec.backward_and_update(tables, state, feats, d, torch.tensor(cfg["lr"]), step)
    out["tables"] = {t: ec.export_table(tables, t) for t in sorted({s[0] for s in EC_SPEC})}
    out["storage"] = {g: t.cpu().numpy() for g, t in tables.items()}
    out["state"] = {g: {k: t.cpu().numpy() for k, t in st.items()} for g, st in state.items()}
    out["routes"] = dict(ec.group_routes)
    return out


def collection_cases(rm, inputs):
    """`collection_steps` of each case in `inputs`, by name."""
    return {name: collection_steps(rm, i) for name, i in inputs.items()}


def several(rm, inputs):
    """Several rank functions in one group: inputs["calls"] (JSON) maps a
    key to a function of this module or `hybrid.train_model`; each gets
    inputs[key] and its result goes under key."""
    calls = json.loads(inputs["calls"])
    fns = dict(collection_cases=collection_cases, train_model=hybrid.train_model)
    return {key: fns[name](rm, inputs[key]) for key, name in calls.items()}
