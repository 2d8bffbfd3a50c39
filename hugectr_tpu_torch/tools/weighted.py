"""The weighted-lookup configuration of the JAX package's
benchmarks/weighted_bench.py:30-37, on the port's collection.

One 2,000,000-row table, ev 128, read by one weighted Sum lookup of hotness
20, batch 16,384, bf16 tables, rowwise AdaGrad (lr 0.01), weights uniform in
[0, 1) from the seed, power-law keys (alpha 1.05). Untiered, the table is a
rowop group on the sorted route (per-key gradient rows: K = B x 20); tiered
(hot 131,072 / split vocab 16,384 / superhot 1,024) its superhot tier [0,
1,024) joins the one-hot group (the weighted one-hot kernels), the hot tier
takes the dense sweep and the cold tier the sorted route. The bench's UCAP
settings (HCTR_TPU_UCAP_*) have no counterpart in the port.

`run_steps` times training steps of the collection alone, as the bench's
`step` does (forward, then the fused update from fixed cotangents); over W
ranks `rank_run` (for `tools/hybrid.py --model weighted`) gives each rank its
block of the global batch.
"""
from __future__ import annotations

import json
import statistics
import time
from typing import Any, Dict

import numpy as np
import torch

from ..core.types import Combiner_t, Optimizer_t
from ..data.generator import power_law_keys
from ..embedding.collection import EmbeddingCollection
from ..optim.params import OptParams
from ..parallel.plan import EmbeddingTableConfig, LookupConfig, ShardingPlan, compile_plan

VOCAB = 2_000_000
HOT = 20
EV = 128
BATCH = 16384
ALPHA = 1.05
# the tiers' settings (weighted_bench.py:35-37)
TIERS = dict(hot_rows=131072, split_vocab=16384, superhot_rows=1024)
UNTIERED = dict(hot_rows=0, split_vocab=0, superhot_rows=0)


def weighted_plan(tiers: bool, num_shards: int = 1, vocab: int = VOCAB, hot: int = HOT, ev: int = EV,
                  onehot_vocab: int = 8192):
    """The bench's one weighted Sum lookup "e" of feature "f", weights "w"."""
    t = EmbeddingTableConfig("t", vocab, ev)
    lks = [LookupConfig(0, t, "f", "e", Combiner_t.Sum, hot, sp_weight_name="w")]
    return compile_plan(lks, ShardingPlan([("mp", ["t"])]), num_shards, onehot_vocab=onehot_vocab,
                        **(TIERS if tiers else UNTIERED))


def weighted_collection(rm, tiers: bool, dtype=torch.bfloat16, **plan_kw) -> EmbeddingCollection:
    """The bench's collection: bf16 tables, rowwise AdaGrad at lr 0.01."""
    plan = weighted_plan(tiers, rm.data_parallel_size, **plan_kw)
    return EmbeddingCollection(plan, rm, OptParams(Optimizer_t.RowWiseAdaGrad, lr=0.01), dtype=dtype)


def weighted_batch(seed: int, batch: int = BATCH, vocab: int = VOCAB, hot: int = HOT, ev: int = EV):
    """(keys [B, hot] int32, weights [B, hot] float32 in [0, 1), cotangents
    [B, ev] float32) from the seed, as the bench draws them."""
    rng = np.random.default_rng(seed)
    keys = power_law_keys(rng, vocab, batch * hot, ALPHA).reshape(batch, hot).astype(np.int32)
    w = rng.random((batch, hot)).astype(np.float32)
    d = rng.normal(size=(batch, ev)).astype(np.float32)
    return keys, w, d


def run_steps(ec: EmbeddingCollection, tables, state, keys: torch.Tensor, w: torch.Tensor, d: torch.Tensor,
              steps: int, on_step=None) -> Dict[str, Any]:
    """`steps` training steps of the collection (the bench's step: the
    forward, then the fused update from `d` in place of the network's
    cotangents). Returns the host ms of each synchronised step."""
    feats, fw = {"f": keys}, {"w": w}
    lr = torch.tensor(0.01, device=ec.device)
    cuda = ec.device.type == "cuda"
    ms = []
    for step in range(1, steps + 1):
        if cuda:
            torch.cuda.synchronize(ec.device)
        t0 = time.perf_counter()
        outs = ec.forward(tables, feats, fw)
        grads = {"e": outs["e"] * 0 + d.to(outs["e"].dtype)}  # the forward stays live
        ec.backward_and_update(tables, state, feats, grads, lr, step, fw)
        if cuda:
            torch.cuda.synchronize(ec.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        if on_step is not None:
            on_step(step)
    return {"step_ms": ms, "median_ms_per_step": statistics.median(ms[1:]) if len(ms) > 1 else ms[0]}


def rank_run(rm, inputs) -> Dict[str, Any]:
    """Rank function of `tools/hybrid.py --model weighted`: the collection
    of inputs["config"] ({"tiers", "steps", "seed", "batch", "vocab",
    "dtype"}) over the ranks, trained on this rank's block of one global
    batch; the routes, the launches a step of each kernel (weighted ones
    apart), the ordered pool's weighted inputs at this rank's shapes, host
    ms a step, peak memory, and a digest of the tables."""
    from ..core import mesh
    from ..ops import launch_counts, reset_counts, weighted_counts

    cfg = json.loads(inputs["config"])
    dtype = getattr(torch, cfg.get("dtype", "bfloat16"))
    ec = weighted_collection(rm, cfg["tiers"], dtype=dtype, vocab=cfg["vocab"])
    gen = torch.Generator(device=rm.device).manual_seed(cfg["seed"])
    tables = ec.init(gen)
    state = ec.init_optimizer(tables)
    keys, w, d = weighted_batch(cfg["seed"], cfg["batch"], cfg["vocab"])
    n = cfg["batch"] // rm.data_parallel_size
    r = rm.data_index
    blk = lambda a: torch.from_numpy(a[r * n : (r + 1) * n]).to(rm.device)  # noqa: E731
    kt, wt, dt = blk(keys), blk(w), blk(d)
    if rm.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(rm.device)
    reset_counts()
    mesh.COLLECTIVE_CALLS.clear()
    rec = run_steps(ec, tables, state, kt, wt, dt, cfg["steps"])
    steps = cfg["steps"]
    rec.update(
        routes=dict(ec.group_routes),
        launches_per_step={k: v / steps for k, v in launch_counts().items()},
        weighted_launches_per_step={k: v / steps for k, v in weighted_counts().items()},
        collective_calls_per_step={k: v / steps for k, v in mesh.COLLECTIVE_CALLS.items()},
        peak_memory_bytes=int(torch.cuda.max_memory_allocated(rm.device)) if rm.device.type == "cuda" else 0,
        table_digest={g: float(t.float().abs().sum()) for g, t in tables.items()},
        pool_checks=pool_checks(ec, tables, kt, wt) if rm.data_parallel_size > 1 else {},
    )
    return rec


def pool_checks(ec: EmbeddingCollection, tables, keys: torch.Tensor, w: torch.Tensor) -> Dict[str, Any]:
    """The weighted ordered pool of each model-parallel group at this
    rank's shapes (its keys of the all-gathered batch, `_pool_segments`
    with the weights) against the kernel's plain version: bitwise, and the
    pairs and slots. Every rank calls this together (all_gather)."""
    from ..ops.ordered_pool import ordered_pool, ordered_pool_plain

    out = {}
    for g in ec.plan.groups:
        if not (g.is_model_parallel and g.compute_kind == "rowop"):
            continue
        gk = ec._group_keys(g, {"f": keys})
        gw = ec._group_weights(g, {"w": w}, gk)
        rows, offsets, ws = ec._pool_segments(g.name, ec._all_gather(gk), g.total_local_rows, None,
                                              ec._all_gather(gw))
        got = ordered_pool(tables[g.name], rows, offsets, ws)
        want = ordered_pool_plain(tables[g.name], rows, offsets, ws)
        bits = torch.int16 if got.element_size() == 2 else torch.int32
        out[g.name] = {"pairs": int(rows.numel()), "slots": int(offsets.numel() - 1),
                       "owned": int((rows < g.total_local_rows).sum()),
                       "bitwise": bool(torch.equal(got.view(bits), want.view(bits)))}
    return out


# Tiny weighted collections of the card's parity checks (`chip_smoke.py`
# `weighted_parity`), ev 8, rows as (table, vocab, feature, top, combiner,
# hotness, weight feature or ""), float32: "split", a 3,000-row table read by
# a weighted Mean and a weighted Sum lookup and split into a superhot tier
# [0, 64) in the one-hot group (the weighted one-hot kernels), a hot tier on
# the dense sweep and a cold tier on the sorted route, beside a weighted
# one-hot table and an unweighted table; "dx": weighted Concat lookups on the
# unique-key dense exchange (lists of 128 rows) over W ranks.
TINY = {
    "split": dict(spec=[("big", 3000, "f0", "e0", "mean", 6, "w0"), ("small", 57, "f1", "e1", "sum", 3, "w1"),
                        ("mid", 700, "f2", "e2", "sum", 2, ""), ("big", 3000, "f3", "e3", "sum", 2, "w3")],
                  engine=dict(onehot_vocab=128, split_vocab=1024, hot_rows=256, superhot_rows=64),
                  collection=dict(dense_update_rows=1000, dense_key_ratio=0.0)),
    "dx": dict(spec=[("t0", 96, "f0", "e0", "concat", 4, "w0"), ("t1", 64, "f1", "e1", "concat", 3, "w1"),
                     ("t0", 96, "f2", "e2", "concat", 2, "")],
               engine=dict(onehot_vocab=0, split_vocab=0),
               collection=dict(dense_update_rows=1000, dense_key_ratio=0.0, dense_exchange_cap=128)),
}


def tiny_inputs(case: str, batch: int, steps: int, seed: int) -> Dict[str, Any]:
    """Tables (0.1 x normal), a global batch of keys (a sixth -1, sample 0
    all -1, a fifth of the split table's keys in its superhot window),
    signed normal weights (a Mean lookup's positive, its sample 1 all 0)
    and each step's cotangents, for `tiny_run`."""
    rng = np.random.default_rng(seed)
    spec = TINY[case]["spec"]
    tables = {t: (rng.normal(size=(v, 8)) * 0.1).astype(np.float32) for t, v, *_ in spec}
    keys, weights = {}, {}
    for _t, v, f, _top, c, h, wname in spec:
        k = rng.integers(0, v, size=(batch, h)).astype(np.int32)
        low = rng.random((batch, h)) < 0.2
        k[low] = rng.integers(0, min(v, 64), size=int(low.sum()))
        k[rng.random((batch, h)) < 0.17] = -1
        k[0] = -1
        keys[f] = k
        if wname:
            w = rng.normal(size=(batch, h)).astype(np.float32)
            if c == "mean":
                w = np.abs(w) + 0.1
                w[1] = 0.0
            weights[wname] = w.astype(np.float32)
    d = {str(s): {top: rng.normal(size=(batch, 8 * (h if c == "concat" else 1))).astype(np.float32)
                  for _t, _v, _f, top, c, h, _w in spec}
         for s in range(1, steps + 1)}
    return {"config": json.dumps({"case": case, "steps": steps}), "tables": tables, "keys": keys, "w": weights,
            "d": d}


def tiny_run(rm, inputs) -> Dict[str, Any]:
    """A tiny weighted collection (`TINY`, AdaGrad at lr 0.3) over the ranks:
    the tables of `inputs` imported, then per step the forward of this
    rank's block of the batch and its weights and the fused update from its
    block of the cotangents. Returns each step's outputs, the tables in key
    order, the routes, and the launches (weighted ones apart) and
    collectives of the steps. A rank function of `tools/hybrid.run`, and
    the one-device run of the same checks."""
    from ..core import mesh
    from ..ops import launch_counts, reset_counts, weighted_counts

    cfg = json.loads(inputs["config"])
    case = TINY[cfg["case"]]
    cfgs, lookups = {}, []
    for i, (t, v, f, top, c, h, wname) in enumerate(case["spec"]):
        cfgs.setdefault(t, EmbeddingTableConfig(t, v, 8))
        lookups.append(LookupConfig(i, cfgs[t], f, top, Combiner_t(c), h, sp_weight_name=wname))
    plan = compile_plan(lookups, ShardingPlan([("mp", sorted(cfgs))]), rm.data_parallel_size, **case["engine"])
    ec = EmbeddingCollection(plan, rm, OptParams(Optimizer_t.AdaGrad), **case["collection"])
    tables = ec.init(rm.generator(0))
    for name, values in inputs["tables"].items():
        ec.import_table(tables, name, values)
    state = ec.init_optimizer(tables)
    n, r = next(iter(inputs["keys"].values())).shape[0] // rm.data_parallel_size, rm.data_index
    blk = lambda a: torch.from_numpy(np.ascontiguousarray(a[r * n : (r + 1) * n])).to(rm.device)  # noqa: E731
    feats = {f: blk(k) for f, k in inputs["keys"].items()}
    fw = {k: blk(v) for k, v in inputs["w"].items()}
    reset_counts()
    mesh.COLLECTIVE_CALLS.clear()
    out = {"fwd": {}}
    for step in range(1, cfg["steps"] + 1):
        with torch.no_grad():
            outs = ec.forward(tables, feats, fw)
        out["fwd"][str(step)] = {k: v.float().cpu().numpy() for k, v in outs.items()}
        d = {k: blk(v) for k, v in inputs["d"][str(step)].items()}
        with torch.no_grad():
            ec.backward_and_update(tables, state, feats, d, torch.tensor(0.3), step, fw)
    out["launches"] = launch_counts()
    out["weighted_launches"] = weighted_counts()
    out["collective_calls"] = dict(mesh.COLLECTIVE_CALLS)
    out["routes"] = dict(ec.group_routes)
    out["groups"] = {g.name: g.compute_kind for g in plan.groups}
    out["tables"] = {t: ec.export_table(tables, t) for t in sorted(inputs["tables"])}
    return out
