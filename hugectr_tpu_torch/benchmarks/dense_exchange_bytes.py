"""The unique-key dense exchange's bytes against the per-key path's
(counterpart of benchmarks/dense_exchange_bytes.py).

Three cases of one model-parallel Concat lookup (hotness 20 and 100 into
2,000,000 rows, hotness 10 into 100,000; dense_exchange_bytes.py:44-51) at
batch 8,192, ev 128, bf16 tables, SGD, power-law keys (alpha 1.05, seed 7),
run over 8 gloo ranks on the CPU. Each list's capacity C comes, as in the
JAX script (dense_exchange_bytes.py:24, :62-70), from the caps the
collection measures on the case's batch (`unique_cap_factor="auto"` with
the default headroom of 1.25: `auto_unique_caps`, which every rank runs on
the whole batch), or is given (`--caps`, the `dense_exchange_cap` setting).
The line also gives the least C that holds the batch's unique rows of every
(batch block, owner shard) pair, under which a list would overflow.

Each rank runs one forward and one update on the exchange and reads
`core/mesh.py`'s `COLLECTIVE_BYTES` around each: the all_to_all buffers
(the forward's bf16 rows [W x C, ev], the update's float32 gradient sums
[W x C, ev]), and the keys' all_gather and the overflow vote beside them. A
ring moves (W - 1) / W of an all_to_all's buffer out of each rank. The JSON
line of a case holds those bytes beside the JAX script's formula for the
same C (dense_exchange_bytes.py:74-79): psum path 2 (W - 1) / W x B x H x
ev x 2 bytes, unique path 2 (W - 1) / W x W x C x ev x 2 bytes. The
formula counts the update's gradients at 2 bytes; both packages send them
as float32 (hugectr_tpu/embedding/collection.py:1148-1156), so the
measured unique bytes are the formula's forward half plus twice its update
half.

    python -m hugectr_tpu_torch.benchmarks.dense_exchange_bytes [--batch 512 --caps 64,64,64]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from hugectr_tpu_torch.core import mesh
from hugectr_tpu_torch.core.types import Combiner_t, Optimizer_t
from hugectr_tpu_torch.data.generator import power_law_keys
from hugectr_tpu_torch.embedding.collection import EmbeddingCollection
from hugectr_tpu_torch.optim.params import OptParams
from hugectr_tpu_torch.parallel.plan import (EmbeddingTableConfig, LookupConfig, ShardingPlan, compile_plan,
                                             table_shard_rotation)

BATCH = 8192
EV = 128
WORLD = 8
DTYPE_BYTES = 2  # bf16 vectors
SEED = 7
CASES = [("H=20 vocab=2M", 20, 2_000_000), ("H=100 vocab=2M", 100, 2_000_000), ("H=10 vocab=100k", 10, 100_000)]


def case_keys(rng: np.random.Generator, batch: int, hot: int, vocab: int) -> np.ndarray:
    return power_law_keys(rng, vocab, (batch, hot), 1.05).astype(np.int32)


def least_cap(keys: np.ndarray, world: int, name: str = "t") -> int:
    """The most unique rows any (batch block, owner shard) pair of the
    global batch holds: the least C with no overflow. A key k lives on
    shard (k + rotation) % W (`table_shard_rotation`)."""
    rot = table_shard_rotation(name)
    blocks = keys.reshape(world, -1).astype(np.int64)
    most = 0
    for blk in blocks:
        u = np.unique(blk)
        most = max(most, int(np.bincount((u + rot) % world, minlength=world).max()))
    return most


def formula(batch: int, hot: int, cap: int, world: int, ev: int = EV) -> Dict[str, float]:
    """dense_exchange_bytes.py:74-79, bytes a device a step (fwd + bwd)."""
    return dict(psum=2 * (world - 1) / world * batch * hot * ev * DTYPE_BYTES,
                unique=2 * (world - 1) / world * world * cap * ev * DTYPE_BYTES)


def rank_fn(rm, inputs) -> Dict[str, Any]:
    """One rank: the case's collection with the exchange at cap C (0: the
    cap measured on the whole batch), one forward and one SGD update of
    this rank's block; the bytes of each collective around each, the cap
    and whether the exchange path ran."""
    hot, vocab, cap, ev = (int(inputs[k]) for k in ("hot", "vocab", "cap", "ev"))
    keys = torch.as_tensor(inputs["keys"])
    t = EmbeddingTableConfig(name="t", max_vocabulary_size=vocab, ev_size=ev)
    plan = compile_plan([LookupConfig(0, t, "f", "e", Combiner_t.Concat, hot)], ShardingPlan([("mp", ["t"])]),
                        rm.data_parallel_size)
    ec = EmbeddingCollection(plan, rm, OptParams(Optimizer_t.SGD, lr=0.1), dtype=torch.bfloat16,
                             dense_exchange_cap=cap, unique_cap_factor="auto")
    if not cap:
        ec.auto_unique_caps({"f": np.asarray(inputs["keys"])})
    (g,) = ec.plan.groups
    tables = ec.init(rm.generator(0))
    state = ec.init_optimizer(tables)
    b = keys.shape[0] // rm.data_parallel_size
    feats = {"f": keys[rm.rank * b : (rm.rank + 1) * b]}
    mesh.COLLECTIVE_BYTES.clear()
    out = ec.forward(tables, feats)["e"]
    fwd = dict(mesh.COLLECTIVE_BYTES)
    mesh.COLLECTIVE_BYTES.clear()
    ec.backward_and_update(tables, state, feats, {"e": torch.ones_like(out)}, torch.tensor(0.1), 1)
    bwd = dict(mesh.COLLECTIVE_BYTES)
    names = sorted(set(fwd) | set(bwd))
    return dict(names=np.asarray(names), fwd=np.asarray([fwd.get(n, 0) for n in names], np.int64),
                bwd=np.asarray([bwd.get(n, 0) for n in names], np.int64),
                finite=np.asarray(bool(torch.isfinite(out.float()).all())),
                cap=np.asarray(ec._dense_exchange_cap(g.name)), gate=np.asarray(ec._dense_exchange_ok(g)))


def run_case(name: str, hot: int, vocab: int, batch: int, world: int, cap: int = 0, seed: int = SEED,
             keys: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """One case over `world` gloo ranks on the CPU; `cap` 0 takes the cap
    the ranks measure."""
    from hugectr_tpu_torch.tools import hybrid

    if keys is None:
        keys = case_keys(np.random.default_rng(seed), batch, hot, vocab)
    res = hybrid.run(rank_fn, world, dict(hot=hot, vocab=vocab, cap=cap, ev=EV, keys=keys), device="cpu")
    measured = not cap
    cap = int(res[0]["cap"])
    names = [str(n) for n in res[0]["names"]]
    per_rank = [{p: dict(zip(names, (int(x) for x in r[p]))) for p in ("fwd", "bwd")} for r in res]
    ring = (world - 1) / world
    fwd_a2a = max(r["fwd"].get("all_to_all", 0) for r in per_rank)
    bwd_a2a = max(r["bwd"].get("all_to_all", 0) for r in per_rank)
    f = formula(batch, hot, cap, world)
    return dict(case=name, batch=batch, hotness=hot, vocab=vocab, world=world, ev=EV, cap=cap,
                cap_measured=measured, least_cap=least_cap(keys, world),
                caps_alike=all(int(r["cap"]) == cap for r in res), gate_open=all(bool(r["gate"]) for r in res),
                exchange_ran=fwd_a2a > 0 and bwd_a2a > 0, finite=all(bool(r["finite"]) for r in res),
                collective_bytes_rank0=per_rank[0], all_ranks_alike=all(r == per_rank[0] for r in per_rank),
                measured_fwd_ring_bytes=ring * fwd_a2a, measured_bwd_ring_bytes=ring * bwd_a2a,
                measured_unique_bytes=ring * (fwd_a2a + bwd_a2a), formula_unique_bytes=f["unique"],
                formula_psum_bytes=f["psum"], psum_over_unique_formula=f["psum"] / f["unique"],
                psum_over_unique_measured=f["psum"] / (ring * (fwd_a2a + bwd_a2a)))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--caps", default="", help="C of each case, comma-separated (default: the measured caps)")
    args = ap.parse_args(argv)
    caps = [int(c) for c in args.caps.split(",")] if args.caps else [0] * len(CASES)
    rng = np.random.default_rng(SEED)  # one stream over the cases, as the JAX script draws them
    for (name, hot, vocab), cap in zip(CASES, caps):
        keys = case_keys(rng, args.batch, hot, vocab)
        print(json.dumps(run_case(name, hot, vocab, args.batch, WORLD, cap, keys=keys)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
