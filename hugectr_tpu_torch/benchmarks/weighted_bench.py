"""The weighted-lookup bench case (counterpart of benchmarks/weighted_bench.py).

One 2,000,000-row weighted Sum table, ev 128, hotness 20, batch 16,384,
bf16 tables, rowwise AdaGrad (lr 0.01), weights uniform in [0, 1), power-law
keys (alpha 1.05), all from the seed (`tools/weighted.py` holds the case),
run untiered and tiered (hot 131,072 / split vocab 16,384 / superhot 1,024).
A step is the bench's: the collection's forward, then the fused update from
fixed cotangents. `--warmup` steps (3, as the bench), then `--steps` (20)
timed ones, each synchronised; one JSON line a case: ex/s over the timed
steps, median ms/step, the groups and routes, the card's name and power
limit, and the peak device memory. As the bench (weighted_bench.py:12-13,
:69), the collection measures its caps on the case's batch
(`unique_cap_factor="auto"`, headroom 1.05; `tools/weighted.py::BENCH_UCAP`):
a group with a valid cap pools by the compact forward (the weighted ordered
pool) and counts its measured keys in the key-ratio rule. The line gives
the caps.

    python -m hugectr_tpu_torch.benchmarks.weighted_bench [--device cpu --batch 256 --vocab 20000]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Callable, Dict, List, Optional

import torch

from hugectr_tpu_torch.benchmarks.embedding_collection.train import card_info
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.tools import weighted as wt

STEPS = 20  # weighted_bench.py:34
WARMUP = 3  # weighted_bench.py:94


def run_case(rm: ResourceManager, tiers: bool, steps: int = STEPS, warmup: int = WARMUP, seed: int = 0,
             batch: int = wt.BATCH, vocab: int = wt.VOCAB, before_timed: Optional[Callable[[], None]] = None,
             **plan_kw) -> Dict[str, Any]:
    """One case on `rm`'s device: `warmup` steps, then `before_timed()`
    (a caller's counters), then `steps` timed steps. Returns the record and,
    under "ec", "tables", "state", "keys", "w", the collection and its
    inputs."""
    host = wt.weighted_batch(seed, batch=batch, vocab=vocab)
    keys, w, d = (torch.as_tensor(a, device=rm.device) for a in host)
    ec = wt.weighted_collection(rm, tiers, vocab=vocab, ucap=wt.BENCH_UCAP, **plan_kw)
    ec.auto_unique_caps({"f": host[0]})
    tables = ec.init(rm.generator(0))
    state = ec.init_optimizer(tables)
    if warmup:
        wt.run_steps(ec, tables, state, keys, w, d, warmup)
    if before_timed is not None:
        before_timed()
    run = wt.run_steps(ec, tables, state, keys, w, d, steps)
    rec = dict(tiers=tiers, table_rows=vocab, ev=wt.EV, hotness=wt.HOT, batch=batch, dtype="bfloat16",
               optimizer="rowwise_adagrad", steps=steps, warmup=warmup,
               groups={g.name: [g.compute_kind, g.total_local_rows] for g in ec.plan.groups},
               routes=dict(ec.group_routes), caps=ec.measured_caps(),
               step_ms=run["step_ms"], median_ms_per_step=run["median_ms_per_step"],
               examples_per_sec=steps * batch / (sum(run["step_ms"]) / 1e3), **card_info(rm.device))
    return dict(record=rec, ec=ec, tables=tables, state=state, keys=keys, w=w)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--batch", type=int, default=wt.BATCH)
    ap.add_argument("--vocab", type=int, default=wt.VOCAB)
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    rm = ResourceManager.create(device=args.device)
    flat = None
    for tiers in (False, True):
        if rm.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(rm.device)
        out = run_case(rm, tiers, args.steps, args.warmup, batch=args.batch, vocab=args.vocab)
        rec = out["record"]
        flat = flat or rec["examples_per_sec"]
        print(json.dumps(dict(rec, over_untiered=rec["examples_per_sec"] / flat)), flush=True)
        del out
    return 0


if __name__ == "__main__":
    sys.exit(main())
