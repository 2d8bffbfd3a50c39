"""Training throughput with the host-spill tier active (counterpart of
benchmarks/host_spill_bench.py).

One dynamic table of `--capacity` rows (bf16), Concat with 13 dense, MLP
256-1, BCE, AdaGrad; batches of `--hotness` power-law keys (alpha 1.05).
First a reference without a tier, on keys below the capacity (5 warm-up and
`--steps` timed steps); then the same model with `HostSpillTier` (spill
watermark 0.75) on keys over 4x the capacity: each step stages the batch's
master rows first, spilling the least recently used under the watermark
(max(`--warm-spill`, 0.75 x capacity / batch) warm-up steps, then
`--steps` timed ones). One JSON line: ex/s of each phase (host clock up to
a synchronisation), the per-step median and p90 of stage and dispatch, the
rows staged a step, the spills since the tier was attached, the host master's
size, the card's name and power limit.

    python -m hugectr_tpu_torch.benchmarks.host_spill_bench [--device cpu --batch 256 --capacity 4096]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import hugectr_tpu_torch as hugectr
from hugectr_tpu_torch.benchmarks.embedding_collection.train import card_info, synchronize
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.data.generator import power_law_keys
from hugectr_tpu_torch.embedding.host_spill import HostSpillTier

# host_spill_bench.py:116-121
DEFAULTS = dict(batch=4096, capacity=131072, ev=64, hotness=5, steps=40, warm_spill=40)


def build(rm: ResourceManager, batch: int, capacity: int, ev: int, hotness: int):
    """The bench's model (host_spill_bench.py:34-79)."""
    solver = hugectr.CreateSolver(max_eval_batches=1, batchsize_eval=batch, batchsize=batch, lr=0.05,
                                  repeat_dataset=True, embedding_vec_dtype="bfloat16")
    reader = hugectr.DataReaderParams(data_reader_type=hugectr.DataReaderType_t.Synthetic, synthetic_num_batches=2)
    model = hugectr.Model(solver, reader, hugectr.CreateOptimizer(optimizer_type=hugectr.Optimizer_t.AdaGrad,
                                                                   initial_accu_value=0.0), resource_manager=rm)
    model.add(hugectr.Input(label_dim=1, label_name="label", dense_dim=13, dense_name="dense",
                            data_reader_sparse_param_array=[hugectr.DataReaderSparseParam("d0", hotness, True, 1)]))
    t = hugectr.EmbeddingTableConfig(name="dyn", max_vocabulary_size=-1, ev_size=ev, dynamic_capacity=capacity)
    ebc = hugectr.EmbeddingCollectionConfig()
    ebc.embedding_lookup([t], ["d0"], "emb", ["sum"])
    ebc.shard(shard_matrix=[["dyn"]] * rm.num_devices, shard_strategy=[("mp", ["dyn"])])
    model.add(ebc)
    model.add(hugectr.DenseLayer(layer_type=hugectr.Layer_t.Concat, bottom_names=["emb", "dense"], top_names=["c"]))
    model.add(hugectr.DenseLayer(layer_type=hugectr.Layer_t.MLP, bottom_names=["c"], top_names=["m"],
                                 num_outputs=[256, 1], activations=[hugectr.Activation_t.Relu,
                                                                    hugectr.Activation_t.Non]))
    model.add(hugectr.DenseLayer(layer_type=hugectr.Layer_t.BinaryCrossEntropyLoss, bottom_names=["m", "label"],
                                 top_names=["loss"]))
    model.compile()
    model.start_data_reading()
    return model


def run_phase(model, tier: Optional[HostSpillTier], rng, lab, batch: int, hotness: int, vocab: int,
              warm: int, steps: int) -> Dict[str, Any]:
    """`warm` then `steps` timed steps on fresh power-law batches over
    `vocab` keys (host_spill_bench.py:87-113): ex/s, each timed step's
    stage-and-dispatch seconds, the rows staged a timed step, the last loss."""
    staged: List[int] = []

    def step():
        keys = power_law_keys(rng, vocab, batch * hotness, 1.05).reshape(batch, hotness).astype(np.int32)
        if tier is not None:
            staged.append(tier.stage_batch(keys))
        model._staged_train_batch = model._put_batch({
            "label": (lab.random((batch, 1)) > 0.5).astype(np.float32),
            "dense": lab.random((batch, 13)).astype(np.float32), "d0": keys})
        return model.train_async()

    for _ in range(warm):
        step()
    synchronize(model.device)
    staged.clear()
    times = []
    t0 = time.perf_counter()
    for _ in range(steps):
        s0 = time.perf_counter()
        loss = step()
        times.append(time.perf_counter() - s0)
    synchronize(model.device)
    return dict(examples_per_sec=steps * batch / (time.perf_counter() - t0), times=times, staged=staged,
                loss=float(loss))


def run(rm: ResourceManager, batch: int, capacity: int, ev: int, hotness: int, steps: int, warm_spill: int,
        ref_warm: int = 5) -> Dict[str, Any]:
    """Both phases on one model (host_spill_bench.py:115-178). Returns the
    record and, under "model" and "tier", the model and its tier."""
    model = build(rm, batch, capacity, ev, hotness)
    rng, lab = np.random.default_rng(0), np.random.default_rng(1)
    ref = run_phase(model, None, rng, lab, batch, hotness, capacity, ref_warm, steps)
    tier = HostSpillTier(model, "dyn", spill_watermark=0.75)
    spills = [0]
    spill = tier.spill

    def counted_spill(*a, **k):
        spills[0] += 1
        return spill(*a, **k)

    tier.spill = counted_spill
    warm_b = max(warm_spill, int(0.75 * capacity) // batch)
    on = run_phase(model, tier, rng, lab, batch, hotness, 4 * capacity, warm_b, steps)
    times = np.asarray(on["times"])
    rec = dict(batch=batch, capacity=capacity, ev=ev, hotness=hotness, dtype="bfloat16", steps=steps,
               warmup_steps=[ref_warm, warm_b], no_tier_examples_per_sec=ref["examples_per_sec"],
               tier_examples_per_sec=on["examples_per_sec"],
               tier_over_no_tier=on["examples_per_sec"] / ref["examples_per_sec"],
               step_ms_median=float(np.median(times)) * 1e3, step_ms_p90=float(np.percentile(times, 90)) * 1e3,
               staged_rows_per_step=float(np.mean(on["staged"])), staged_rows_max=int(max(on["staged"])),
               spills=spills[0], host_size=tier.host_size, losses=[ref["loss"], on["loss"]],
               **card_info(rm.device))
    return dict(record=rec, model=model, tier=tier)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for k, v in DEFAULTS.items():
        ap.add_argument(f"--{k.replace('_', '-')}", type=int, default=v)
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    rm = ResourceManager.create(device=args.device)
    out = run(rm, args.batch, args.capacity, args.ev, args.hotness, args.steps, args.warm_spill)
    out["model"]._close_readers()
    print(json.dumps(out["record"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
