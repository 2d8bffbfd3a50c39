"""Where an eval's time goes (counterpart of tools/eval_profile.py): the
flagship at bench.py's operating point (`bench_settings()`: batch 16,384,
vocab_cap 2,000,000, the caps measured on the first batch with a headroom
of 1.05, as tools/eval_profile.py:11-12 sets them), 3 training steps, then over `--eval-batches` cached
eval batches (64 as the JAX tool; distinct synthetic batches):

1. the eval forward alone (`Model._eval_step`), ms a batch;
2. the forward and the metric write (`Model._eval_update`), ms a batch;
3. the AUC finalize at the buffer's size (`MetricAccumulator.finalize`);
4. a whole `Model.eval()` after a warm-up one, ms a batch.

Parts 1 and 2 are the mean of 2 passes after a warm-up of 2 batches;
each part is timed on the host clock around synchronised work. One line a
part, then a JSON line of all of them.

    python -m hugectr_tpu_torch.tools.eval_profile [--eval-batches 64] [--vocab-cap 2000000]
        [--batch 16384] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time


def profile(eval_batches: int = 64, vocab_cap: int = 2_000_000, batch: int = 16384, device=None, say=print,
            **overrides) -> dict:
    """The four parts' times; `overrides` replace `bench_settings()`' values."""
    import torch

    from ..core.mesh import ResourceManager
    from .flagship import bench_settings, build_dlrm_dcnv2

    rm = ResourceManager.create(device=device)

    def sync():
        if rm.device.type == "cuda":
            torch.cuda.synchronize(rm.device)

    kw = dict(bench_settings(), batchsize=batch, vocab_cap=vocab_cap, max_eval_batches=eval_batches,
              synthetic_batches=eval_batches)
    kw.update(overrides)
    model = build_dlrm_dcnv2(rm, **kw)
    for _ in range(3):
        model.train()
    source, _, _ = model._eval_batches()
    batches = list(source)
    say(f"{len(batches)} eval batches cached", flush=True)
    rec = dict(device=torch.cuda.get_device_name(rm.device) if rm.device.type == "cuda" else "cpu",
               batch=batch, eval_batches=len(batches))

    def passes(fn):
        for b in batches[:2]:
            fn(b)
        sync()
        t = time.perf_counter()
        for _ in range(2):
            model.metrics.reset()
            for b in batches:
                fn(b)
        sync()
        return (time.perf_counter() - t) / (2 * len(batches))

    dt = passes(model._eval_step)
    rec.update(forward_ms=dt * 1e3, forward_examples_per_s=batch / dt)
    say(f"eval_step alone: {dt * 1e3:.3f} ms/batch = {batch / dt:,.0f} ex/s", flush=True)
    dt = passes(model._eval_update)
    rec.update(forward_write_ms=dt * 1e3, forward_write_examples_per_s=batch / dt)
    say(f"eval_step+write: {dt * 1e3:.3f} ms/batch = {batch / dt:,.0f} ex/s", flush=True)
    sync()
    t = time.perf_counter()
    vals = model.metrics.finalize()
    sync()
    dt = time.perf_counter() - t
    rec.update(finalize_ms=dt * 1e3, finalize_buffer=model.metrics.capacity, finalize_values=vals)
    say(f"finalize({model.metrics.capacity:,} buf): {dt * 1e3:.3f} ms  {json.dumps(vals)}", flush=True)
    model.eval()
    sync()
    t = time.perf_counter()
    model.eval()
    sync()
    dt = time.perf_counter() - t
    n = model.solver.max_eval_batches
    rec.update(eval_seconds=dt, eval_ms_per_batch=dt * 1e3 / n, eval_examples_per_s=n * batch / dt)
    say(f"model.eval(): {dt:.3f}s for {n} batches = {dt * 1e3 / n:.3f} ms/batch = {n * batch / dt:,.0f} ex/s",
        flush=True)
    say(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("eval_profile")
    p.add_argument("--eval-batches", type=int, default=64)
    p.add_argument("--vocab-cap", type=int, default=2_000_000)
    p.add_argument("--batch", type=int, default=16384)
    p.add_argument("--device", default=None, help="cuda (the default: the card) or cpu")
    a = p.parse_args(argv)
    return profile(a.eval_batches, a.vocab_cap, a.batch, a.device)


if __name__ == "__main__":
    main()
