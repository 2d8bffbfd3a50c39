"""Eval-batch sweep (counterpart of tools/eval_batch_sweep.py): does a larger
`batchsize_eval` amortise the eval forward's fixed costs? The flagship with
bench.py's settings (`bench_settings()`: train batch 16,384, vocab_cap
2,000,000, the caps measured on the first batch with a headroom of 1.05, as
tools/eval_batch_sweep.py:12-13 sets them) is built once per eval batch (16,384, 32,768, 65,536), takes 2
training steps, then a warm-up `eval()` and a timed one over about 5.24 M
samples (`--samples` // eval batch batches); one line per eval batch, and a
JSON line of all of them.

    python -m hugectr_tpu_torch.tools.eval_batch_sweep [--eval-batches 16384,32768,65536]
        [--samples 5242880] [--vocab-cap 2000000] [--batch 16384] [--device cpu]
"""
from __future__ import annotations

import argparse
import gc
import json
import time


def sweep(eval_batches=(16384, 32768, 65536), samples: int = 5_242_880, vocab_cap: int = 2_000_000,
          batch: int = 16384, device=None, say=print, **overrides) -> list:
    """One record a eval batch: batches, seconds, ex/s of the timed eval.
    `overrides` replace `bench_settings()`' values."""
    import torch

    from ..core.mesh import ResourceManager
    from .flagship import bench_settings, build_dlrm_dcnv2

    rm = ResourceManager.create(device=device)
    out = []
    for eb in eval_batches:
        n_batches = max(samples // eb, 1)
        kw = dict(bench_settings(), batchsize=batch, vocab_cap=vocab_cap, batchsize_eval=eb,
                  max_eval_batches=n_batches, synthetic_batches=16)
        kw.update(overrides)
        model = build_dlrm_dcnv2(rm, **kw)
        for _ in range(2):
            model.train()
        model.eval()  # warm-up: makes the eval batches and puts them on the device
        if rm.device.type == "cuda":
            torch.cuda.synchronize(rm.device)
        t = time.perf_counter()
        model.eval()
        if rm.device.type == "cuda":
            torch.cuda.synchronize(rm.device)
        dt = time.perf_counter() - t
        n = n_batches * eb
        say(f"eval_batch {eb:6d}: {n / dt:,.0f} ex/s ({dt:.3f}s for {n_batches} batches)", flush=True)
        out.append(dict(eval_batch=eb, batches=n_batches, seconds=dt, examples_per_s=n / dt))
        del model
        gc.collect()
        if rm.device.type == "cuda":
            torch.cuda.empty_cache()
    say(json.dumps(out), flush=True)
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser("eval_batch_sweep")
    p.add_argument("--eval-batches", default="16384,32768,65536")
    p.add_argument("--samples", type=int, default=5_242_880)
    p.add_argument("--vocab-cap", type=int, default=2_000_000)
    p.add_argument("--batch", type=int, default=16384)
    p.add_argument("--device", default=None, help="cuda (the default: the card) or cpu")
    a = p.parse_args(argv)
    return sweep([int(x) for x in a.eval_batches.split(",")], a.samples, a.vocab_cap, a.batch, a.device)


if __name__ == "__main__":
    main()
