"""The AUC's finalize at MLPerf eval-set sizes (counterpart of
tools/auc_scale_probe.py): the exact tie-aware rank-sum AUC
(`metrics.auc_score`, one sort) and the binned one (`auc_score_large`, two
histograms over 2^20 bins) over buffers of 5,242,880 samples (bench.py's
320 x 16,384 eval), 16,777,216 and 89,137,319 (Criteo's eval set), on the
card. The exact AUC runs at every size (the JAX tool skips it past 20 M
samples for a fault of its device).

The inputs are made on the host from seed 0: labels 0 / 1 with
probability 1/2, predictions 0.3 label + uniform [0, 1) in float32;
`--ties Q` rounds the predictions to multiples of 1/Q, so that many tie.
Each finalize is timed after a warm-up call, on the host clock around a
synchronised call: the median of 3 calls.

    python -m hugectr_tpu_torch.tools.auc_scale_probe [--sizes 5242880,16777216,89137319] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np

SIZES = [5_242_880, 16_777_216, 89_137_319]  # bench.py's eval, 16 M, Criteo's eval set


def inputs(n: int, seed: int = 0, ties: int = 0):
    """(predictions, labels) float32 [n] on the host."""
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) > 0.5).astype(np.float32)
    preds = (labels * 0.3 + rng.random(n)).astype(np.float32)
    if ties:
        preds = (np.round(preds * ties) / ties).astype(np.float32)
    return preds, labels


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def probe(n: int, device=None, ties: int = 0) -> dict:
    """Both AUCs of `inputs(n, 0, ties)` on `device` (default: the card),
    each with its finalize ms (median of 3 timed calls)."""
    import torch

    from ..core.mesh import resolve_device
    from ..metrics.metrics import auc_score, auc_score_large

    dev = resolve_device(device)
    preds, labels = inputs(n, 0, ties)
    p, lab = torch.as_tensor(preds, device=dev), torch.as_tensor(labels, device=dev)
    rec = dict(n=n, device=str(dev))
    for name, fn in (("exact", auc_score), ("binned", auc_score_large)):
        fn(p, lab)  # warm-up
        times = []
        for _ in range(3):
            _sync(dev)
            t = time.perf_counter()
            out = fn(p, lab)
            _sync(dev)
            times.append((time.perf_counter() - t) * 1e3)
        rec[name] = float(out)
        rec[f"{name}_ms"] = statistics.median(times)
    rec["binned_minus_exact"] = rec["binned"] - rec["exact"]
    return rec


def main(argv=None) -> list:
    p = argparse.ArgumentParser("auc_scale_probe")
    p.add_argument("--sizes", default=",".join(map(str, SIZES)), help="comma list of buffer sizes")
    p.add_argument("--device", default=None, help="cuda (the default: the card) or cpu")
    p.add_argument("--ties", type=int, default=0, help="round predictions to multiples of 1/Q (0: no rounding)")
    a = p.parse_args(argv)
    out = []
    for n in (int(x) for x in a.sizes.split(",")):
        rec = probe(n, a.device, a.ties)
        for name in ("exact", "binned"):
            print(f"n={n:>11,}  {name:6s} auc={rec[name]:.9f} finalize={rec[name + '_ms']:10.3f} ms", flush=True)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
