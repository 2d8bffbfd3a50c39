"""Device time of the port's kernels at every shape the flagship step gives them.

Usage (on a machine with a card, from the repo root):

    python -m hugectr_tpu_torch.tools.kernel_sweep [--batch 16384] [--kernels onehot_fwd,onehot_bwd,segscan]

The flagship DLRM-DCNv2 at vocab_cap 2,000,000 sends its 13 tables of at most
8,192 rows through the one-hot kernels (`onehot_fwd`, `onehot_bwd`, one
launch each per step) and its tables 0, 9, 10, 19, 21 and 22 through the
sorted route (`segscan`, one launch per step each, K = batch x hotness).
For each such shape, with power-law keys (alpha 1.05) made from a seed,
prints one JSON line: the kernel's device time per call (`torch.profiler`,
tools/devtime.py), its launches per call, the backward's route, the bound
(bytes at 3.35 TB/s) and, for the one-hot backward, the device time of the
`index_add_` kernel that computes the same gradient. A last line sums each
kernel's device time over the shapes of one step.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..data.generator import power_law_keys
from ..embedding.sparse_optimizer import update_route
from ..ops import onehot_matmul as oh
from ..ops import segscan as ss
from .devtime import KERNEL_NAMES, device_ms
from .flagship import MLPERF_MULTI_HOT_SIZES, MLPERF_TABLE_SIZES

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
E = 128
VOCAB_CAP = 2_000_000
ONEHOT_VOCAB = 8192


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--kernels", default="onehot_fwd,onehot_bwd,segscan")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    b = args.batch
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    total = {k: 0.0 for k in kernels}
    for t, (vocab, h) in enumerate(zip(MLPERF_TABLE_SIZES, MLPERF_MULTI_HOT_SIZES)):
        v = min(vocab, VOCAB_CAP)
        if v <= ONEHOT_VOCAB:
            keys = torch.as_tensor(power_law_keys(rng, v, (b, h), 1.05).astype(np.int32), device=dev)
            table = torch.randn((v, E), device=dev)
            d = torch.randn((b, E), device=dev)
            uniq = int(torch.unique(keys).numel())
            rec = dict(table=t, V=v, h=h, B=b, card=card)
            if "onehot_fwd" in kernels:
                ms, per_call = device_ms(lambda: oh.onehot_matmul_fwd(keys, table), KERNEL_NAMES["onehot_fwd"])
                nbytes = keys.numel() * 4 + uniq * E * 4 + b * E * 4
                total["onehot_fwd"] += ms
                print(json.dumps(dict(rec, kernel="onehot_fwd", device_ms=ms, launches_per_call=per_call,
                                      bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)), flush=True)
            if "onehot_bwd" in kernels:
                ms, per_call = device_ms(lambda: oh.onehot_matmul_bwd(keys, d, v, torch.float32),
                                         KERNEL_NAMES["onehot_bwd"])
                flat = keys.long().reshape(-1)
                d_rep = d.repeat_interleave(h, dim=0)
                lib_ms, _ = device_ms(lambda: torch.zeros((v, E), device=dev).index_add_(0, flat, d_rep),
                                      KERNEL_NAMES["index_add_"])
                nbytes = keys.numel() * 4 + b * E * 4 + v * E * 4 + v * 4
                total["onehot_bwd"] += ms
                print(json.dumps(dict(rec, kernel="onehot_bwd", route=oh.bwd_route(b, h, v, E, dev),
                                      device_ms=ms, launches_per_call=per_call,
                                      index_add_device_ms=lib_ms,
                                      bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)), flush=True)
        elif "segscan" in kernels and update_route(v, b * h, 262144, 0.3) == "sorted":
            k = b * h
            ids = np.sort(power_law_keys(rng, v, k, 1.05))
            heads = torch.as_tensor(np.concatenate([[True], ids[1:] != ids[:-1]]), device=dev)
            vals = torch.randn((k, E), device=dev)
            ms, per_call = device_ms(lambda: ss.segmented_sum_sorted(vals, heads), KERNEL_NAMES["segscan"])
            total["segscan"] += ms
            print(json.dumps(dict(table=t, V=v, K=k, segments=int(heads.sum()), card=card,
                                  kernel="segscan", device_ms=ms, launches_per_call=per_call,
                                  bound_ms=(2 * k * E * 4 + k) / HBM_BYTES_PER_S * 1e3)), flush=True)
    print(json.dumps(dict(card=card, batch=b, device_ms_per_step=total)), flush=True)


if __name__ == "__main__":
    main()
