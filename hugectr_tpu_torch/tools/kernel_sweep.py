"""Device time of the port's kernels at every shape the flagship step gives them.

Usage (on a machine with a card, from the repo root):

    python -m hugectr_tpu_torch.tools.kernel_sweep [--batch 16384] [--kernels onehot_fwd,onehot_bwd,segscan]

The flagship DLRM-DCNv2 at vocab_cap 2,000,000 (its plan as
`tools/flagship.py::flagship_plan` compiles it) sends its 13 tables of at
most 8,192 rows through the one-hot kernels (`onehot_fwd`: one launch per
step for the whole group; `onehot_bwd`: one launch per table) and its
tables 0, 9, 10, 19, 21 and 22 through the sorted route (`segscan`, one
launch per step each, K = batch x hotness). With power-law keys (alpha
1.05) made from a seed, prints one JSON line per case: the kernel's device
time per call (`torch.profiler`, tools/devtime.py), its launches per call,
the route and the bound (bytes at 3.35 TB/s: each input once, touched table
rows once, each output once). For `onehot_fwd`: the group case (the step's
one launch, beside one `F.embedding_bag` call over the group storage) and
each table alone (the same kernel as a one-lookup group). For
`onehot_bwd`, the device time of the `index_add_` kernel that computes the
same gradient. A last line sums each kernel's device time over the shapes
of one step, and the per-table forwards beside the group's one launch.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from ..data.generator import power_law_keys
from ..embedding.sparse_optimizer import update_route
from ..ops import onehot_matmul as oh
from ..ops import segscan as ss
from .devtime import KERNEL_NAMES, device_ms
from .flagship import flagship_plan, onehot_group_inputs

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
E = 128


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _placed(keys, lookups):
    """Global storage rows [B, sum h] and their validity, as the forward
    places them (int32 cut, -1 padding, floor-mod wrap)."""
    rows, valid = [], []
    for k, lk in zip(keys, lookups):
        ok, local = oh.place_keys(k, lk.vocab)
        rows.append(local + lk.row_off)
        valid.append(ok)
    return torch.cat(rows, dim=1), torch.cat(valid, dim=1)


def group_bytes(keys, lookups, table, width) -> int:
    """Bytes the group forward must move: each lookup's keys, the touched
    rows of the storage and the [B, width] output."""
    rows, valid = _placed(keys, lookups)
    touched = int(torch.unique(rows[valid]).numel())
    isz = table.element_size()
    return (sum(k.numel() * k.element_size() for k in keys) + touched * table.shape[1] * isz
            + rows.shape[0] * width * isz)


def embedding_bag_call(keys, lookups, table):
    """One `F.embedding_bag(mode="sum")` over the group storage that
    computes the group forward of Sum lookups: 1-D global rows, bag
    b * n + i = lookup i of sample b, padding weighted 0. Returns the call
    (a closure giving [B, n * E]); the port never makes it."""
    rows, valid = _placed(keys, lookups)
    b, hsum = rows.shape
    hs = [k.shape[1] for k in keys]
    starts = torch.as_tensor(np.concatenate([[0], np.cumsum(hs)[:-1]]), device=rows.device)
    offsets = (torch.arange(b, device=rows.device)[:, None] * hsum + starts[None, :]).reshape(-1)
    flat, weights = rows.reshape(-1), valid.reshape(-1).to(table.dtype)

    def call():
        return F.embedding_bag(flat, table, offsets, mode="sum", per_sample_weights=weights).reshape(b, -1)

    return call


def group_case(b: int, dtype, dev, rng):
    """The flagship's one-hot group forward: device ms, launches per call,
    bound; the same for one `embedding_bag` call over the group."""
    keys, lookups, table, width = onehot_group_inputs(rng, b, E, dtype, dev)
    ms, per_call = device_ms(lambda: oh.onehot_fwd_group(keys, lookups, table, width),
                             KERNEL_NAMES["onehot_fwd"])
    lib = embedding_bag_call(keys, lookups, table)
    lib_ms, _ = device_ms(lib, KERNEL_NAMES["embedding_bag"])
    return dict(kernel="onehot_fwd", case="group13", B=b, lookups=len(lookups), width=width,
                dtype=str(dtype).split(".")[1],
                routes=[oh.fwd_route(lk.vocab, k.shape[1], E, dev) for k, lk in zip(keys, lookups)],
                device_ms=ms, launches_per_call=per_call,
                bound_ms=bound_ms(group_bytes(keys, lookups, table, width)),
                embedding_bag_device_ms=lib_ms)


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
    per_table_fwd = 0.0
    if "onehot_fwd" in kernels:
        rec = group_case(b, torch.float32, dev, np.random.default_rng(1))
        total["onehot_fwd"] = rec["device_ms"]
        print(json.dumps(dict(rec, card=card)), flush=True)
    groups = flagship_plan(ev_size=E).groups
    onehot = [(int(g.tables[lm.table_index].name), int(g.table_vocab[lm.table_index]), lm.hotness)
              for g in groups if g.compute_kind == "onehot" for lm in g.lookups]
    sorted_groups = [g for g in groups if g.compute_kind != "onehot"
                     and update_route(g.total_local_rows, b * g.hotness_total, 262144, 0.3) == "sorted"]
    for t, v, h in onehot:
        keys = torch.as_tensor(power_law_keys(rng, v, (b, h), 1.05).astype(np.int32), device=dev)
        table = torch.randn((v, E), device=dev)
        d = torch.randn((b, E), device=dev)
        uniq = int(torch.unique(keys).numel())
        rec = dict(table=t, V=v, h=h, B=b, card=card)
        if "onehot_fwd" in kernels:
            nbytes = keys.numel() * 4 + uniq * E * 4 + b * E * 4
            ms, per_call = device_ms(lambda: oh.onehot_matmul_fwd(keys, table), KERNEL_NAMES["onehot_fwd"])
            per_table_fwd += ms
            print(json.dumps(dict(rec, kernel="onehot_fwd", route=oh.fwd_route(v, h, E, dev),
                                  device_ms=ms, launches_per_call=per_call,
                                  bound_ms=bound_ms(nbytes))), flush=True)
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
                                  bound_ms=bound_ms(nbytes))), flush=True)
    for g in sorted_groups if "segscan" in kernels else ():
        v, k = g.total_local_rows, b * g.hotness_total
        ids = np.sort(power_law_keys(rng, v, k, 1.05))
        heads = torch.as_tensor(np.concatenate([[True], ids[1:] != ids[:-1]]), device=dev)
        vals = torch.randn((k, E), device=dev)
        ms, per_call = device_ms(lambda: ss.segmented_sum_sorted(vals, heads), KERNEL_NAMES["segscan"])
        total["segscan"] += ms
        print(json.dumps(dict(group=g.name, V=v, K=k, segments=int(heads.sum()), card=card,
                              kernel="segscan", device_ms=ms, launches_per_call=per_call,
                              bound_ms=bound_ms(2 * k * E * 4 + k))), flush=True)
    print(json.dumps(dict(card=card, batch=b, device_ms_per_step=total,
                          onehot_fwd_per_table_sum_ms=per_table_fwd)), flush=True)


if __name__ == "__main__":
    main()
