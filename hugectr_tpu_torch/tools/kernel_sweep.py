"""Device time of the port's kernels at every shape the flagship step gives them.

Usage (on a machine with a card, from the repo root):

    python -m hugectr_tpu_torch.tools.kernel_sweep [--batch 16384] [--bench]
        [--kernels onehot_fwd,onehot_bwd,segscan]

Without `--bench`: the flagship DLRM-DCNv2 at vocab_cap 2,000,000 in
float32 (its plan as `tools/flagship.py::flagship_plan` compiles it) sends
its 13 tables of at most 8,192 rows through the one-hot kernels
(`onehot_fwd`: one launch per step for the whole group; `onehot_bwd`: one
launch per table) and its tables 0, 9, 10, 19, 21 and 22 through the sorted
route (`segscan`, one launch per step each, K = batch x hotness). With
`--bench`: the flagship as bench.py configures it (`bench_settings()`, bf16
tables): the one-hot group holds 20 lookups, the seven superhot tiers
(V 1,024, h 3 to 100) reading the raw keys through their windows, and the
sorted route takes the seven cold tiers, whose scans run over the valid
keys of each window only (bf16 rows, float32 sums).

With power-law keys (alpha 1.05) made from a seed, prints one JSON line per
case: the kernel's device time per call (`torch.profiler`,
tools/devtime.py), its launches per call, the route and the bound (bytes at
3.35 TB/s: each input once, touched table rows once, each output once). For
`onehot_fwd`: the group case (the step's one launch, beside one
`F.embedding_bag` call over the group storage) and each lookup alone (the
same kernel as a one-lookup group). For `onehot_bwd`, the device time of
the `index_add_` kernel that computes the same gradient. A last line sums
each kernel's device time over the shapes of one step, and the per-lookup
forwards beside the group's one launch.
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
from .flagship import BENCH_PLAN, flagship_plan, onehot_group_inputs, raw_vocab

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
E = 128


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _placed(keys, lookups):
    """Global storage rows [B, sum h] and their validity, as the forward
    places them (int32 cut, window, -1 padding, floor-mod wrap)."""
    rows, valid = [], []
    for k, lk in zip(keys, lookups):
        ok, local = oh.place_keys(oh.window_keys(k, lk.key_lo, lk.key_hi), lk.vocab)
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


def group_case(b: int, dtype, dev, rng, **plan_kw):
    """The flagship's one-hot group forward: device ms, launches per call,
    bound; the same for one `embedding_bag` call over the group."""
    keys, lookups, table, width = onehot_group_inputs(rng, b, E, dtype, dev, **plan_kw)
    ms, per_call = device_ms(lambda: oh.onehot_fwd_group(keys, lookups, table, width),
                             KERNEL_NAMES["onehot_fwd"])
    lib = embedding_bag_call(keys, lookups, table)
    lib_ms, _ = device_ms(lib, KERNEL_NAMES["embedding_bag"])
    return dict(kernel="onehot_fwd", case=f"group{len(lookups)}", B=b, lookups=len(lookups), width=width,
                windowed=sum(lk.windowed for lk in lookups), dtype=str(dtype).split(".")[1],
                routes=[oh.fwd_route(lk.vocab, k.shape[1], E, dev) for k, lk in zip(keys, lookups)],
                device_ms=ms, launches_per_call=per_call,
                bound_ms=bound_ms(group_bytes(keys, lookups, table, width)),
                embedding_bag_device_ms=lib_ms)


def onehot_bwd_case(keys, d, v: int, dev) -> dict:
    """The one-hot backward of one lookup as the collection calls it
    (table-local int32 keys, -1 padding; d in the table's dtype; float32
    sums): device ms, the `index_add_` kernel's, the bound."""
    b, h = keys.shape
    ms, per_call = device_ms(lambda: oh.onehot_matmul_bwd(keys, d, v, torch.float32),
                             KERNEL_NAMES["onehot_bwd"])
    valid = keys.reshape(-1) >= 0
    flat = keys.long().reshape(-1)[valid]
    d_rep = d.float().repeat_interleave(h, dim=0)[valid]
    lib_ms, _ = device_ms(lambda: torch.zeros((v, E), device=dev).index_add_(0, flat, d_rep),
                          KERNEL_NAMES["index_add_"])
    nbytes = keys.numel() * 4 + b * E * d.element_size() + v * E * 4 + v * 4
    return dict(kernel="onehot_bwd", route=oh.bwd_route(b, h, v, E, dev), device_ms=ms,
                launches_per_call=per_call, index_add_device_ms=lib_ms, bound_ms=bound_ms(nbytes),
                keys=int(valid.sum()))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--kernels", default="onehot_fwd,onehot_bwd,segscan")
    ap.add_argument("--bench", action="store_true", help="the flagship as bench.py configures it")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    b = args.batch
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    plan_kw = BENCH_PLAN if args.bench else {}
    dtype = torch.bfloat16 if args.bench else torch.float32
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    total = {k: 0.0 for k in kernels}
    per_lookup_fwd = 0.0
    if "onehot_fwd" in kernels:
        rec = group_case(b, dtype, dev, np.random.default_rng(1), **plan_kw)
        total["onehot_fwd"] = rec["device_ms"]
        print(json.dumps(dict(rec, card=card)), flush=True)
    plan = flagship_plan(ev_size=E, **plan_kw)
    for g in plan.groups:
        if g.compute_kind != "onehot":
            continue
        for lm in g.lookups:
            v = int(g.table_vocab[lm.table_index])
            raw = torch.as_tensor(power_law_keys(rng, raw_vocab(plan, lm), (b, lm.hotness), 1.05)
                                  .astype(np.int32), device=dev)
            valid, local = oh.place_keys(oh.window_keys(raw, lm.key_lo, lm.key_hi), v)
            keys = torch.where(valid, local, -1).to(torch.int32)
            table = torch.randn((v, E), device=dev).to(dtype)
            d = torch.randn((b, E), device=dev).to(dtype)
            rec = dict(table=g.tables[lm.table_index].name, V=v, h=lm.hotness, B=b, window=[lm.key_lo, lm.key_hi],
                       dtype=str(dtype).split(".")[1], card=card)
            if "onehot_fwd" in kernels:
                lk = [oh.GroupLookup(0, v, 0, False, lm.key_lo, lm.key_hi)]
                ms, per_call = device_ms(lambda: oh.onehot_fwd_group([raw], lk, table, E),
                                         KERNEL_NAMES["onehot_fwd"])
                per_lookup_fwd += ms
                print(json.dumps(dict(rec, kernel="onehot_fwd", route=oh.fwd_route(v, lm.hotness, E, dev),
                                      device_ms=ms, launches_per_call=per_call,
                                      bound_ms=bound_ms(group_bytes([raw], lk, table, E)))), flush=True)
            if "onehot_bwd" in kernels:
                r = onehot_bwd_case(keys, d, v, dev)
                total["onehot_bwd"] += r["device_ms"]
                print(json.dumps(dict(rec, **r)), flush=True)
    for g in plan.groups if "segscan" in kernels else ():
        if g.compute_kind == "onehot":
            continue
        windowed = any(lm.windowed for lm in g.lookups)
        if update_route(g.total_local_rows, b * g.hotness_total, 262144, 0.0 if windowed else 0.3) != "sorted":
            continue
        # the group's valid keys (its window's), as the sorted route keeps them
        ids = []
        for lm in g.lookups:
            raw = torch.as_tensor(power_law_keys(rng, raw_vocab(plan, lm), (b, lm.hotness), 1.05), device=dev)
            wk = oh.window_keys(raw, lm.key_lo, lm.key_hi)
            ids.append(wk[wk >= 0].cpu().numpy() % int(g.table_vocab[lm.table_index]))
        ids = np.sort(np.concatenate(ids))
        k = ids.shape[0]
        heads = torch.as_tensor(np.concatenate([[True], ids[1:] != ids[:-1]]), device=dev)
        vals = torch.randn((k, E), device=dev).to(dtype)
        ms, per_call = device_ms(lambda: ss.segmented_sum_sorted(vals, heads, torch.float32),
                                 KERNEL_NAMES["segscan"])
        total["segscan"] += ms
        print(json.dumps(dict(group=g.name, V=g.total_local_rows, K=k, list_len=b * g.hotness_total,
                              segments=int(heads.sum()), dtype=str(dtype).split(".")[1], card=card,
                              kernel="segscan", device_ms=ms, launches_per_call=per_call,
                              bound_ms=bound_ms(k * E * (vals.element_size() + 4) + k))), flush=True)
    print(json.dumps(dict(card=card, batch=b, bench=args.bench, device_ms_per_step=total,
                          onehot_fwd_per_lookup_sum_ms=per_lookup_fwd)), flush=True)


if __name__ == "__main__":
    main()
