#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`hugectr_tpu_torch`) on one NVIDIA GPU.

Usage: python3 chip_smoke.py   (from the repo root, on a machine with a card)

Each phase prints one JSON line with its own seconds:

1. "card": the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the nvcc build of the kernels (csrc/*.cu, sm_90a).
2. "kernel": each hand-written kernel against its plain PyTorch version on
   the card, at the flagship's shapes, in float32 and bfloat16: the error
   scaled by the sum of |inputs| that went into each output element (the
   kernels sum in another order, one of them with atomics) against a stated
   tolerance, and the kernel's, the plain version's and one PyTorch library
   call's times (CUDA events, median of 20 samples of 5 calls, after
   warm-up), with the bound the card's memory rate or float32 rate puts on
   the same work. `device_ms` is the kernel's device time per call from
   `torch.profiler` over 20 calls, summing the kernel's own launches
   (`hugectr_tpu_torch/tools/devtime.py`; CUDA events around 20 calls
   where five profiles in a row record no device activity or only part of
   the launches, listed in a
   "profiler" line at the end); the fraction of the bound is judged on it. The grouped one-hot forward at the flagship's 13-table
   group (keys as int32 column views of one [B, 62] tensor): one launch per
   call, its times beside the bound and one `embedding_bag` call over the
   group storage. Then the edge cases of the designs: grouped forward with Sum and Mean
   lookups, negative and >= V keys, int64 keys >= 2^31, all padding, h 1
   beside h 128, a one-lookup group against the per-table forward; every
   one-hot key on one row, V at the
   backward's shared-memory tile edges, all padding, accumulation into a
   caller's buffers; segscan over one segment, all heads, K at a tile's
   edges, K below a tile and K = 0, and two runs compared bitwise. Then
   the shapes of bench.py's configuration: the grouped forward at its
   20-lookup group (seven superhot tiers reading the raw keys through their
   windows), f32 and bf16; the window's edge cases (lo - 1, lo, hi - 1, hi,
   keys past V and below -1, dropped by a tier and wrapped beside it by an
   unsplit lookup); the seven superhot backwards (V 1,024, h 3 to 100) with
   the `index_add_` time beside them; the bf16 segscan of table 20's cold
   tier (bf16 rows, float32 sums). Then the shapes of DLRM with FTRL: the
   grouped forward at its 13-lookup hotness-1 group beside one
   `embedding_bag`, the 13 backwards at hotness 1 beside `index_add_`, and
   segscan at K 16,384. Then the bench shapes of one of the W ranks of the
   hybrid phases (cases `_w{W}`): the 20-lookup group and the superhot
   backwards on B/W rows, the cold tier's segscan over the keys rank 0
   owns. Then the ordered pool of the owner-partitioned forward
   (csrc/ordered_pool.cu) bitwise against its plain version at rank 0's
   shapes of the hybrid phases (the f32 flagship's table-20 and 5-lookup
   groups, the bench configuration's bf16 tiers of table 20), with its
   bound, `embedding_bag` and `index_add_` beside it, and at its edge
   cases (E 13, 16 and 128, slots of 0 to 100 rows).
3. "tiny_parity": the tiny DLRM-DCNv2 trained 3 steps on the card (kernels)
   and on the CPU (plain versions) from the same state: losses and tables
   must agree. Then the same with bench.py's settings scaled down (bf16,
   mixed precision, the split with a superhot tier): losses and the eval's
   AUC and AverageLoss. Then the tiny DLRM-FTRL, static and with exact
   dynamic tables: losses, tables, dense parameters and FTRL state, key
   stores bitwise.
4. "main_path": the flagship DLRM-DCNv2 at full width (26 MLPerf tables,
   ev 128, vocab_cap 2,000,000, batch 16,384, rowwise AdaGrad, fp32) built
   with `build_dlrm_dcnv2` and trained 6 `Model.train()` steps. Launch
   counters are set to 0 just before the steps and read just after; every
   kernel must have launched, `onehot_fwd` exactly once per step (one
   launch for the one-hot group). Reports the losses (finite), ms/step and ex/s
   (median of steps 2-6), peak device memory and each group's update route.
5. "bench_path": the flagship as bench.py configures it
   (`tools/flagship.py::bench_settings`: bf16 tables and rowwise-AdaGrad
   state, mixed precision, hot 131,072 / superhot 1,024 / split vocab
   16,384), 6 training steps, a warm-up `eval()` and a timed `eval()` over
   320 batches of 16,384. Counters are set to 0 before the steps and before
   the timed eval; every kernel must launch in the steps, `onehot_fwd` once
   per step and once per eval batch (one launch for the 20-lookup group),
   every loss must be finite and the eval's binned AUC within 1e-4 of the
   exact AUC of the same buffers. Reports ms/step, train and eval ex/s,
   peak memory, the routes and the launch counts.
6. "ftrl_path": DLRM with FTRL at full width (`build_dlrm_ftrl`: 26
   tables capped at 400,000 rows, ev 128, hotness 1, batch 16,384), 6
   steps and a 20-batch eval, counters read around each: `onehot_fwd` once
   per step and per eval batch, `onehot_bwd` 13 per step, `segscan` in the
   steps, the route map as planned, finite losses.
7. "ftrl_dynamic_path": the same on exact dynamic tables (4,096 rows
   each, no hand-written kernel on this path): the key store's fill and
   the keys dropped after each step; run twice from one seed, the stores
   must be bitwise equal.
8. "hybrid_parity": the tiny DLRM-DCNv2 on 2 spawned ranks against one
   card from one carried state, 3 steps and an eval
   (`tools/hybrid.py::parity_runs`): NCCL with a card per rank, or gloo
   with both ranks on one card. The parity phases run the masked-gather
   forward (`fwd_partition=False`), whose float32 sums are one card's.
   Then "hybrid_bench_parity": the tiny bench-configured model the same
   way, the ranks also evaluating the card's trained weights; and
   "hybrid_partial_parity": the tiny model with a partial placement
   (tables on 2 shards and on 1) on 4 ranks against one card, each shard's
   replicas bitwise equal. "hybrid_exchange_parity": 2 ranks on one card
   over gloo: the owner-partitioned forward of the tiny bench model against
   the masked one within per-key rounding, the ordered pool bitwise
   against its plain version on each rank's inputs, the unique-key dense
   exchange's two branches (lists of 64 and of 2 rows) against one card,
   a capacity factor that drops nothing against none, bitwise.
9. "hybrid_path": the full-width flagship (f32, global batch 16,384)
   trained hybrid-parallel on W = max(2, cards) ranks, at most 8, at the
   default owner-partitioned forward: launch counts per rank (the ordered
   pool once a model-parallel group and forward), the bytes of each
   collective a step, replicas bitwise equal across the ranks. "hybrid_bench_path": the same with
   `bench_settings()`, and each kernel held against its plain version on
   every rank's own inputs, the binned AUC beside the exact one.
   "hybrid_ftrl_dynamic_path": full-width DLRM-FTRL on dynamic tables over
   the W ranks, twice from one seed: each shard's store fill and dropped
   keys a step, no key in two shards' stores, each store bitwise equal
   across the runs.
   The meshes (PR 12): "mesh_parity" (before "hybrid_path"; the tiny model
   on the sorted route from one state, on the global batches of ranks on 2
   hosts: 4 ranks flat and as the (dcn, ici) = (2, 2) mesh with
   Hierarchical communication against one card, the ("data", "ev") (2, 2)
   mesh against 2 flat ranks bitwise, each rank's batch by the multi-host
   rule bitwise, the bf16 sums of 1.0 + 3 x 2^-9 over 4 ranks, a column
   split against the unsplit table bitwise, `group_rows` against no
   binning); "hybrid_hier_path" (after "hybrid_path": its f32 flagship on
   4 ranks as the (2, 2) mesh with Hierarchical communication, the DCN
   reduce-scatter's bytes 1 / I of the flat ones, each kernel against its
   plain version on every rank's inputs); "hybrid_column_path" (the f32
   flagship at W ranks with column factor 2 on its six sorted-route
   tables: segscan and the ordered pool at E 64 on every rank). The
   kernel phase adds both at E 64 at rank 0's shapes
   (`column_kernel_checks`).

10. The samples (`hugectr_tpu_torch/tools/samples.py`, the graphs of the
   JAX package's samples/*.py): "sample_kernels" holds each kernel against
   its plain version at the samples' widths and batch 2,048 (one-hot
   forward and backward on BST's category group at E 1, 11, 16, 18 and 32;
   segscan at the sorted-route K of WDL's wide table, DeepFM, DCN and DIN's
   item table, E 1 to 18), f32 and bf16, with times, bound and library
   call. "samples_parity": the tiny DeepFM (E 11, sorted route) and the
   tiny DIN (Dice, one-hot at E 18) on the card against the CPU from one
   state. "samples_path": each of the eleven graphs at its sample's own
   sizes, 6 steps and a 20-batch eval: ms/step, ex/s, peak memory, routes,
   launches a step, the step-1 and step-6 losses, the eval (both tasks'
   AUC for MMoE).

11. Snapshots and freezing (run after "ftrl_dynamic_path"; the last one
   after the hybrid phases), each with the card line: "snapshot_path" (the
   full-width static DLRM-FTRL after 3 steps written with
   `download_params_to_files` into a temporary directory and loaded by a
   model from another seed: every table, the FTRL state, the dense
   parameters and their state and the step bitwise; 3 more steps of both on
   the same batches within 1e-6 relative; the bytes written beside the
   plan's prediction, the seconds to write and to load, peak memory);
   "snapshot_dynamic_path" (the same on dynamic tables, key stores bitwise,
   then `embedding_dump` / `embedding_load` of table 3 with its
   key_store.npy: the same rows for the same keys); "snapshot_bf16" (the
   tiny bench-configured model: bf16 files as the JAX package writes them,
   2-byte voids, the split tables' merged views, a bitwise reload);
   "freeze_path" (the full-width static DLRM-FTRL with table 5 (one-hot),
   table 20 (a sorted group of its own) and the dense network frozen, 2
   steps: `onehot_bwd` 12 a step, segscan's K per group against the keys
   less the frozen slots, frozen rows and dense weights bitwise, each
   kernel against its plain version on these inputs; unfrozen, 1 step);
   "hybrid_snapshot" (the tiny DLRM-DCNv2 on 2 ranks: rank 0 alone writes,
   both reload bitwise).

12. Training from files: "file_path" (after "main_path"): the
   full-width f32 flagship from a RawAsync file that the port's
   `DataGenerator` writes (16 batches, 279,969,792 bytes; an eval file of
   73,728 rows) through the native reader, the `DeviceFeeder`'s pinned
   staging and copy stream and the on-device split: the native reader
   alone (batches/s, GB/s), the first three device batches bitwise
   against the file's rows, 6 steps (ms/step beside `main_path`'s cached
   batches, H2D bytes a batch, launches equal to `main_path`'s), each
   kernel against its plain version on the first file-fed batch, the eval
   (4 whole batches, the tail dropped, then EOF); "file_i64_path" (after
   "ftrl_dynamic_path"): the full-width dynamic DLRM-FTRL with
   `i64_input_key` from Norm files whose keys reach past 2^31 (tables 20
   and 21 at 2^40 rows): keys >= 2^31 a batch, the exact fold's host ms,
   injective maps, the store's fill, a snapshot with `i64_fold_maps.npz`
   reloaded bitwise and 3 resumed steps; "hybrid_file_parity" (after
   "hybrid_parity"): the tiny model from a Raw file on 2 ranks against one
   card.

13. Weighted lookups, dynamic-table upkeep, the host tiers and SOK:
   the kernel phase ends with each kernel's weighted case at the weighted
   configuration's shapes (`weighted_kernel_checks`: the superhot tier's
   weighted one-hot forward and backward, a privatised weighted backward,
   segscan over per-key rows at K = 16,384 x 20, the weighted ordered pool
   at rank 0's shapes, bitwise; a weighted row whose weights cancel is
   touched). "weighted_parity" (after "samples_parity"): a tiny weighted
   collection on the card against the CPU, and 2 ranks against one card
   (the weighted ordered pool, the dense exchange). "weighted_path" (after
   "ftrl_dynamic_path"): benchmarks/weighted_bench.py's table at full width,
   untiered and tiered, 6 steps each: ms/step, ex/s, routes, launches (the
   weighted one-hot kernels once a step each). "upkeep_path": the dynamic
   DLRM-FTRL, 3 steps, `evict`, `grow_dynamic_capacity` of the two tables
   that dropped most to 4x (every carried row, state and key bitwise), 3
   steps. "host_tier_path": `HostSpillTier` at
   benchmarks/host_spill_bench.py's settings (ex/s with and without the
   tier, rows staged a step, the master's size) and one
   `EmbeddingTrainingCache` pass. "sok_path": a `sok.LookupEngine` over
   DLRM-FTRL's 26 tables, 3 `OptimizerWrapper` steps, its lookup bitwise a
   collection's, `dump` / `load` bitwise. "hybrid_weighted_path" (after
   "hybrid_bench_path"): the tiered weighted table over W ranks, the
   weighted ordered pool on every rank, bitwise against its plain version
   on each rank's shapes.

Then a "kernels" JSON line (per kernel: source, the TPU kernel it replaces,
main-path launches, error, ms, device_ms, plain_ms, bound_ms, bound_by,
library_ms, for the float32 flagship case with the most device time; for
`onehot_fwd`, the 13-table group; beside them the file path's launches,
the bench path's launches and
the same numbers for its bf16 case with the most device time, and the FTRL
path's launches and its case with the most device time, the freeze
path's launches, each rank's
launches on the hybrid, hierarchical, column and hybrid bench paths, and
the per-rank bench case with the most device time, each sample graph's
launches and the sample-width case with the most device time, and for
segscan its E 64 case (`column_case`); and the ordered pool: its
launches on rank 0 of the hybrid path, steps and eval, beside its f32,
bf16 and E 64 cases; and each kernel's `weighted_case`: its bf16
weighted case with the most device time and its launches on
`weighted_path`, the ordered pool's on rank 0 of `hybrid_weighted_path`),
a line with the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Any failure exits non-zero before that line;
so does a machine without CUDA.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM float32, outside the tensor cores
B = 16384
E = 128
ALPHA = 1.05
# tolerances on |kernel - plain| / (sum of |inputs| into the element):
# float32 sums in another order (atomics for the backward); bfloat16 adds
# one rounding of the output (2^-8 relative)
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# the kernels of the paths on one card; the ordered pool runs over W > 1
# ranks only (the owner-partitioned forward)
ONE_CARD_KERNELS = ("onehot_fwd", "onehot_bwd", "segscan")
def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(fn, samples: int = 20, inner: int = 5, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scaled_err(got, want, scale) -> float:
    import torch

    d = (got.double() - want.double()).abs() / (scale.double() + 1e-30)
    return float(torch.nan_to_num(d, nan=math.inf).max()) if d.numel() else 0.0


def power_law(rng, vocab, size):
    import numpy as np

    x = rng.random(size)
    a = 1.0 - ALPHA
    y = ((float(vocab) ** a - 1.0) * x + 1.0) ** (1.0 / a)
    return np.clip(np.round(y) - 1.0, 0, vocab - 1).astype(np.int64)


def kernel_checks(torch, results):
    """Phase 2: each kernel against its plain version at the flagship's
    shapes (one-hot: tables 3, 24 and 5; segscan: table 21's K), then the
    edge cases of the designs."""
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms

    import numpy as np
    import torch.nn.functional as F

    from hugectr_tpu_torch.ops import onehot_matmul as oh
    from hugectr_tpu_torch.ops import segscan as ss

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    for name, v, h in (("table3", 7424, 2), ("table24", 108, 40), ("table5", 3, 1)):
        keys = torch.as_tensor(power_law(rng, v, (B, h)).astype(np.int32), device=dev)
        for dt in (torch.float32, torch.bfloat16):
            t0 = time.perf_counter()
            dname = str(dt).split(".")[1]
            table = torch.as_tensor(rng.standard_normal((v, E), dtype=np.float32), device=dev).to(dt)
            d = torch.as_tensor(rng.standard_normal((B, E), dtype=np.float32), device=dev).to(dt)
            isz = table.element_size()
            uniq = int(torch.unique(keys).numel())
            # forward
            got = oh.onehot_matmul_fwd(keys, table)
            want = oh.onehot_matmul_fwd_plain(keys, table)
            scale = oh.onehot_matmul_fwd_plain(keys, table.float().abs())
            torch.cuda.synchronize()
            err = scaled_err(got, want, scale)
            abs_err = float((got.float() - want.float()).abs().max())
            keys_l = keys.long()
            b_ms, b_by = bound(keys.numel() * 4 + uniq * E * isz + B * E * isz, B * h * E)
            dms, per_call = device_ms(lambda: oh.onehot_matmul_fwd(keys, table), KERNEL_NAMES["onehot_fwd"])
            rec = dict(
                kernel="onehot_fwd", case=name, dtype=dname, B=B, V=v, h=h, E=E,
                scaled_err=err, max_abs_err=abs_err, tol=TOL[dname],
                ms=time_ms(lambda: oh.onehot_matmul_fwd(keys, table)),
                device_ms=dms, device_launches_per_call=per_call,
                plain_ms=time_ms(lambda: oh.onehot_matmul_fwd_plain(keys, table)),
                library_ms=time_ms(lambda: F.embedding_bag(keys_l, table, mode="sum")),
                library="torch.nn.functional.embedding_bag(mode='sum')",
                bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms,
            )
            results.append(rec)
            # backward
            grad, cnt = oh.onehot_matmul_bwd(keys, d, v, dt)
            want_g, want_c = oh.onehot_matmul_bwd_plain(keys, d, v, dt)
            scale_g, _ = oh.onehot_matmul_bwd_plain(keys, d.float().abs(), v, torch.float32)
            torch.cuda.synchronize()
            cnt_ok = bool(torch.equal(cnt, want_c))
            d_rep = d.repeat_interleave(h, dim=0)
            flat = keys_l.reshape(-1)
            b_ms, b_by = bound(keys.numel() * 4 + B * E * isz + v * E * isz + v * 4, B * h * E)
            dms, per_call = device_ms(lambda: oh.onehot_matmul_bwd(keys, d, v, dt), KERNEL_NAMES["onehot_bwd"])

            def library():
                return torch.zeros((v, E), dtype=dt, device=dev).index_add_(0, flat, d_rep)

            rec2 = dict(
                kernel="onehot_bwd", case=name, dtype=dname, B=B, V=v, h=h, E=E,
                route=oh.bwd_route(B, h, v, E, dev),
                scaled_err=scaled_err(grad, want_g, scale_g),
                max_abs_err=float((grad.float() - want_g.float()).abs().max()),
                counts_exact=cnt_ok, tol=TOL[dname],
                ms=time_ms(lambda: oh.onehot_matmul_bwd(keys, d, v, dt)),
                device_ms=dms, device_launches_per_call=per_call,
                plain_ms=time_ms(lambda: oh.onehot_matmul_bwd_plain(keys, d, v, dt)),
                library_ms=time_ms(library),
                library_device_ms=device_ms(library, KERNEL_NAMES["index_add_"])[0],
                library="Tensor.index_add_ (grad only; library_device_ms: the index_add_ kernel)",
                bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms,
            )
            results.append(rec2)
            rec2["seconds"] = rec["seconds"] = time.perf_counter() - t0
            emit(rec)
            emit(rec2)
            if not (rec["scaled_err"] <= TOL[dname] and rec2["scaled_err"] <= TOL[dname] and cnt_ok):
                raise AssertionError(f"one-hot kernel disagrees with its plain version: {rec} {rec2}")
    # padding and ragged shapes: B and V not multiples of anything, -1 keys
    for v, h in ((57, 3), (600, 6)):
        keys_np = power_law(rng, v, (1000, h)).astype(np.int32)
        keys_np[rng.random(keys_np.shape) < 0.2] = -1
        keys = torch.as_tensor(keys_np, device=dev)
        table = torch.as_tensor(rng.standard_normal((v, 24), dtype=np.float32), device=dev)
        d = torch.as_tensor(rng.standard_normal((1000, 24), dtype=np.float32), device=dev)
        e1 = scaled_err(
            oh.onehot_matmul_fwd(keys, table), oh.onehot_matmul_fwd_plain(keys, table),
            oh.onehot_matmul_fwd_plain(keys, table.abs()),
        )
        g, c = oh.onehot_matmul_bwd(keys, d, v, torch.float32)
        wg, wc = oh.onehot_matmul_bwd_plain(keys, d, v, torch.float32)
        e2 = scaled_err(g, wg, oh.onehot_matmul_bwd_plain(keys, d.abs(), v, torch.float32)[0])
        emit(dict(kernel="onehot", case=f"padded_V{v}_h{h}", fwd_err=e1, bwd_err=e2,
                  counts_exact=bool(torch.equal(c, wc))))
        if not (e1 <= TOL["float32"] and e2 <= TOL["float32"] and torch.equal(c, wc)):
            raise AssertionError(f"one-hot kernel disagrees on padded keys (V={v}, h={h})")
    onehot_fwd_group_checks(torch, np, oh, dev, results)
    onehot_bwd_edges(torch, np, rng, oh, dev)
    segscan_checks(torch, np, rng, ss, dev, results)
    bench_shape_checks(torch, np, oh, ss, dev, results)
    bench_shape_checks(torch, np, oh, ss, dev, results, world=hybrid_world(torch))
    ftrl_shape_checks(torch, np, oh, ss, dev, results)
    ordered_pool_checks(torch, np, dev, results)
    column_kernel_checks(torch, np, dev, results)
    weighted_kernel_checks(torch, np, dev, results)


def ftrl_shape_checks(torch, np, oh, ss, dev, results):
    """The shapes the DLRM-FTRL path gives the kernels (`ftrl_plan()`,
    hotness 1, float32): the grouped forward of its 13-table one-hot group
    beside one embedding_bag call, the backward of each of the 13 tables
    (h 1) beside index_add_, and segscan at K 16,384 (the sorted keys of a
    400,000-row table, one key per sample)."""
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms
    from hugectr_tpu_torch.tools.flagship import ftrl_plan, onehot_group_inputs
    from hugectr_tpu_torch.tools.kernel_sweep import embedding_bag_call, group_bytes

    plan = ftrl_plan(ev_size=E)
    rng = np.random.default_rng(17)
    dt = torch.float32
    t0 = time.perf_counter()
    keys, lookups, table, width = onehot_group_inputs(rng, B, E, dt, dev, plan=plan)
    err, abs_err, launches, ok_shape = group_err(torch, oh, keys, lookups, table, width)
    b_ms, b_by = bound(group_bytes(keys, lookups, table, width), B * sum(k.shape[1] for k in keys) * E)
    call = lambda: oh.onehot_fwd_group(keys, lookups, table, width)  # noqa: E731
    dms, per_call = device_ms(call, KERNEL_NAMES["onehot_fwd"])
    lib = embedding_bag_call(keys, lookups, table)
    rec = dict(
        kernel="onehot_fwd", case=f"ftrl_group{len(lookups)}", dtype="float32", B=B, lookups=len(lookups),
        width=width, routes=[oh.fwd_route(lk.vocab, k.shape[1], E, dev) for k, lk in zip(keys, lookups)],
        scaled_err=err, max_abs_err=abs_err, tol=TOL["float32"], launches_per_call=launches,
        ms=time_ms(call), device_ms=dms, device_launches_per_call=per_call,
        plain_ms=time_ms(lambda: oh.onehot_fwd_group_plain(keys, lookups, table, width)),
        library_ms=time_ms(lib), library_device_ms=device_ms(lib, KERNEL_NAMES["embedding_bag"])[0],
        library="one torch.nn.functional.embedding_bag(mode='sum') over the group storage",
        bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0,
    )
    results.append(rec)
    emit(rec)
    if not (err <= TOL["float32"] and launches == 1 and per_call in (1, None) and ok_shape and len(lookups) == 13):
        raise AssertionError(f"DLRM-FTRL group forward disagrees or launched more than once: {rec}")
    g = next(x for x in plan.groups if x.compute_kind == "onehot")
    for lm in g.lookups:
        t0 = time.perf_counter()
        v = int(g.table_vocab[lm.table_index])
        keys = torch.as_tensor(power_law(rng, v, (B, 1)).astype(np.int32), device=dev)
        d = torch.as_tensor(rng.standard_normal((B, E), dtype=np.float32), device=dev)
        call = lambda: oh.onehot_matmul_bwd(keys, d, v, dt)  # noqa: E731
        grad, cnt = call()
        want_g, want_c = oh.onehot_matmul_bwd_plain(keys, d, v, dt)
        scale_g, _ = oh.onehot_matmul_bwd_plain(keys, d.abs(), v, dt)
        torch.cuda.synchronize()
        flat = keys.long().reshape(-1)

        def library():
            return torch.zeros((v, E), device=dev).index_add_(0, flat, d)

        b_ms, b_by = bound(B * 4 + B * E * 4 + v * E * 4 + v * 4, B * E)
        dms, per_call = device_ms(call, KERNEL_NAMES["onehot_bwd"])
        rec = dict(
            kernel="onehot_bwd", case=f"ftrl_table{g.tables[lm.table_index].name}", dtype="float32", B=B, V=v,
            h=1, E=E, route=oh.bwd_route(B, 1, v, E, dev), scaled_err=scaled_err(grad, want_g, scale_g),
            max_abs_err=float((grad - want_g).abs().max()), counts_exact=bool(torch.equal(cnt, want_c)),
            tol=TOL["float32"], ms=time_ms(call), device_ms=dms, device_launches_per_call=per_call,
            plain_ms=time_ms(lambda: oh.onehot_matmul_bwd_plain(keys, d, v, dt)),
            library_ms=time_ms(library), library_device_ms=device_ms(library, KERNEL_NAMES["index_add_"])[0],
            library="Tensor.index_add_ (grad only)", bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms,
            seconds=time.perf_counter() - t0,
        )
        results.append(rec)
        emit(rec)
        if not (rec["scaled_err"] <= TOL["float32"] and rec["counts_exact"]):
            raise AssertionError(f"DLRM-FTRL onehot_bwd disagrees with its plain version: {rec}")
    t0 = time.perf_counter()
    seg = np.sort(power_law(rng, 400_000, B))
    heads = torch.as_tensor(np.concatenate([[True], seg[1:] != seg[:-1]]), device=dev)
    vals = torch.as_tensor(rng.standard_normal((B, E), dtype=np.float32), device=dev)
    call = lambda: ss.segmented_sum_sorted(vals, heads)  # noqa: E731
    got = call()
    want = ss.segmented_sum_sorted_plain(vals, heads)
    scale = ss.segmented_sum_sorted_plain(vals.abs(), heads)
    torch.cuda.synchronize()
    b_ms, b_by = bound(2 * B * E * 4 + B, B * E)
    dms, per_call = device_ms(call, KERNEL_NAMES["segscan"])
    rec = dict(
        kernel="segscan", case=f"ftrl_K{B}", dtype="float32", K=B, E=E, segments=int(heads.sum()),
        scaled_err=scaled_err(got, want, scale), max_abs_err=float((got - want).abs().max()),
        tol=TOL["float32"], bitwise_repeat=bool(torch.equal(call(), got)), ms=time_ms(call), device_ms=dms,
        device_launches_per_call=per_call,
        plain_ms=time_ms(lambda: ss.segmented_sum_sorted_plain(vals, heads)),
        library_ms=None, library="none: no single PyTorch call computes a segmented scan",
        bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0,
    )
    results.append(rec)
    emit(rec)
    if not (rec["scaled_err"] <= TOL["float32"] and rec["bitwise_repeat"]):
        raise AssertionError(f"DLRM-FTRL segscan disagrees with its plain version: {rec}")


def bench_shape_checks(torch, np, oh, ss, dev, results, world: int = 1):
    """The shapes only bench.py's configuration gives the kernels: the seven
    superhot backwards (V 1,024 of the split tables' first rows, h 3 to
    100, power-law keys through the window [0, 1024), d in bf16 as the step
    gives it, float32 sums) and the bf16 segscan of table 20's cold tier
    (the valid keys of [131072, 2M) of 16,384 x 100 power-law keys: bf16
    rows, float32 sums). With `world` W > 1, the shapes of one of W ranks
    (case names end in `_w{W}`): the 20-lookup group forward and the
    superhot backwards on B/W rows, and the cold tier's segscan over the
    keys rank 0's shard owns among the 16,384 x 100 gathered ones."""
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms
    from hugectr_tpu_torch.tools.flagship import BENCH_PLAN, flagship_plan, raw_vocab

    plan = flagship_plan(ev_size=E, num_shards=world, **BENCH_PLAN)
    g = plan.groups[0]
    rng = np.random.default_rng(13 + world)
    b = B // world
    sfx = f"_w{world}" if world > 1 else ""
    if world > 1:
        bench_group_check(torch, np, oh, dev, results, plan, b, sfx)
    for lm in g.lookups:
        if not lm.windowed:
            continue
        t0 = time.perf_counter()
        v, h = int(g.table_vocab[lm.table_index]), lm.hotness
        raw = torch.as_tensor(power_law(rng, raw_vocab(plan, lm), (b, h)).astype(np.int32), device=dev)
        ok, local = oh.place_keys(oh.window_keys(raw, lm.key_lo, lm.key_hi), v)
        keys = torch.where(ok, local, -1).to(torch.int32)
        d = torch.as_tensor(rng.standard_normal((b, E), dtype=np.float32), device=dev).to(torch.bfloat16)
        grad, cnt = oh.onehot_matmul_bwd(keys, d, v, torch.float32)
        want_g, want_c = oh.onehot_matmul_bwd_plain(keys, d, v, torch.float32)
        scale_g, _ = oh.onehot_matmul_bwd_plain(keys, d.float().abs(), v, torch.float32)
        torch.cuda.synchronize()
        nkeys = int(ok.sum())
        valid = keys.reshape(-1) >= 0
        flat = keys.long().reshape(-1)[valid]
        d_rep = d.float().repeat_interleave(h, dim=0)[valid]

        def library():
            return torch.zeros((v, E), device=dev).index_add_(0, flat, d_rep)

        call = lambda: oh.onehot_matmul_bwd(keys, d, v, torch.float32)  # noqa: E731
        b_ms, b_by = bound(keys.numel() * 4 + b * E * 2 + v * E * 4 + v * 4, nkeys * E)
        dms, per_call = device_ms(call, KERNEL_NAMES["onehot_bwd"])
        rec = dict(
            kernel="onehot_bwd", case=f"superhot_{g.tables[lm.table_index].name}{sfx}", dtype="bfloat16",
            B=b, V=v, h=h, E=E, keys=nkeys, route=oh.bwd_route(b, h, v, E, dev),
            scaled_err=scaled_err(grad, want_g, scale_g),
            max_abs_err=float((grad - want_g).abs().max()), counts_exact=bool(torch.equal(cnt, want_c)),
            tol=TOL["float32"], ms=time_ms(call), device_ms=dms, device_launches_per_call=per_call,
            plain_ms=time_ms(lambda: oh.onehot_matmul_bwd_plain(keys, d, v, torch.float32)),
            library_ms=time_ms(library), library_device_ms=device_ms(library, KERNEL_NAMES["index_add_"])[0],
            library="Tensor.index_add_ over the valid keys (grad only)",
            bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0,
        )
        results.append(rec)
        emit(rec)
        # float32 sums of bf16 values: the float32 tolerance
        if not (rec["scaled_err"] <= TOL["float32"] and rec["counts_exact"]):
            raise AssertionError(f"superhot onehot_bwd disagrees with its plain version: {rec}")
    # the cold tier of table 20: the valid keys of its window (of rank 0's
    # shard over W ranks, as rows of that shard), sorted
    t0 = time.perf_counter()
    cold = next(x for x in plan.groups if x.name == "mp_ev128_20::cold")
    lm = cold.lookups[0]
    raw = torch.as_tensor(power_law(rng, raw_vocab(plan, lm), (B, lm.hotness)), device=dev)
    wk = oh.window_keys(raw, lm.key_lo, lm.key_hi)
    wk = wk[wk >= 0]
    if world > 1:
        wk = wk[(wk + int(cold.table_rotation[0])) % world == 0] // world
    ids = torch.sort(wk).values
    k = ids.numel()
    heads = torch.ones(k, dtype=torch.bool, device=dev)
    heads[1:] = ids[1:] != ids[:-1]
    vals = torch.as_tensor(rng.standard_normal((k, E), dtype=np.float32), device=dev).to(torch.bfloat16)
    call = lambda: ss.segmented_sum_sorted(vals, heads, torch.float32)  # noqa: E731
    got = call()
    want = ss.segmented_sum_sorted_plain(vals, heads, torch.float32)
    scale = ss.segmented_sum_sorted_plain(vals.float().abs(), heads)
    torch.cuda.synchronize()
    b_ms, b_by = bound(k * E * (2 + 4) + k, k * E)
    dms, per_call = device_ms(call, KERNEL_NAMES["segscan"])
    rec = dict(
        kernel="segscan", case=f"cold_tier_20{sfx}", dtype="bfloat16", out_dtype="float32", K=k,
        list_len=B * lm.hotness, E=E, segments=int(heads.sum()), scaled_err=scaled_err(got, want, scale),
        max_abs_err=float((got - want).abs().max()), tol=TOL["float32"], out_ok=got.dtype == torch.float32,
        bitwise_repeat=bool(torch.equal(call(), got)), ms=time_ms(call), device_ms=dms,
        device_launches_per_call=per_call, plain_ms=time_ms(lambda: ss.segmented_sum_sorted_plain(vals, heads, torch.float32)),
        library_ms=None, library="none: no single PyTorch call computes a segmented scan",
        bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0,
    )
    results.append(rec)
    emit(rec)
    if not (rec["scaled_err"] <= TOL["float32"] and rec["out_ok"] and rec["bitwise_repeat"]):
        raise AssertionError(f"bf16 cold-tier segscan disagrees with its plain version: {rec}")


def bench_group_check(torch, np, oh, dev, results, plan, batch: int, sfx: str):
    """The bench plan's 20-lookup one-hot group forward in bf16 on `batch`
    rows (one rank's block), beside one embedding_bag call."""
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms
    from hugectr_tpu_torch.tools.flagship import onehot_group_inputs
    from hugectr_tpu_torch.tools.kernel_sweep import embedding_bag_call, group_bytes

    t0 = time.perf_counter()
    keys, lookups, table, width = onehot_group_inputs(np.random.default_rng(11), batch, E, torch.bfloat16, dev,
                                                      plan=plan)
    err, abs_err, launches, ok_shape = group_err(torch, oh, keys, lookups, table, width)
    b_ms, b_by = bound(group_bytes(keys, lookups, table, width), batch * sum(k.shape[1] for k in keys) * E)
    call = lambda: oh.onehot_fwd_group(keys, lookups, table, width)  # noqa: E731
    dms, per_call = device_ms(call, KERNEL_NAMES["onehot_fwd"])
    lib = embedding_bag_call(keys, lookups, table)
    rec = dict(
        kernel="onehot_fwd", case=f"group{len(lookups)}{sfx}", dtype="bfloat16", B=batch, lookups=len(lookups),
        windowed=sum(lk.windowed for lk in lookups), width=width, scaled_err=err, max_abs_err=abs_err,
        tol=TOL["bfloat16"], launches_per_call=launches, ms=time_ms(call), device_ms=dms,
        device_launches_per_call=per_call,
        plain_ms=time_ms(lambda: oh.onehot_fwd_group_plain(keys, lookups, table, width)),
        library_ms=time_ms(lib), library_device_ms=device_ms(lib, KERNEL_NAMES["embedding_bag"])[0],
        library="one torch.nn.functional.embedding_bag(mode='sum') over the group storage",
        bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0,
    )
    results.append(rec)
    emit(rec)
    if not (err <= TOL["bfloat16"] and launches == 1 and per_call in (1, None) and ok_shape and len(lookups) == 20):
        raise AssertionError(f"bench group forward on one rank's rows disagrees: {rec}")


def group_err(torch, oh, keys, lookups, table, width):
    """Scaled error of one grouped launch against the plain version, and
    the launches it made."""
    from hugectr_tpu_torch import ops

    before = ops.launch_counts()["onehot_fwd"]
    got = oh.onehot_fwd_group(keys, lookups, table, width)
    launches = ops.launch_counts()["onehot_fwd"] - before
    want = oh.onehot_fwd_group_plain(keys, lookups, table, width)
    scale = oh.onehot_fwd_group_plain(keys, lookups, table.float().abs(), width)
    torch.cuda.synchronize()
    ok_shape = got.dtype == table.dtype and tuple(got.shape) == (keys[0].shape[0], width)
    return scaled_err(got, want, scale), float((got.float() - want.float()).abs().max()), launches, ok_shape


def onehot_fwd_group_checks(torch, np, oh, dev, results):
    """The grouped forward at the flagship's one-hot group (13 tables, keys
    as int32 column views of one [B, 62] tensor), f32 and bf16: error,
    launches per call (1), times beside the bound and one embedding_bag
    call over the group; then the edge cases."""
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms
    from hugectr_tpu_torch.tools.flagship import onehot_group_inputs
    from hugectr_tpu_torch.tools.kernel_sweep import embedding_bag_call, group_bytes

    from hugectr_tpu_torch.tools.flagship import BENCH_PLAN

    for (dt, plan_kw) in ((torch.float32, {}), (torch.bfloat16, {}), (torch.float32, BENCH_PLAN),
                          (torch.bfloat16, BENCH_PLAN)):
        t0 = time.perf_counter()
        dname = str(dt).split(".")[1]
        keys, lookups, table, width = onehot_group_inputs(np.random.default_rng(11), B, E, dt, dev, **plan_kw)
        err, abs_err, launches, ok_shape = group_err(torch, oh, keys, lookups, table, width)
        b_ms, b_by = bound(group_bytes(keys, lookups, table, width), B * sum(k.shape[1] for k in keys) * E)
        call = lambda: oh.onehot_fwd_group(keys, lookups, table, width)  # noqa: E731
        dms, per_call = device_ms(call, KERNEL_NAMES["onehot_fwd"])
        lib = embedding_bag_call(keys, lookups, table)
        rec = dict(
            kernel="onehot_fwd", case=f"group{len(lookups)}", dtype=dname, B=B, lookups=len(lookups),
            windowed=sum(lk.windowed for lk in lookups), width=width,
            routes=[oh.fwd_route(lk.vocab, k.shape[1], E, dev) for k, lk in zip(keys, lookups)],
            scaled_err=err, max_abs_err=abs_err, tol=TOL[dname], launches_per_call=launches,
            ms=time_ms(call), device_ms=dms, device_launches_per_call=per_call,
            plain_ms=time_ms(lambda: oh.onehot_fwd_group_plain(keys, lookups, table, width)),
            library_ms=time_ms(lib), library_device_ms=device_ms(lib, KERNEL_NAMES["embedding_bag"])[0],
            library="one torch.nn.functional.embedding_bag(mode='sum') over the group storage",
            bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms,
            seconds=time.perf_counter() - t0,
        )
        results.append(rec)
        emit(rec)
        # per_call is None when every profile came back empty (devtime.FALLBACKS)
        if not (err <= TOL[dname] and launches == 1 and per_call in (1, None) and ok_shape):
            raise AssertionError(f"grouped one-hot forward disagrees or launched more than once: {rec}")
    onehot_fwd_group_edges(torch, np, oh, dev)


def onehot_fwd_group_edges(torch, np, oh, dev):
    """Sum and Mean lookups; negative and >= V keys; int64 keys >= 2^31;
    all padding; h 1 beside h 128; a one-lookup group against the
    per-table forward; each in f32 and bf16. Every group but h 1 beside
    h 128 has a lookup on the counts matmul (V <= 128, h >= 16) beside
    gathered ones; h 1 beside h 128 gathers both (V 1,000)."""
    rng = np.random.default_rng(5)
    b = 4096

    def group(spec, int64=False, pad_all=False):
        cols, lookups, row = [], [], 0
        for i, (v, h, mean, *win) in enumerate(spec):
            lo, hi = win or (0, -1)
            k = rng.integers(0, v, size=(b, h)).astype(np.int64)
            r = rng.random((b, h))
            k[r < 0.1] = -1
            neg = (r >= 0.1) & (r < 0.2)
            k[neg] = -rng.integers(2, 5 * v, size=int(neg.sum()))
            k[(r >= 0.2) & (r < 0.3)] += 3 * v
            if int64:
                wide = (r >= 0.3) & (r < 0.45)
                k[wide] = 2**31 + rng.integers(0, 2**31, size=int(wide.sum()))
                k[(r >= 0.45) & (r < 0.5)] = 2**32 - 1
            if pad_all:
                k[:] = -1
            if win:  # raw keys of the parent table; the window's edges and beyond
                k = rng.integers(0, 3 * hi, size=(b, h)).astype(np.int64)
                k[r < 0.1] = -1
                edges = [lo - 1, lo, hi - 1, hi, hi + v, -2, -5 * v, 2**31 - 1]
                k[: len(edges), 0] = edges
            cols.append(k)
            lookups.append(oh.GroupLookup(row, v, i * E, mean, lo, hi))
            row += v
        allk = torch.as_tensor(np.concatenate(cols, 1).astype(np.int64 if int64 else np.int32), device=dev)
        keys, c = [], 0
        for _v, h, *_ in spec:
            keys.append(allk[:, c : c + h])
            c += h
        return keys, lookups, row, len(spec) * E

    cases = {
        "sum_and_mean": ([(108, 40, True), (7424, 2, False), (3, 1, True), (155, 5, True)], False, False),
        "negative_and_ge_v": ([(57, 16, False), (2209, 6, True)], False, False),
        "int64_ge_2^31": ([(108, 40, True), (7424, 2, False), (10, 1, False)], True, False),
        "all_padding": ([(108, 40, True), (63, 1, False)], False, True),
        "h1_beside_h128": ([(63, 1, False), (1000, 128, True)], False, False),
        # superhot tiers (V 1,024 of [0, 1024)), a hot tier [1024, 131072),
        # beside unwindowed lookups that wrap the same kinds of keys
        "window_edges": ([(1024, 100, False, 0, 1024), (108, 40, True), (1024, 3, True, 0, 1024),
                          (130048, 4, False, 1024, 131072), (7424, 2, False)], False, False),
    }
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        for name, (spec, int64, pad_all) in cases.items():
            keys, lookups, rows, width = group(spec, int64, pad_all)
            table = torch.as_tensor(rng.standard_normal((rows, E), dtype=np.float32), device=dev).to(dt)
            err, _a, launches, ok_shape = group_err(torch, oh, keys, lookups, table, width)
            rec = dict(kernel="onehot_fwd", case=name, dtype=dname,
                       routes=[oh.fwd_route(lk.vocab, k.shape[1], E, dev) for k, lk in zip(keys, lookups)],
                       scaled_err=err, tol=TOL[dname], launches=launches, shape_ok=ok_shape)
            emit(rec)
            if not (err <= TOL[dname] and launches == 1 and ok_shape):
                raise AssertionError(f"grouped one-hot forward edge case disagrees: {rec}")
            if pad_all and not bool((oh.onehot_fwd_group(keys, lookups, table, width) == 0).all()):
                raise AssertionError("all-padding group is not zero")
        # a one-lookup group equals the per-table forward (local keys in [-1, V))
        keys = torch.as_tensor(rng.integers(-1, 108, size=(B, 40)).astype(np.int32), device=dev)
        table = torch.as_tensor(rng.standard_normal((108, E), dtype=np.float32), device=dev).to(dt)
        g1 = oh.onehot_fwd_group([keys], [oh.GroupLookup(0, 108, 0, False)], table, E)
        err = scaled_err(oh.onehot_matmul_fwd(keys, table), g1,
                         oh.onehot_matmul_fwd_plain(keys, table.float().abs()))
        emit(dict(kernel="onehot_fwd", case="one_lookup_vs_per_table", dtype=dname, scaled_err=err))
        if not err <= TOL[dname]:
            raise AssertionError(f"one-lookup group != per-table forward: {err}")


def onehot_bwd_edges(torch, np, rng, oh, dev):
    """The backward's edge cases: every key on one row, V one below, at and
    one above the privatised route's shared-memory limit, the engine's
    largest table, all padding, bfloat16 output, accumulation into a
    caller's buffers."""
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms

    vt = oh.bwd_tile_rows(E, dev)
    cases = [("one_row", np.full((B, 40), 5, np.int32), 108, torch.float32)]
    # V one below and at the most rows the privatised route holds in shared
    # memory, and one above (global route)
    for v in (vt - 1, vt, vt + 1):
        cases.append((f"V{v}_h40", power_law(rng, v, (B, 40)).astype(np.int32), v, torch.float32))
    # the engine's largest table (global route) at high and low hotness
    for hh in (128, 2):
        cases.append((f"V8192_h{hh}", power_law(rng, 8192, (B, hh)).astype(np.int32), 8192,
                      torch.float32))
    cases.append(("all_padding", np.full((B, 3), -1, np.int32), 100, torch.float32))
    cases.append(("one_row_bf16", np.full((B, 40), 5, np.int32), 108, torch.bfloat16))
    for name, keys_np, v, dt in cases:
        keys = torch.as_tensor(keys_np, device=dev)
        d = torch.as_tensor(rng.standard_normal((B, E), dtype=np.float32), device=dev).to(dt)
        g, c = oh.onehot_matmul_bwd(keys, d, v, dt)
        wg, wc = oh.onehot_matmul_bwd_plain(keys, d, v, dt)
        sg, _ = oh.onehot_matmul_bwd_plain(keys, d.float().abs(), v, torch.float32)
        dname = str(dt).split(".")[1]
        rec = dict(kernel="onehot_bwd", case=name, dtype=dname, B=B, V=v, h=keys_np.shape[1],
                   tile_rows=vt, route=oh.bwd_route(B, keys_np.shape[1], v, E, dev),
                   scaled_err=scaled_err(g, wg, sg), tol=TOL[dname],
                   counts_exact=bool(torch.equal(c, wc)), dtype_ok=g.dtype == dt,
                   device_ms=device_ms(lambda: oh.onehot_matmul_bwd(keys, d, v, dt),
                                       KERNEL_NAMES["onehot_bwd"])[0])
        emit(rec)
        if not (rec["scaled_err"] <= TOL[dname] and rec["counts_exact"] and rec["dtype_ok"]):
            raise AssertionError(f"onehot_bwd edge case disagrees: {rec}")
    # accumulation into slices of a caller's buffers, as the collection does
    v, off = 3000, 500
    keys = torch.as_tensor(power_law(rng, v, (B, 6)).astype(np.int32), device=dev)
    d = torch.as_tensor(rng.standard_normal((B, E), dtype=np.float32), device=dev)
    base = torch.as_tensor(rng.standard_normal((off + v + 9, E), dtype=np.float32), device=dev)
    cbase = torch.arange(off + v + 9, dtype=torch.float32, device=dev)
    grad, cnt = base.clone(), cbase.clone()
    oh.onehot_matmul_bwd(keys, d, v, torch.float32, out=grad[off : off + v], cnt_out=cnt[off : off + v])
    wg, wc = oh.onehot_matmul_bwd_plain(keys, d, v, torch.float32)
    sg, _ = oh.onehot_matmul_bwd_plain(keys, d.abs(), v, torch.float32)
    err = scaled_err(grad[off : off + v] - base[off : off + v], wg, sg + base[off : off + v].abs())
    untouched = bool(torch.equal(grad[:off], base[:off]) and torch.equal(grad[off + v :], base[off + v :]))
    cnt_ok = bool(torch.equal(cnt[off : off + v], cbase[off : off + v] + wc)
                  and torch.equal(cnt[:off], cbase[:off]))
    emit(dict(kernel="onehot_bwd", case="accumulate_into_slice", V=v, scaled_err=err,
              counts_exact=cnt_ok, rest_untouched=untouched))
    if not (err <= TOL["float32"] and cnt_ok and untouched):
        raise AssertionError("onehot_bwd accumulation into a caller's slice disagrees")


def segscan_checks(torch, np, rng, ss, dev, results):
    """segscan at the largest sorted-route K (table 21: 16384 x 27), then
    its edge cases and two runs compared bitwise."""
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms

    k = B * 27
    seg = np.sort(power_law(rng, 2_000_000, k))
    heads = torch.as_tensor(np.concatenate([[True], seg[1:] != seg[:-1]]), device=dev)
    for dt in (torch.float32, torch.bfloat16):
        t0 = time.perf_counter()
        dname = str(dt).split(".")[1]
        vals = torch.as_tensor(rng.standard_normal((k, E), dtype=np.float32), device=dev).to(dt)
        got = ss.segmented_sum_sorted(vals, heads)
        want = ss.segmented_sum_sorted_plain(vals, heads)
        scale = ss.segmented_sum_sorted_plain(vals.float().abs(), heads)
        torch.cuda.synchronize()
        isz = vals.element_size()
        b_ms, b_by = bound(2 * k * E * isz + k, k * E)
        dms, per_call = device_ms(lambda: ss.segmented_sum_sorted(vals, heads), KERNEL_NAMES["segscan"])
        repeat_equal = all(torch.equal(ss.segmented_sum_sorted(vals, heads), got) for _ in range(2))
        rec = dict(
            kernel="segscan", case="K442368", dtype=dname, K=k, E=E,
            segments=int(heads.sum()), scaled_err=scaled_err(got, want, scale),
            max_abs_err=float((got.float() - want.float()).abs().max()), tol=TOL[dname],
            bitwise_repeat=repeat_equal,
            ms=time_ms(lambda: ss.segmented_sum_sorted(vals, heads)),
            device_ms=dms, device_launches_per_call=per_call,
            plain_ms=time_ms(lambda: ss.segmented_sum_sorted_plain(vals, heads)),
            library_ms=None, library="none: no single PyTorch call computes a segmented scan",
            bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms,
            seconds=time.perf_counter() - t0,
        )
        results.append(rec)
        emit(rec)
        if not (rec["scaled_err"] <= TOL[dname] and repeat_equal):
            raise AssertionError(f"segscan disagrees with its plain version: {rec}")
    t = ss.tile_rows()
    one_seg = np.zeros(k, bool)
    one_seg[0] = True
    cases = [("one_segment", one_seg), ("all_heads", np.ones(k, bool))]
    for kk in (t - 1, t + 1, 17, 0):
        seg = np.sort(rng.integers(0, max(kk // 3, 1), kk))
        cases.append((f"K{kk}", np.concatenate([[True], seg[1:] != seg[:-1]])[:kk]))
    for name, heads_np in cases:
        hd = torch.as_tensor(heads_np, device=dev)
        vals = torch.as_tensor(rng.standard_normal((len(heads_np), E), dtype=np.float32), device=dev)
        got = ss.segmented_sum_sorted(vals, hd)
        err = scaled_err(got, ss.segmented_sum_sorted_plain(vals, hd),
                         ss.segmented_sum_sorted_plain(vals.abs(), hd))
        rec = dict(kernel="segscan", case=name, K=len(heads_np), E=E, scaled_err=err,
                   tol=TOL["float32"], shape_ok=tuple(got.shape) == tuple(vals.shape),
                   bitwise_repeat=bool(torch.equal(ss.segmented_sum_sorted(vals, hd), got)))
        if len(heads_np) == k:
            rec["device_ms"] = device_ms(lambda: ss.segmented_sum_sorted(vals, hd), KERNEL_NAMES["segscan"])[0]
        emit(rec)
        if not (err <= TOL["float32"] and rec["shape_ok"] and rec["bitwise_repeat"]):
            raise AssertionError(f"segscan edge case disagrees: {rec}")


def bits(torch, t):
    """A float tensor's bits as integers, for bitwise comparisons."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def ordered_pool_checks(torch, np, dev, results):
    """The ordered pool (csrc/ordered_pool.cu) of the owner-partitioned
    forward against its plain version, bitwise, at the shapes of rank 0 of
    the hybrid phases' W ranks: the owned prefix of the gathered 16,384 x h
    power-law keys of the f32 flagship's table-20 group (h 100) and its
    5-lookup group, and of bench.py's configuration's bf16 cold and hot
    tiers of table 20; with its bound, the plain version's time, one
    `embedding_bag` over the same slots (float32 sums, no rounding after
    each add) and `index_add_` of the gathered rows. Then f32 and bf16 at E
    16, 128 and 13 (one-column lanes), slots of 1 to 100 rows, empty slots,
    repeated rows and keys of other shards; and two runs compared bitwise."""
    import torch.nn.functional as F

    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.core.types import Optimizer_t
    from hugectr_tpu_torch.embedding.collection import EmbeddingCollection
    from hugectr_tpu_torch.ops import ordered_pool as op
    from hugectr_tpu_torch.optim.params import OptParams
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms
    from hugectr_tpu_torch.tools.flagship import BENCH_PLAN, flagship_plan, raw_vocab

    w = hybrid_world(torch)
    rng = np.random.default_rng(17)
    gen = torch.Generator(device=dev).manual_seed(17)
    for label, dt, plan_kw, names in (("flagship", torch.float32, {}, ("mp_ev128_20", "mp_ev128")),
                                      ("bench", torch.bfloat16, BENCH_PLAN, ("mp_ev128_20::cold", "mp_ev128_20::hot"))):
        plan = flagship_plan(ev_size=E, num_shards=w, **plan_kw)
        ec = EmbeddingCollection(plan, ResourceManager(dev, 0, w), OptParams(Optimizer_t.RowWiseAdaGrad), dtype=dt)
        for gname in names:
            t0 = time.perf_counter()
            g = next(x for x in plan.groups if x.name == gname)
            raw = {}
            for lm in g.lookups:
                raw.setdefault(lm.bottom_name, torch.as_tensor(
                    power_law(rng, raw_vocab(plan, lm), (B, lm.hotness)).astype(np.int32), device=dev))
            srows, offsets, _w = ec._pool_segments(gname, ec._group_keys(g, raw), g.total_local_rows)
            n = offsets.numel() - 1
            table = torch.empty((g.total_local_rows, E), device=dev).normal_(generator=gen).to(dt)
            call = lambda: op.ordered_pool(table, srows, offsets)  # noqa: E731
            got = call()
            want = op.ordered_pool_plain(table, srows, offsets)
            torch.cuda.synchronize()
            pooled = srows < g.total_local_rows
            lens = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
                0, torch.repeat_interleave(torch.arange(n, device=dev), offsets.diff()), pooled.long())
            owned, slot_ids = srows[pooled], torch.repeat_interleave(torch.arange(n, device=dev), lens)
            obounds = torch.cat([lens.new_zeros(1), lens.cumsum(0)])
            k, isz = srows.numel(), table.element_size()
            uniq = int(torch.unique(owned).numel())  # each pooled table row read once
            # the row ids a warp reads: its slot's owned rows and the first
            # foreign one after them, where the slot has one
            ids_read = int(torch.minimum(lens + 1, offsets.diff()).sum())
            b_ms, b_by = bound(uniq * E * isz + ids_read * 8 + 8 * (n + 1) + n * E * isz, int(owned.numel()) * E)
            dms, per_call = device_ms(call, KERNEL_NAMES["ordered_pool"])
            rec = dict(
                kernel="ordered_pool", case=f"{label}_{gname}_w{w}", dtype=str(dt).split(".")[1], K=k, slots=n,
                E=E, owned=int(owned.numel()), ids_read=ids_read, unique_rows=uniq, max_slot_rows=int(lens.max()),
                empty_slots=int((lens == 0).sum()),
                bitwise=bool(torch.equal(bits(torch, got), bits(torch, want))),
                bitwise_repeat=bool(torch.equal(bits(torch, call()), bits(torch, got))),
                max_abs_err=float((got.float() - want.float()).abs().max()), tol=0.0,
                ms=time_ms(call), device_ms=dms, device_launches_per_call=per_call,
                plain_ms=time_ms(lambda: op.ordered_pool_plain(table, srows, offsets), samples=5, inner=1, warmup=1),
                library_ms=time_ms(lambda: F.embedding_bag(owned, table, obounds[:-1], mode="sum")),
                library="torch.nn.functional.embedding_bag(mode='sum', offsets) over the owned rows (float32 "
                        "sums, one rounding)",
                index_add_ms=time_ms(
                    lambda: torch.zeros((n, E), dtype=dt, device=dev).index_add_(0, slot_ids, table[owned])),
                bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0,
            )
            rec["scaled_err"] = 0.0 if rec["bitwise"] else math.inf
            results.append(rec)
            emit(rec)
            if not (rec["bitwise"] and rec["bitwise_repeat"]):
                raise AssertionError(f"ordered_pool differs from its plain version: {rec}")
    for dt in (torch.float32, torch.bfloat16):
        for e in (16, 128, 13):
            n = 3000
            lens = rng.integers(1, 101, size=n)
            lens[rng.random(n) < 0.2] = 0
            slots = torch.as_tensor(np.repeat(np.arange(n), lens), device=dev)
            # a tenth of the keys on another rank's shard (row id 500)
            rows = torch.as_tensor(np.minimum(rng.integers(0, 550, size=int(lens.sum())), 500), device=dev)
            srows, offsets = op.segments(rows, slots, n, 500)
            table = (torch.empty((500, e), device=dev).normal_(generator=gen)
                     * torch.exp2(torch.randint(-8, 4, (500, 1), device=dev, generator=gen).float())).to(dt)
            got = op.ordered_pool(table, srows, offsets)
            want = op.ordered_pool_plain(table, srows, offsets)
            ok = bool(torch.equal(bits(torch, got), bits(torch, want)))
            rec = dict(kernel="ordered_pool", case=f"edges_E{e}", dtype=str(dt).split(".")[1], slots=n,
                       K=int(lens.sum()), foreign=int((rows == 500).sum()), empty_slots=int((lens == 0).sum()),
                       max_slot_rows=int(lens.max()), bitwise=ok,
                       empty_slots_zero=bool((got[torch.as_tensor(lens == 0, device=dev)] == 0).all()))
            emit(rec)
            if not (ok and rec["empty_slots_zero"]):
                raise AssertionError(f"ordered_pool edge case differs from its plain version: {rec}")


def column_kernel_checks(torch, np, dev, results):
    """segscan and the ordered pool at E 64, the width of
    `hybrid_column_path`'s column-split sub-tables (factor 2 on the f32
    flagship's sorted-route tables), at rank 0's shapes of its W ranks:
    table 21's sub-table group (h 27, the largest K), the ordered pool of
    the owned prefix of the gathered 16,384 x 27 power-law keys, bitwise,
    and segscan over the sorted owned rows, float32; times beside the
    bound, the plain version, `embedding_bag` (the pool) and `index_add_`
    (segscan's sums per row, no running sums)."""
    import torch.nn.functional as F

    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.core.types import Optimizer_t
    from hugectr_tpu_torch.embedding.collection import EmbeddingCollection
    from hugectr_tpu_torch.ops import ordered_pool as op
    from hugectr_tpu_torch.ops import segscan as ss
    from hugectr_tpu_torch.optim.params import OptParams
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms
    from hugectr_tpu_torch.tools.flagship import flagship_plan, raw_vocab

    e, w = E // 2, hybrid_world(torch)
    rng = np.random.default_rng(23)
    gen = torch.Generator(device=dev).manual_seed(23)
    plan = flagship_plan(ev_size=e, num_shards=w)
    ec = EmbeddingCollection(plan, ResourceManager(dev, 0, w), OptParams(Optimizer_t.RowWiseAdaGrad))
    g = next(x for x in plan.groups if x.name == f"mp_ev{e}_21")
    raw = {lm.bottom_name: torch.as_tensor(power_law(rng, raw_vocab(plan, lm), (B, lm.hotness)).astype(np.int32),
                                           device=dev) for lm in g.lookups}
    keys = ec._group_keys(g, raw)
    table = torch.empty((g.total_local_rows, e), device=dev).normal_(generator=gen)
    # the ordered pool of the owned prefix
    t0 = time.perf_counter()
    srows, offsets, _w = ec._pool_segments(g.name, keys, g.total_local_rows)
    n = offsets.numel() - 1
    call = lambda: op.ordered_pool(table, srows, offsets)  # noqa: E731
    got, want = call(), op.ordered_pool_plain(table, srows, offsets)
    pooled = srows < g.total_local_rows
    lens = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, torch.repeat_interleave(torch.arange(n, device=dev), offsets.diff()), pooled.long())
    owned = srows[pooled]
    obounds = torch.cat([lens.new_zeros(1), lens.cumsum(0)])
    uniq = int(torch.unique(owned).numel())
    ids_read = int(torch.minimum(lens + 1, offsets.diff()).sum())
    b_ms, b_by = bound(uniq * e * 4 + ids_read * 8 + 8 * (n + 1) + n * e * 4, int(owned.numel()) * e)
    dms, per_call = device_ms(call, KERNEL_NAMES["ordered_pool"])
    rec = dict(kernel="ordered_pool", case=f"column_E{e}_21_w{w}", dtype="float32", K=srows.numel(), slots=n, E=e,
               owned=int(owned.numel()), unique_rows=uniq, bitwise=bool(torch.equal(bits(torch, got), bits(torch, want))),
               bitwise_repeat=bool(torch.equal(bits(torch, call()), bits(torch, got))),
               max_abs_err=float((got - want).abs().max()), tol=0.0, scaled_err=0.0,
               ms=time_ms(call), device_ms=dms, device_launches_per_call=per_call,
               plain_ms=time_ms(lambda: op.ordered_pool_plain(table, srows, offsets), samples=5, inner=1, warmup=1),
               library_ms=time_ms(lambda: F.embedding_bag(owned, table, obounds[:-1], mode="sum")),
               library="torch.nn.functional.embedding_bag(mode='sum', offsets) over the owned rows",
               bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0)
    results.append(rec)
    emit(rec)
    if not (rec["bitwise"] and rec["bitwise_repeat"]):
        raise AssertionError(f"ordered_pool differs from its plain version at E {e}: {rec}")
    # segscan over the sorted owned rows
    t0 = time.perf_counter()
    valid, owner, local_row = ec._slot_placement(g.name, keys)
    sidx = torch.sort(local_row[valid & (owner == 0)]).values
    k = int(sidx.numel())
    heads = torch.ones(k, dtype=torch.bool, device=dev)
    heads[1:] = sidx[1:] != sidx[:-1]
    vals = torch.empty((k, e), device=dev).normal_(generator=gen)
    call = lambda: ss.segmented_sum_sorted(vals, heads)  # noqa: E731
    got, want = call(), ss.segmented_sum_sorted_plain(vals, heads)
    scale = ss.segmented_sum_sorted_plain(vals.abs(), heads)
    b_ms, b_by = bound(2 * k * e * 4 + k, k * e)
    dms, per_call = device_ms(call, KERNEL_NAMES["segscan"])
    rec = dict(kernel="segscan", case=f"column_E{e}_21_w{w}", dtype="float32", K=k, E=e, segments=int(heads.sum()),
               scaled_err=scaled_err(got, want, scale), max_abs_err=float((got - want).abs().max()),
               tol=TOL["float32"], bitwise_repeat=bool(torch.equal(call(), got)),
               ms=time_ms(call), device_ms=dms, device_launches_per_call=per_call,
               plain_ms=time_ms(lambda: ss.segmented_sum_sorted_plain(vals, heads)),
               library_ms=time_ms(lambda: torch.zeros((g.total_local_rows, e), device=dev).index_add_(0, sidx, vals)),
               library="index_add_ of the rows' values (the segments' totals, not their running sums)",
               bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0)
    results.append(rec)
    emit(rec)
    if not (rec["scaled_err"] <= TOL["float32"] and rec["bitwise_repeat"]):
        raise AssertionError(f"segscan disagrees with its plain version at E {e}: {rec}")


# ---------------------------------------------------------------- samples
SAMPLE_B = 2048  # the samples' default batch (samples/common.py:26)
SAMPLE_WIDTHS = (1, 11, 16, 18, 32)  # WDL wide, DeepFM, most tables, DIN and BST users, NeuMF


def sample_sorted_rows(np, rng, slots, nnz: int = 1):
    """The sorted-route keys of a SparseEmbedding table in one step, as the
    synthetic reader draws them (power-law keys below the table's rows less
    the slot's offset, plus the offset): the sorted rows and their heads."""
    vocab = sum(slots)
    offsets = np.concatenate([[0], np.cumsum(slots)[:-1]])
    rows = np.concatenate([power_law(rng, vocab - off, (SAMPLE_B, nnz)) + off for off in offsets], axis=1)
    seg = np.sort(rows.reshape(-1))
    return seg, np.concatenate([[True], seg[1:] != seg[:-1]])


def bst_onehot_group(torch, np, rng, oh, e: int, dt, dev):
    """BST's one-hot group at width `e` (at e 16 the one its step runs):
    the history-category table (8,010 rows, one lookup of h 1 for each of
    its 10 slots, keys offset by 801 a slot) and the target-category table
    (801 rows). Returns (raw keys, lookups, storage, width)."""
    from hugectr_tpu_torch.tools.samples import CATE_VOCAB, SEQ

    hist = CATE_VOCAB * SEQ
    cols = [power_law(rng, hist - CATE_VOCAB * i, (SAMPLE_B, 1)) + CATE_VOCAB * i for i in range(SEQ)]
    cols.append(power_law(rng, CATE_VOCAB, (SAMPLE_B, 1)))
    allk = torch.as_tensor(np.concatenate(cols, axis=1).astype(np.int32), device=dev)
    keys = [allk[:, i : i + 1] for i in range(SEQ + 1)]
    lookups = [oh.GroupLookup(0, hist, i * e, False) for i in range(SEQ)]
    lookups.append(oh.GroupLookup(hist, CATE_VOCAB, SEQ * e, False))
    table = torch.as_tensor(rng.standard_normal((hist + CATE_VOCAB, e), dtype=np.float32), device=dev).to(dt)
    return keys, lookups, table, (SEQ + 1) * e


def sample_kernel_checks(torch, results):
    """Phase "sample_kernels": each kernel against its plain version at the
    samples' widths and batch 2,048, in float32 and bfloat16. The grouped
    one-hot forward and the backward of its 8,010-row table on BST's
    category group at E 1, 11, 16, 18 and 32 (E 16 is BST's own step; E
    1, 11 and 18 take the one-element lanes, and only E 16 and 32 may take
    the counts matmul); segscan at the sorted-route K of WDL's wide table
    (E 1, K 4,096), DeepFM's table (E 11, K 53,248), DCN's (E 16, K 106,496:
    two keys a slot) and DIN's item table (E 18, K 22,528). Limits as in
    `kernel_checks`; times, bound and library call for each case."""
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms
    from hugectr_tpu_torch.tools.kernel_sweep import embedding_bag_call, group_bytes
    from hugectr_tpu_torch.tools.samples import CRITEO_SLOTS, DCN_SLOTS, GOOD_VOCAB, SEQ, WDL_WIDE_SLOTS

    import numpy as np

    from hugectr_tpu_torch.ops import onehot_matmul as oh
    from hugectr_tpu_torch.ops import segscan as ss

    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    for e in SAMPLE_WIDTHS:
        for dt in (torch.float32, torch.bfloat16):
            t0 = time.perf_counter()
            dname = str(dt).split(".")[1]
            keys, lookups, table, width = bst_onehot_group(torch, np, rng, oh, e, dt, dev)
            err, abs_err, launches, ok_shape = group_err(torch, oh, keys, lookups, table, width)
            call = lambda: oh.onehot_fwd_group(keys, lookups, table, width)  # noqa: E731
            dms, per_call = device_ms(call, KERNEL_NAMES["onehot_fwd"])
            b_ms, b_by = bound(group_bytes(keys, lookups, table, width), SAMPLE_B * len(keys) * e)
            lib = embedding_bag_call(keys, lookups, table)
            rec = dict(
                phase="sample_kernels", kernel="onehot_fwd", case=f"sample_bst_group_E{e}", dtype=dname,
                B=SAMPLE_B, lookups=len(lookups), E=e, width=width,
                routes=sorted({oh.fwd_route(lk.vocab, k.shape[1], e, dev) for k, lk in zip(keys, lookups)}),
                scaled_err=err, max_abs_err=abs_err, tol=TOL[dname], launches_per_call=launches,
                ms=time_ms(call), device_ms=dms, device_launches_per_call=per_call,
                plain_ms=time_ms(lambda: oh.onehot_fwd_group_plain(keys, lookups, table, width)),
                library_ms=time_ms(lib), library_device_ms=device_ms(lib, KERNEL_NAMES["embedding_bag"])[0],
                library="one torch.nn.functional.embedding_bag(mode='sum') over the group",
                bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms,
            )
            # the backward of the history table: its 10 lookups' keys, local
            valid, local = oh.place_keys(torch.cat(keys[:SEQ], dim=1), lookups[0].vocab)
            k_rel = torch.where(valid, local, -1).to(torch.int32).contiguous()
            v = lookups[0].vocab
            d = torch.as_tensor(rng.standard_normal((SAMPLE_B, e), dtype=np.float32), device=dev).to(dt)
            grad, cnt = oh.onehot_matmul_bwd(k_rel, d, v, dt)
            want_g, want_c = oh.onehot_matmul_bwd_plain(k_rel, d, v, dt)
            scale_g, _ = oh.onehot_matmul_bwd_plain(k_rel, d.float().abs(), v, torch.float32)
            torch.cuda.synchronize()
            cnt_ok = bool(torch.equal(cnt, want_c))
            flat = k_rel.reshape(-1).long()
            keep = flat >= 0
            d_rep = d.repeat_interleave(k_rel.shape[1], dim=0)[keep]
            isz = d.element_size()

            def library():
                return torch.zeros((v, e), dtype=dt, device=dev).index_add_(0, flat[keep], d_rep)

            b_ms2, b_by2 = bound(k_rel.numel() * 4 + SAMPLE_B * e * isz + v * e * isz + v * 4,
                                 k_rel.numel() * e)
            dms2, per_call2 = device_ms(lambda: oh.onehot_matmul_bwd(k_rel, d, v, dt), KERNEL_NAMES["onehot_bwd"])
            rec2 = dict(
                phase="sample_kernels", kernel="onehot_bwd", case=f"sample_bst_hist_E{e}", dtype=dname,
                B=SAMPLE_B, V=v, h=k_rel.shape[1], E=e, route=oh.bwd_route(SAMPLE_B, k_rel.shape[1], v, e, dev),
                scaled_err=scaled_err(grad, want_g, scale_g),
                max_abs_err=float((grad.float() - want_g.float()).abs().max()), counts_exact=cnt_ok,
                tol=TOL[dname], ms=time_ms(lambda: oh.onehot_matmul_bwd(k_rel, d, v, dt)), device_ms=dms2,
                device_launches_per_call=per_call2,
                plain_ms=time_ms(lambda: oh.onehot_matmul_bwd_plain(k_rel, d, v, dt)),
                library_ms=time_ms(library), library_device_ms=device_ms(library, KERNEL_NAMES["index_add_"])[0],
                library="Tensor.index_add_ (grad only; library_device_ms: the index_add_ kernel)",
                bound_ms=b_ms2, bound_by=b_by2, bound_fraction=b_ms2 / dms2,
            )
            rec2["seconds"] = rec["seconds"] = time.perf_counter() - t0
            results += [rec, rec2]
            emit(rec)
            emit(rec2)
            if not (err <= TOL[dname] and launches == 1 and per_call in (1, None) and ok_shape
                    and rec2["scaled_err"] <= TOL[dname] and cnt_ok):
                raise AssertionError(f"one-hot kernels disagree at the samples' width E {e}: {rec} {rec2}")
    cases = (("wdl_wide", 1, WDL_WIDE_SLOTS, 1), ("deepfm", 11, CRITEO_SLOTS, 1), ("dcn", 16, DCN_SLOTS, 2),
             ("din_good", 18, [GOOD_VOCAB] * 11, 1))
    for name, e, slots, nnz in cases:
        seg, heads_np = sample_sorted_rows(np, rng, slots, nnz)
        heads = torch.as_tensor(heads_np, device=dev)
        k = len(seg)
        for dt in (torch.float32, torch.bfloat16):
            t0 = time.perf_counter()
            dname = str(dt).split(".")[1]
            vals = torch.as_tensor(rng.standard_normal((k, e), dtype=np.float32), device=dev).to(dt)
            got = ss.segmented_sum_sorted(vals, heads)
            want = ss.segmented_sum_sorted_plain(vals, heads)
            scale = ss.segmented_sum_sorted_plain(vals.float().abs(), heads)
            torch.cuda.synchronize()
            repeat_equal = all(torch.equal(ss.segmented_sum_sorted(vals, heads), got) for _ in range(2))
            isz = vals.element_size()
            b_ms, b_by = bound(2 * k * e * isz + k, k * e)
            dms, per_call = device_ms(lambda: ss.segmented_sum_sorted(vals, heads), KERNEL_NAMES["segscan"])
            rec = dict(
                phase="sample_kernels", kernel="segscan", case=f"sample_{name}_E{e}", dtype=dname, K=k, E=e,
                segments=int(heads_np.sum()), scaled_err=scaled_err(got, want, scale),
                max_abs_err=float((got.float() - want.float()).abs().max()), tol=TOL[dname],
                bitwise_repeat=repeat_equal, ms=time_ms(lambda: ss.segmented_sum_sorted(vals, heads)),
                device_ms=dms, device_launches_per_call=per_call,
                plain_ms=time_ms(lambda: ss.segmented_sum_sorted_plain(vals, heads)),
                library_ms=None, library="none: no single PyTorch call computes a segmented scan",
                bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0,
            )
            results.append(rec)
            emit(rec)
            if not (rec["scaled_err"] <= TOL[dname] and repeat_equal):
                raise AssertionError(f"segscan disagrees at the samples' width E {e}: {rec}")


def adam_excess(np, got, want, v, lr, rtol=1e-4, atol=1e-5):
    """(weights beyond rtol / atol, the largest difference among them):
    those whose gradient is rounding (sqrt(v) < 1e-9) must stay within 3
    lr, and at most one in 10,000 of the others (at least one) within 0.1
    lr, as tests/test_torch_samples.py holds the port to the JAX package
    (Adam divides a gradient by its own size)."""
    diff = np.abs(got - want)
    bad = diff > atol + rtol * np.abs(want)
    noise = np.zeros(want.shape, bool) if v is None else np.sqrt(v) < 1e-9
    rest = bad & ~noise
    ok = (np.isfinite(got).all() and (diff[noise] <= 3 * lr).all() and rest.sum() <= max(1, want.size // 10000)
          and (diff[rest] <= 0.1 * lr).all())
    return ok, int(bad.sum()), float(diff.max(initial=0.0))


def samples_parity(torch):
    """Phase "samples_parity": the tiny DeepFM (E 11, on the sorted route:
    segscan) and the tiny DIN (Dice, FusedReshapeConcat; its user table in
    the one-hot group at E 18, its item tables sorted) trained 3 steps on
    the card and on the CPU from the same state, then each evaluating the
    card's weights. Limits: loss rtol 1e-4; tables and dense parameters
    rtol 1e-4 / atol 1e-5 with the Adam exceptions of `adam_excess`; the
    eval AUC within 1e-4 (the card's sums in another order may swap
    predictions that tie to 1e-7)."""
    import numpy as np

    from hugectr_tpu_torch import ops
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools.carry import export_state, load_jax_state
    from hugectr_tpu_torch.tools.samples import build_tiny_sample

    for name, kw in (("deepfm", dict(dense_update_rows=0)), ("din", {})):
        t0 = time.perf_counter()
        gpu = build_tiny_sample(name, ResourceManager.create(), **kw)
        cpu = build_tiny_sample(name, ResourceManager.create(device="cpu"), **kw)
        load_jax_state(cpu, export_state(gpu))
        ops.reset_counts()
        losses = [(gpu.train(), cpu.train()) for _ in range(3)]
        launches = ops.launch_counts()
        g_state, c_state = export_state(gpu), export_state(cpu)
        lr = gpu.solver.lr
        checks = {}
        for g, want in c_state["emb_tables"].items():
            checks[f"table {g}"] = adam_excess(np, g_state["emb_tables"][g], want,
                                               c_state["eopt"][g].get("v"), lr)
        for layer, ps in c_state["dense_params"].items():
            for k, want in ps.items():
                checks[f"{layer}/{k}"] = adam_excess(np, g_state["dense_params"][layer][k], want,
                                                     c_state["dopt"]["v"][layer][k], lr)
        load_jax_state(cpu, g_state)
        ev = (gpu.eval(), cpu.eval())
        rec = dict(phase="samples_parity", sample=name, losses=losses, routes=dict(gpu.ec.group_routes),
                   launches=launches, beyond_tolerance={k: c[1:] for k, c in checks.items() if c[1]},
                   eval=ev, seconds=time.perf_counter() - t0)
        emit(rec)
        for lg, lc in losses:
            if not (math.isfinite(lg) and abs(lg - lc) <= 1e-4 * abs(lc)):
                raise AssertionError(f"tiny {name} loss on the card {lg} != CPU {lc}")
        bad = [k for k, c in checks.items() if not c[0]]
        if bad or abs(ev[0]["auc"] - ev[1]["auc"]) > 1e-4:
            raise AssertionError(f"tiny {name} on the card differs from the CPU in {bad}: {rec}")
        if launches["segscan"] <= 0 or (name == "din" and min(launches[k] for k in ONE_CARD_KERNELS) <= 0):
            raise AssertionError(f"tiny {name} on the card launched {launches}")


def samples_path(torch):
    """Phase "samples_path": each graph of `tools/samples.py::GRAPHS` at
    its sample's own sizes (slot sizes, widths, optimizer, batch 2,048,
    dropout 0.5) on synthetic learnable data: 6 steps, then a warm-up eval
    and a timed one over 20 batches, launch counters set to 0 just before
    the steps and the timed eval and read just after. One line per graph:
    median ms/step of steps 2-6, train and eval ex/s, peak memory, routes,
    each kernel's launches a step, the step-1 and step-6 losses (a loss
    that does not fall is printed, not failed), the eval (each task's AUC
    for MMoE). Non-finite losses fail; so does a kernel that no graph
    launches, and BST's one-hot group if it is not the one
    `bst_onehot_group` checks."""
    from hugectr_tpu_torch import ops
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.embedding.collection import onehot_fwd_lookups
    from hugectr_tpu_torch.tools.samples import CATE_VOCAB, GRAPHS, SEQ, build_sample

    out = {}
    for name, variant in GRAPHS:
        graph = variant or name
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model = build_sample(name, ResourceManager.create(), variant=variant, synthetic_batches=6,
                             synthetic_learnable=True, max_eval_batches=20)
        model.start_data_reading()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ops.reset_counts()
        losses, step_s = [], []
        for _ in range(6):
            t = time.perf_counter()
            losses.append(model.train())
            step_s.append(time.perf_counter() - t)
        train_launches = ops.launch_counts()
        model.eval()  # warm-up: makes the eval batches and puts them on the card
        ops.reset_counts()
        t = time.perf_counter()
        vals = model.eval()
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t
        eval_launches = ops.launch_counts()
        steady = statistics.median(step_s[1:])
        onehot = [g for g in model.ec.plan.groups if g.compute_kind == "onehot"]
        rec = dict(
            phase="samples_path", graph=graph, batch=SAMPLE_B, steps=6,
            tables={g.name: [g.total_storage_rows, g.ev_size] for g in model.ec.plan.groups},
            median_ms_per_step=steady * 1e3, train_examples_per_s=SAMPLE_B / steady,
            eval_batches=20, eval_seconds=eval_s, eval_examples_per_s=20 * SAMPLE_B / eval_s,
            max_memory_allocated=torch.cuda.max_memory_allocated(), routes=dict(model.ec.group_routes),
            launches_per_step={k: n / 6 for k, n in train_launches.items()}, eval_launches=eval_launches,
            loss_step1=losses[0], loss_step6=losses[-1], loss_fell=losses[-1] < losses[0], eval=vals,
            build_seconds=build_s, seconds=time.perf_counter() - t0,
        )
        emit(rec)
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite loss on the {graph} path: {losses}")
        if graph == "bst":
            got = sorted((lk.row_off, lk.vocab) for g in onehot if g.ev_size == 16 for lk in onehot_fwd_lookups(g))
            want = sorted([(0, CATE_VOCAB * SEQ)] * SEQ + [(CATE_VOCAB * SEQ, CATE_VOCAB)])
            if got != want or train_launches["onehot_fwd"] != 6 * len(onehot):
                raise AssertionError(f"BST's one-hot group {got}, {train_launches['onehot_fwd']} launches in 6 steps")
        out[graph] = {k: train_launches[k] + eval_launches[k] for k in train_launches}
        del model
        torch.cuda.empty_cache()
    missing = [k for k in ONE_CARD_KERNELS if not any(x[k] for x in out.values())]
    if missing:
        raise AssertionError(f"no sample launched {missing}")
    return out


def tiny_parity(torch):
    """Phase 3: the port's tiny DLRM on the card (kernels) and on the CPU
    (plain versions) from the same state, 3 steps."""
    import numpy as np

    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools.carry import export_state, load_jax_state
    from hugectr_tpu_torch.tools.flagship import build_tiny_dlrm

    t0 = time.perf_counter()
    kw = dict(batchsize=64, onehot_vocab=100, dense_update_rows=0, dense_key_ratio=0)
    gpu = build_tiny_dlrm(ResourceManager.create(), **kw)
    cpu = build_tiny_dlrm(ResourceManager.create(device="cpu"), **kw)
    load_jax_state(cpu, export_state(gpu))
    losses = [(gpu.train(), cpu.train()) for _ in range(3)]
    table_err = max(
        float(np.abs(gpu.tables[g].cpu().numpy() - cpu.tables[g].numpy()).max()) for g in gpu.tables
    )
    rec = dict(phase="tiny_parity", losses=losses, routes=dict(gpu.ec.group_routes),
               max_table_abs_err=table_err, seconds=time.perf_counter() - t0)
    emit(rec)
    for lg, lc in losses:
        if not abs(lg - lc) <= 1e-4 * abs(lc):
            raise AssertionError(f"tiny DLRM loss on the card {lg} != CPU {lc}")
    if not table_err <= 1e-5:
        raise AssertionError(f"tiny DLRM tables differ by {table_err}")
    tiny_bench_parity(torch)
    tiny_ftrl_parity(torch)


def ftrl_excess(np, got, want, z, lambda1, rtol=1e-4, atol=1e-5, band=1e-6):
    """(largest |got - want| beyond atol + rtol |want|, elements left out):
    FTRL weights whose z lies within `band` of lambda1 may take either side
    of the threshold, so they are left out and counted."""
    near = np.zeros(want.shape, bool) if z is None else np.abs(np.abs(z) - lambda1) <= band
    excess = np.abs(got - want) - atol - rtol * np.abs(want)
    return float(np.where(near, -np.inf, excess).max(initial=-np.inf)), int(near.sum())


def tiny_ftrl_parity(torch):
    """The tiny DLRM-FTRL (`build_tiny_dlrm_ftrl`), static (kernels on the
    card) and with exact dynamic tables, on the card and on the CPU from
    the same state, 3 steps. Tolerances: loss rtol 1e-4; tables, dense
    parameters and the FTRL state z and n rtol 1e-4 / atol 1e-5 (float32
    sums in another order), weights whose z lies within 1e-6 of lambda1
    left out, counted, and at most 1% of them; key stores bitwise equal."""
    import numpy as np

    from hugectr_tpu_torch import ops
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools.carry import export_state, load_jax_state
    from hugectr_tpu_torch.tools.flagship import build_tiny_dlrm_ftrl

    for dynamic in (False, True):
        t0 = time.perf_counter()
        gpu = build_tiny_dlrm_ftrl(ResourceManager.create(), dynamic=dynamic)
        cpu = build_tiny_dlrm_ftrl(ResourceManager.create(device="cpu"), dynamic=dynamic)
        load_jax_state(cpu, export_state(gpu))
        ops.reset_counts()
        losses = [(gpu.train(), cpu.train()) for _ in range(3)]
        launches = ops.launch_counts()
        g_state, c_state = export_state(gpu), export_state(cpu)
        lambda1 = gpu.opt_params.lambda1
        worst, left_out, total, keys_equal = -math.inf, 0, 0, True
        for g, want in c_state["emb_tables"].items():
            got = g_state["emb_tables"][g]
            if g.endswith("#keys"):
                keys_equal = keys_equal and bool(np.array_equal(got, want))
                continue
            e, n = ftrl_excess(np, got, want, c_state["eopt"][g]["z"], lambda1)
            worst, left_out, total = max(worst, e), left_out + n, total + want.size
            for k in ("z", "n"):
                worst = max(worst, ftrl_excess(np, g_state["eopt"][g][k], c_state["eopt"][g][k], None, lambda1)[0])
        for layer, ps in c_state["dense_params"].items():
            for k, want in ps.items():
                e, n = ftrl_excess(np, g_state["dense_params"][layer][k], want, c_state["dopt"]["z"][layer][k],
                                   lambda1)
                worst, left_out, total = max(worst, e), left_out + n, total + want.size
                for s in ("z", "n"):
                    worst = max(worst, ftrl_excess(np, g_state["dopt"][s][layer][k], c_state["dopt"][s][layer][k],
                                                   None, lambda1)[0])
        rec = dict(phase="tiny_ftrl_parity", dynamic=dynamic, losses=losses, routes=dict(gpu.ec.group_routes),
                   launches=launches, worst_excess_over_tolerance=worst, threshold_elements_left_out=left_out,
                   elements=total, key_stores_equal=keys_equal,
                   key_store_fill=[int((t != 2**31 - 1).sum()) for g, t in g_state["emb_tables"].items()
                                   if g.endswith("#keys")],
                   seconds=time.perf_counter() - t0)
        emit(rec)
        for lg, lc in losses:
            if not (math.isfinite(lg) and abs(lg - lc) <= 1e-4 * abs(lc)):
                raise AssertionError(f"tiny DLRM-FTRL (dynamic={dynamic}) loss on the card {lg} != CPU {lc}")
        if not (worst <= 0 and left_out <= total // 100 and keys_equal):
            raise AssertionError(f"tiny DLRM-FTRL (dynamic={dynamic}) on the card differs from the CPU: {rec}")
        if not dynamic and min(launches[k] for k in ONE_CARD_KERNELS) <= 0:
            raise AssertionError(f"tiny DLRM-FTRL on the card launched no {launches}")


def tiny_bench_parity(torch):
    """The tiny DLRM-DCNv2 with bench.py's settings scaled down (bf16
    tables and state, mixed precision, a split with a superhot tier,
    learnable labels, the binned AUC) on the card and on the CPU from the
    same state: 3 steps, then eval. Tolerances: step 1 loss rtol 1e-3 (the
    same state; the card's bf16 GEMMs sum in another order and take the
    gradients' products from bf16-rounded cotangents); steps 2-3 rtol 2e-2
    (the first AdaGrad step moves a dense parameter by +-lr by the sign of
    its gradient, and a gradient within a rounding of zero may take either
    sign); eval of the same (carried) weights: AUC within 1e-3, AverageLoss
    rtol 1e-3."""
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools.carry import export_state, load_jax_state
    from hugectr_tpu_torch.tools.flagship import TINY_BENCH, bench_settings, build_dlrm_dcnv2
    from hugectr_tpu_torch.tools.hybrid import METRICS

    t0 = time.perf_counter()
    kw = dict(bench_settings(), **TINY_BENCH, metrics_spec=METRICS)
    gpu = build_dlrm_dcnv2(ResourceManager.create(), **kw)
    cpu = build_dlrm_dcnv2(ResourceManager.create(device="cpu"), **kw)
    load_jax_state(cpu, export_state(gpu))
    losses = [(gpu.train(), cpu.train()) for _ in range(3)]
    own = (gpu.eval()["auc"], cpu.eval()["auc"])
    load_jax_state(cpu, export_state(gpu))
    ev = (gpu.eval(), cpu.eval())
    rec = dict(phase="tiny_bench_parity", losses=losses, routes=dict(gpu.ec.group_routes),
               own_weights_auc=own, same_weights_eval=ev, seconds=time.perf_counter() - t0)
    emit(rec)
    for i, (lg, lc) in enumerate(losses):
        if not (math.isfinite(lg) and abs(lg - lc) <= (1e-3 if i == 0 else 2e-2) * abs(lc)):
            raise AssertionError(f"tiny bench-configured DLRM loss on the card {lg} != CPU {lc} (step {i + 1})")
    g, c = ev
    if not (abs(g["auc"] - c["auc"]) <= 1e-3 and abs(g["average_loss"] - c["average_loss"])
            <= 1e-3 * abs(c["average_loss"])):
        raise AssertionError(f"tiny bench-configured DLRM eval on the card {g} != CPU {c}")


def main_path(torch):
    """Phase 4: the full-width flagship, 6 training steps."""
    from hugectr_tpu_torch import ops
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools.flagship import build_dlrm_dcnv2

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_dlrm_dcnv2(
        ResourceManager.create(), batchsize=B, ev_size=E, vocab_cap=2_000_000,
        synthetic_batches=6, optimizer="rowwise_adagrad",
    )
    model.start_data_reading()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ops.reset_counts()
    losses, step_s = [], []
    for _ in range(6):
        t = time.perf_counter()
        losses.append(model.train())
        step_s.append(time.perf_counter() - t)
    launches = ops.launch_counts()
    steady = statistics.median(step_s[1:])
    rec = dict(
        phase="main_path", tables=26, ev=E, batch=B, vocab_cap=2_000_000, steps=6,
        losses=losses, step_ms=[s * 1e3 for s in step_s], median_ms_per_step=steady * 1e3,
        examples_per_s=B / steady, max_memory_allocated=torch.cuda.max_memory_allocated(),
        routes=dict(model.ec.group_routes), route_counts=dict(model.ec.route_counts),
        launches=launches, build_seconds=build_s, seconds=time.perf_counter() - t0,
    )
    emit(rec)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss on the main path: {losses}")
    missing = [k for k in ONE_CARD_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if launches["onehot_fwd"] != 6:  # one grouped launch per step
        raise AssertionError(f"onehot_fwd launched {launches['onehot_fwd']} times in 6 steps, not 6")
    return launches, rec


def bench_path(torch):
    """Phase 5: the flagship as bench.py configures it, at full width
    (`bench_settings()`: batch 16,384, vocab_cap 2M, ev 128, bf16 tables and
    state, mixed precision, hot 131,072 / superhot 1,024 / split vocab
    16,384): 6 training steps, then one warm-up `eval()` and one timed
    `eval()` over 320 batches of 16,384. Launch counters are set to 0 just
    before the steps and read just after, and again around the timed eval."""
    from hugectr_tpu_torch import ops
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.metrics.metrics import auc_score, auc_score_large
    from hugectr_tpu_torch.tools.flagship import bench_settings, build_dlrm_dcnv2
    from hugectr_tpu_torch.tools.hybrid import METRICS

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    kw = bench_settings()
    model = build_dlrm_dcnv2(ResourceManager.create(), synthetic_batches=6, metrics_spec=METRICS, **kw)
    model.start_data_reading()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    onehot = model.ec.plan.groups[0]
    ops.reset_counts()
    losses, step_s = [], []
    for _ in range(6):
        t = time.perf_counter()
        losses.append(model.train())
        step_s.append(time.perf_counter() - t)
    train_launches = ops.launch_counts()
    steady = statistics.median(step_s[1:])
    t = time.perf_counter()
    model.eval()  # warm-up: makes the eval batches and puts them on the card
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    ops.reset_counts()
    t = time.perf_counter()
    vals = model.eval()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    eval_launches = ops.launch_counts()
    m = model.metrics
    n_eval = model.solver.max_eval_batches * model.solver.batchsize_eval
    binned = float(auc_score_large(m._preds, m._labels, m._valid))
    exact = float(auc_score(m._preds, m._labels, m._valid))
    rec = dict(
        phase="bench_path", settings=kw, tables=26, steps=6, losses=losses,
        step_ms=[x * 1e3 for x in step_s], median_ms_per_step=steady * 1e3, train_examples_per_s=B / steady,
        eval_batches=model.solver.max_eval_batches, eval_seconds=eval_s, warmup_eval_seconds=warm_s,
        eval_examples_per_s=n_eval / eval_s, eval=vals, auc_binned=binned, auc_exact=exact,
        auc_binned_minus_exact=binned - exact, max_memory_allocated=torch.cuda.max_memory_allocated(),
        onehot_group_lookups=len(onehot.lookups), onehot_group_windowed=sum(lm.windowed for lm in onehot.lookups),
        routes=dict(model.ec.group_routes), train_launches=train_launches, eval_launches=eval_launches,
        table_dtype=str(next(iter(model.tables.values())).dtype), build_seconds=build_s,
        seconds=time.perf_counter() - t0,
    )
    emit(rec)
    if not (len(losses) == 6 and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"non-finite loss on the bench path: {losses}")
    missing = [k for k in ONE_CARD_KERNELS if train_launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the bench path: {missing}")
    if train_launches["onehot_fwd"] != 6 or eval_launches["onehot_fwd"] != model.solver.max_eval_batches:
        raise AssertionError(f"onehot_fwd launched {train_launches['onehot_fwd']} times in 6 steps and "
                             f"{eval_launches['onehot_fwd']} in {model.solver.max_eval_batches} eval batches")
    if len(onehot.lookups) != 20:
        raise AssertionError(f"the one-hot group holds {len(onehot.lookups)} lookups, not 20")
    if not (abs(binned - exact) <= 1e-4 and abs(vals["auc"] - binned) <= 1e-6):
        raise AssertionError(f"binned AUC {binned} (eval: {vals['auc']}) vs exact {exact}")
    if eval_launches["onehot_bwd"] or eval_launches["segscan"]:
        raise AssertionError(f"eval launched backward kernels: {eval_launches}")
    return {k: train_launches[k] + eval_launches[k] for k in train_launches}


FTRL_ROUTES = {"static": {"onehot_ev128": "onehot", "mp_ev128": "dense", "mp_ev128_10": "sorted",
                          "mp_ev128_11": "sorted", "mp_ev128_20": "sorted", "mp_ev128_21": "sorted",
                          "mp_ev128_22": "sorted"},
               "dynamic": {"mp_ev128": "dense"}}


def ftrl_run(torch, dynamic: bool, steps: int = 6, eval_batches: int = 20):
    """DLRM with FTRL at full width (`build_dlrm_ftrl`: 26 tables capped at
    400,000 rows or dynamic with 4,096 rows each, ev 128, batch 16,384):
    `steps` training steps with launch counters set to 0 just before them
    and read just after, a warm-up `eval()` and a timed one over
    `eval_batches` batches with the counters read around the timed one.
    A dynamic run also records, after each step, the key store's fill and
    the count of the batch's distinct keys that found no row (dropped)."""
    from hugectr_tpu_torch import ops
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools.flagship import build_dlrm_ftrl
    from hugectr_tpu_torch.tools.hybrid import METRICS

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_dlrm_ftrl(ResourceManager.create(), batchsize=B, dynamic=dynamic, ev_size=E,
                            synthetic_batches=steps, max_eval_batches=eval_batches, metrics_spec=METRICS)
    model.start_data_reading()
    # one pass over the cycled batches, which leaves the cycle at batch 0
    batches = [next(model._train_iter) for _ in range(steps)]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ec = model.ec
    ops.reset_counts()
    losses, step_s, fill, dropped = [], [], [], []
    for i in range(steps):
        t = time.perf_counter()
        losses.append(model.train())
        step_s.append(time.perf_counter() - t)
        if dynamic:  # outside the timed step
            n_fill, n_dropped = ec.dynamic_stats(model.tables, model._feature_keys(batches[i]))["mp_ev128"]
            fill.append(n_fill)
            dropped.append(n_dropped)
    train_launches = ops.launch_counts()
    steady = statistics.median(step_s[1:])
    t = time.perf_counter()
    model.eval()  # warm-up: makes the eval batches and puts them on the card
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    ops.reset_counts()
    t = time.perf_counter()
    vals = model.eval()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    eval_launches = ops.launch_counts()
    rec = dict(
        phase="ftrl_dynamic_path" if dynamic else "ftrl_path", tables=26, ev=E, batch=B, steps=steps,
        rows=sum(g.total_storage_rows for g in ec.plan.groups), losses=losses,
        step_ms=[x * 1e3 for x in step_s], median_ms_per_step=steady * 1e3, train_examples_per_s=B / steady,
        eval_batches=eval_batches, eval_seconds=eval_s, warmup_eval_seconds=warm_s,
        eval_examples_per_s=eval_batches * B / eval_s, eval=vals,
        max_memory_allocated=torch.cuda.max_memory_allocated(), routes=dict(ec.group_routes),
        train_launches=train_launches, launches_per_step={k: n / steps for k, n in train_launches.items()},
        eval_launches=eval_launches, build_seconds=build_s, seconds=time.perf_counter() - t0,
    )
    if dynamic:
        rec.update(key_store_rows=int(model.tables["mp_ev128#keys"].numel()), key_store_fill=fill,
                   dropped_keys=dropped)
    return model, rec


def ftrl_path(torch):
    """DLRM with FTRL, static tables: 6 steps and eval over 20 batches.
    Every kernel launches in the steps; `onehot_fwd` once per step and per
    eval batch, `onehot_bwd` 13 times per step (one per one-hot table)."""
    model, rec = ftrl_run(torch, dynamic=False)
    emit(rec)
    tl, el = rec["train_launches"], rec["eval_launches"]
    if not all(math.isfinite(x) for x in rec["losses"]):
        raise AssertionError(f"non-finite loss on the FTRL path: {rec['losses']}")
    if rec["routes"] != FTRL_ROUTES["static"]:
        raise AssertionError(f"FTRL path routes {rec['routes']}")
    if not (tl["onehot_fwd"] == 6 and tl["onehot_bwd"] == 13 * 6 and tl["segscan"] > 0):
        raise AssertionError(f"FTRL path launches in 6 steps: {tl}")
    if not (el["onehot_fwd"] == 20 and el["onehot_bwd"] == 0 and el["segscan"] == 0):
        raise AssertionError(f"FTRL path launches in 20 eval batches: {el}")
    return {k: tl[k] + el[k] for k in tl}


def ftrl_dynamic_path(torch):
    """DLRM with FTRL on exact dynamic tables: 6 steps and eval over 20
    batches, twice from the same seed; the key stores of the two runs must
    be bitwise equal (the insert's scatter-min does not depend on the order
    of its writes). No hand-written kernel is on this path: every table is
    dynamic, so none takes the one-hot engine, and the one group of 106,496
    rows takes the dense sweep."""
    model, rec = ftrl_run(torch, dynamic=True)
    first = model.tables["mp_ev128#keys"].clone()
    del model
    again, _ = ftrl_run(torch, dynamic=True, eval_batches=1)
    rec["key_store_repeat_equal"] = bool(torch.equal(again.tables["mp_ev128#keys"], first))
    del again
    emit(rec)
    if not all(math.isfinite(x) for x in rec["losses"]):
        raise AssertionError(f"non-finite loss on the dynamic FTRL path: {rec['losses']}")
    if rec["routes"] != FTRL_ROUTES["dynamic"]:
        raise AssertionError(f"dynamic FTRL path routes {rec['routes']}")
    if not (rec["key_store_repeat_equal"] and 0 < rec["key_store_fill"][-1] <= rec["key_store_rows"]):
        raise AssertionError(f"dynamic FTRL key store: {rec}")


# The Raw files of `file_path`: the flagship's slots and hotness, labels and
# dense as float32, 16 train batches and 4.5 eval batches (a tail)
FILE_TRAIN_BATCHES = 16
FILE_EVAL_ROWS = 73728
# int32 values in one row: label, 13 dense, 253 keys
FILE_ROW_INTS = 1 + 13 + 253


def write_flagship_raw(tmp: str, batch: int, batches: int, eval_rows: int, vocab_cap: int):
    """Raw files of the flagship's 26 slots (capped at `vocab_cap`) and
    MLPerf hotness, float32 labels and dense, written by the port's
    `DataGenerator` from seed 0; returns (train path, eval path, seconds)."""
    import hugectr_tpu_torch as th
    from hugectr_tpu_torch.tools.flagship import MLPERF_MULTI_HOT_SIZES, MLPERF_TABLE_SIZES

    t = time.perf_counter()
    p = th.DataGeneratorParams(
        format="raw_async", num_slot=26, slot_size_array=[min(v, vocab_cap) for v in MLPERF_TABLE_SIZES],
        nnz_array=MLPERF_MULTI_HOT_SIZES, num_samples=batch * batches, eval_num_samples=eval_rows,
        float_label_dense=True, source=os.path.join(tmp, "train.bin"), eval_source=os.path.join(tmp, "eval.bin"))
    th.DataGenerator(p).generate()
    return p.source, p.eval_source, time.perf_counter() - t


def raw_reader_params(train: str, evalf: str):
    """The flagship's RawAsync reader over the files: 4 fill threads, 4
    batches a thread, float32 labels and dense."""
    import hugectr_tpu_torch as th

    return th.DataReaderParams(data_reader_type="raw_async", source=[train], eval_source=evalf,
                               async_param=th.AsyncParam(num_threads=4, num_batches_per_thread=4,
                                                         is_dense_float=True))


def file_path(torch, main_rec):
    """The full-width flagship (`main_path`'s model, f32) trained from a
    RawAsync file through the native reader, the `DeviceFeeder` (pinned
    staging, a copy stream) and the on-device split: the files written by
    `DataGenerator`; the native reader alone over the train file (batches/s,
    GB/s from the page cache); the first three device batches bitwise equal
    to the file's rows; 6 steps with the counts set to 0 just before and
    read just after (`main_path`'s counts:
    `onehot_fwd` 1 and `onehot_bwd` 13 a step, `segscan` > 0); each kernel
    against its plain version on the first file-fed batch
    (`tools/hybrid.py::kernel_parity`); an eval over the 73,728-row
    eval file: 4 whole batches, the 8,192-row tail dropped, then
    `is_eof()`. Beside it `main_path`'s ms/step from device-cached synthetic
    batches, in this call."""
    import tempfile

    import numpy as np

    from hugectr_tpu_torch import ops
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.data.native_reader import NativeRawReader
    from hugectr_tpu_torch.data.reader import FUSED_KEY
    from hugectr_tpu_torch.tools.flagship import build_dlrm_dcnv2
    from hugectr_tpu_torch.tools.hybrid import jsonable, kernel_parity

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="hctr_raw_")
    train, evalf, gen_s = write_flagship_raw(tmp.name, B, FILE_TRAIN_BATCHES, FILE_EVAL_ROWS, 2_000_000)
    torch.cuda.reset_peak_memory_stats()
    model = build_dlrm_dcnv2(ResourceManager.create(), batchsize=B, ev_size=E, vocab_cap=2_000_000,
                             optimizer="rowwise_adagrad", reader=raw_reader_params(train, evalf))
    build_s = time.perf_counter() - t0 - gen_s
    if not (isinstance(model.train_reader, NativeRawReader) and model._fused_float):
        raise AssertionError(f"file_path reader: {type(model.train_reader)}, float layout {model._fused_float}")
    # the native reader alone, the file in the page cache
    alone = NativeRawReader(train, model.batch_spec, float_label_dense=True, repeat=False, n_threads=4,
                            queue_depth=4, fused=True)
    t = time.perf_counter()
    n_read = sum(1 for _ in alone)
    read_s = time.perf_counter() - t
    alone.close()
    batch_bytes = B * FILE_ROW_INTS * 4
    model.start_data_reading()
    rows = np.memmap(train, dtype=np.int32, mode="r").reshape(-1, FILE_ROW_INTS)
    first = [model._next_train_batch() for _ in range(3)]
    bitwise = [bool(np.array_equal(b[FUSED_KEY].cpu().numpy(), rows[i * B:(i + 1) * B])) for i, b in enumerate(first)]
    del rows
    torch.cuda.synchronize()
    ops.reset_counts()
    losses, step_s = [], []
    for _ in range(6):
        t = time.perf_counter()
        losses.append(model.train())
        step_s.append(time.perf_counter() - t)
    launches = ops.launch_counts()
    parity = jsonable(kernel_parity(model, first[0]))  # after a step: the routes are known
    up = model._train_feeder.uploader
    steady = statistics.median(step_s[1:])
    ops.reset_counts()
    t = time.perf_counter()
    vals = model.eval()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    eval_launches = ops.launch_counts()
    eval_batches = model.metrics._nb
    eof = model.get_data_reader_eval().is_eof()
    rec = dict(
        phase="file_path", card=card_line(), tables=26, ev=E, batch=B, vocab_cap=2_000_000,
        train_file_bytes=os.path.getsize(train), eval_file_bytes=os.path.getsize(evalf),
        generate_seconds=gen_s, reader_alone=dict(batches=n_read, seconds=read_s, batches_per_s=n_read / read_s,
                                                  gb_per_s=n_read * batch_bytes / read_s / 1e9),
        first_batches_bitwise=bitwise, kernel_parity=parity, steps=6, losses=losses,
        step_ms=[x * 1e3 for x in step_s], median_ms_per_step=steady * 1e3, examples_per_s=B / steady,
        cached_synthetic_median_ms_per_step=main_rec["median_ms_per_step"],
        cached_synthetic_step_ms=main_rec["step_ms"],
        h2d_bytes_per_batch=up.bytes / max(up.batches, 1), h2d_bytes_per_batch_expected=batch_bytes,
        launches=launches, launches_per_step={k: n / 6 for k, n in launches.items()},
        eval_batches=eval_batches, eval_eof=eof, eval_seconds=eval_s, eval_examples_per_s=eval_batches * B / eval_s,
        eval=vals, eval_launches=eval_launches, max_memory_allocated=torch.cuda.max_memory_allocated(),
        build_seconds=build_s, seconds=time.perf_counter() - t0,
    )
    model._close_readers()
    del model, first
    tmp.cleanup()
    emit(rec)
    if not all(bitwise):
        raise AssertionError(f"file_path: a device batch differs from the file's rows: {bitwise}")
    if set(parity) != set(ONE_CARD_KERNELS) or any(v["scaled_err"] > TOL["float32"] for v in parity.values()):
        raise AssertionError(f"file_path: a kernel disagrees with its plain version on file-fed inputs: {parity}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"file_path: non-finite loss {losses}")
    if not (launches == main_rec["launches"] and launches["onehot_fwd"] == 6 and launches["onehot_bwd"] == 78
            and launches["segscan"] > 0):
        raise AssertionError(f"file_path: launches in 6 steps {launches}, main_path's {main_rec['launches']}")
    if not (eval_batches == 4 and eof and eval_launches["onehot_fwd"] == 4):
        raise AssertionError(f"file_path eval: {eval_batches} batches, EOF {eof}, launches {eval_launches}")
    if rec["h2d_bytes_per_batch"] != batch_bytes or n_read != FILE_TRAIN_BATCHES:
        raise AssertionError(f"file_path: {rec['h2d_bytes_per_batch']} bytes a batch, {n_read} batches read")
    return {k: launches[k] + eval_launches[k] for k in launches}


def file_i64_path(torch):
    """The full-width DLRM-FTRL on exact dynamic tables (4,096 rows each)
    with `i64_input_key`, trained from Norm files (`Check_t.Sum`) whose keys
    carry the slots' offsets, tables 20 and 21 at 2^40 rows: the count of
    keys >= 2^31 in each of the first 6 batches (> 0), the exact fold's host
    ms for the first batch and for batches 2-6, 6 steps, every table's map
    injective, the store's fill; a snapshot (with `i64_fold_maps.npz`)
    loaded by a model from another seed: state and maps bitwise, then 3
    steps of both on the same batches within 1e-6 relative. No
    hand-written kernel is on this path (every table is dynamic)."""
    import tempfile

    import numpy as np

    import hugectr_tpu_torch as th
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools.flagship import FTRL_SLOT_SIZES, build_dlrm_ftrl
    from hugectr_tpu_torch.tools.hybrid import METRICS, model_state, state_differs

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="hctr_norm_")
    slots = [2**40 if i in (20, 21) else v for i, v in enumerate(FTRL_SLOT_SIZES)]
    p = th.DataGeneratorParams(format="norm", num_slot=26, slot_size_array=slots, check_type="sum",
                               i64_input_key=True, num_files=2, eval_num_files=1, num_samples_per_file=4 * B,
                               source=os.path.join(tmp.name, "train.txt"),
                               eval_source=os.path.join(tmp.name, "eval.txt"))
    th.DataGenerator(p).generate()
    gen_s = time.perf_counter() - t0
    reader = th.DataReaderParams(data_reader_type="norm", source=[p.source], eval_source=p.eval_source)
    torch.cuda.reset_peak_memory_stats()
    build = lambda seed: build_dlrm_ftrl(ResourceManager.create(), batchsize=B, dynamic=True, ev_size=E,
                                         i64_input_key=True, reader=reader, max_eval_batches=2,
                                         metrics_spec=METRICS, seed=seed)
    a = build(0)
    fold_ms = []
    fold = a._fold_i64_keys

    def timed_fold(batch):
        t = time.perf_counter()
        out = fold(batch)
        fold_ms.append((time.perf_counter() - t) * 1e3)
        return out

    a._fold_i64_keys = timed_fold
    host = list(itertools.islice(iter(a.train_reader), 6))
    wide = [int(sum((b[f"data{i}"] >= 2**31).sum() for i in range(26))) for b in host]
    a.start_data_reading()
    losses, step_s = [], []
    for _ in range(6):
        t = time.perf_counter()
        losses.append(a.train())
        step_s.append(time.perf_counter() - t)
    ec = a.ec
    fill, dropped = ec.dynamic_stats(a.tables, a._feature_keys(a._decode_batch(a._put_now(host[5]))))["mp_ev128"]
    injective = all(len(set(m.values())) == len(m) and 2**31 - 1 not in set(m.values())
                    for m in a._i64_maps.values())
    map_sizes = {t: len(m) for t, m in a._i64_maps.items()}
    resume = [a._next_train_batch() for _ in range(3)]
    snap = os.path.join(tmp.name, "snap")
    a.download_params_to_files(snap, 6)
    has_maps = os.path.exists(os.path.join(f"{snap}_iter6", "i64_fold_maps.npz"))
    written = model_state(a)
    b = build(7)
    b.load_params_from_files(f"{snap}_iter6")
    differ = state_differs(written, model_state(b))
    maps_equal = b._i64_maps == a._i64_maps and b._i64_rev == a._i64_rev
    resumed = [(float(a.train_step(x)), float(b.train_step(x))) for x in resume]
    rel = max(abs(x - y) / max(abs(x), 1e-30) for x, y in resumed)
    vals = a.eval()
    rec = dict(
        phase="file_i64_path", card=card_line(), tables=26, ev=E, batch=B, generate_seconds=gen_s,
        train_file_bytes=sum(os.path.getsize(f) for f in open(p.source).read().split()[1:]),
        keys_at_or_above_2_31_per_batch=wide, fold_ms=fold_ms[:12], fold_ms_first=fold_ms[0],
        fold_ms_median_2_6=statistics.median(fold_ms[1:6]), losses=losses, step_ms=[x * 1e3 for x in step_s],
        median_ms_per_step=statistics.median(step_s[1:]) * 1e3, key_store_rows=int(a.tables["mp_ev128#keys"].numel()),
        key_store_fill=fill, dropped_keys_batch6=dropped, maps_injective=injective, map_sizes=map_sizes,
        snapshot_has_maps=has_maps, arrays_differing_after_load=differ, maps_equal_after_load=maps_equal,
        resumed_losses=resumed, resumed_loss_max_rel_diff=rel, eval=vals,
        max_memory_allocated=torch.cuda.max_memory_allocated(), seconds=time.perf_counter() - t0,
    )
    a._close_readers()
    b._close_readers()
    del a, b, resume
    tmp.cleanup()
    emit(rec)
    if not (min(wide) > 0 and injective and has_maps and maps_equal and not differ):
        raise AssertionError(f"file_i64_path: {rec}")
    if not (rel <= 1e-6 and all(math.isfinite(x) for x in losses) and 0 < fill <= rec["key_store_rows"]):
        raise AssertionError(f"file_i64_path: losses {losses}, resumed {resumed}, fill {fill}")


def hybrid_file_parity(torch):
    """The tiny DLRM-DCNv2 from a Raw file (the flagship's slots capped at
    1,000 rows, 4 batches of 64, an eval file of 2.5 batches) on 2 ranks,
    each reading its block of every global batch through the native reader,
    against one card reading the whole batches (`parity_phase`); the
    tolerances of `hybrid_parity`."""
    import tempfile

    from hugectr_tpu_torch.tools import hybrid

    with tempfile.TemporaryDirectory(prefix="hctr_raw_tiny_") as tmp:
        train, evalf, _s = write_flagship_raw(tmp, 64, 4, 160, 1000)
        fields = dict(data_reader_type="raw_async", source=[train], eval_source=evalf, float_label_dense=True)
        rep, _ranks = parity_phase(torch, "hybrid_file_parity", 2, "tiny",
                                   config=dict(hybrid.tiny_config("tiny"), reader=fields))
    if not (rep["loss_rel_diff"] <= 1e-4 and rep["worst_excess"] <= 0 and rep["auc_diff"] <= 1e-4):
        raise AssertionError(f"2 ranks from a file differ from one card: {rep}")


def parity_phase(torch, phase: str, world: int, model: str, eval_carried: bool = False, config=None):
    """A tiny model (`tools/hybrid.py::tiny_config`, or `config`) trained 3 steps and
    evaluated on one card in this process and on `world` spawned ranks from
    one state (`parity_runs`): NCCL with a card per rank, else gloo with the
    ranks sharing the card. The ranks run the masked-gather forward
    (`fwd_partition=False`, float32 sums rounded once, as one card pools);
    `hybrid_exchange_parity` holds the owner-partitioned default. Emits the
    record; fails if a kernel of this path (all but the ordered pool) never
    launched on a rank, or if a replicated array, or a shard on the ranks
    that hold it, differs across the ranks. Returns the report."""
    from hugectr_tpu_torch.tools import hybrid

    t0 = time.perf_counter()
    backend = hybrid.default_backend(world)
    cfg = config or hybrid.tiny_config(model)
    cfg = dict(cfg, kwargs=dict(cfg["kwargs"], fwd_partition=False))
    one, ranks = hybrid.parity_runs(world, backend, config=cfg, eval_carried=eval_carried)
    rep = hybrid.parity_report(one, ranks)
    rec = dict(phase=phase, world=world, backend=backend, device_count=torch.cuda.device_count(),
               staged_through_host=backend == "gloo", losses_one_card=one["losses"].tolist(),
               losses_ranks=[r["losses"].tolist() for r in ranks],
               auc=[one["eval"]["auc"]] + [r["eval"]["auc"] for r in ranks], routes=ranks[0]["routes"],
               launches=[r["launches"] for r in ranks], **rep, seconds=time.perf_counter() - t0)
    emit(rec)
    if not (rep["replicas_equal"] and rep["shard_replicas_equal"]):
        raise AssertionError(f"{phase}: replicas differ across the ranks: {rep}")
    if any(n <= 0 for r in ranks for k, n in r["launches"].items() if k != "ordered_pool"):
        raise AssertionError(f"{phase}: a kernel never launched on a rank: {rec['launches']}")
    return rep, ranks


def hybrid_parity(torch):
    """The tiny DLRM-DCNv2 (rowwise AdaGrad, sorted route on) on 2 ranks
    against one card (`parity_phase`). Losses rtol 1e-4; every table in key
    order and the dense parameters rtol 1e-4 / atol 1e-5; AUC within 1e-4
    (the same examples, predictions summed in another order)."""
    rep, _ranks = parity_phase(torch, "hybrid_parity", 2, "tiny")
    if not (rep["loss_rel_diff"] <= 1e-4 and rep["worst_excess"] <= 0 and rep["auc_diff"] <= 1e-4):
        raise AssertionError(f"2 ranks differ from one card: {rep}")


def hybrid_bench_parity(torch):
    """The tiny bench-configured DLRM-DCNv2 (`tiny_bench_parity`'s model)
    on 2 ranks against one card (`parity_phase`); the ranks also evaluate
    the one card's trained weights. The tolerances of `tiny_bench_parity`:
    step 1 loss rtol 1e-3, steps 2-3 rtol 2e-2; the eval of the same
    weights AUC within 1e-3, AverageLoss rtol 1e-3."""
    rep, _ranks = parity_phase(torch, "hybrid_bench_parity", 2, "tiny_bench", eval_carried=True)
    d = rep["loss_rel_diffs"]
    if not (d[0] <= 1e-3 and max(d[1:]) <= 2e-2 and rep["carried_auc_diff"] <= 1e-3
            and rep["carried_average_loss_rel_diff"] <= 1e-3):
        raise AssertionError(f"bench-configured tiny model on 2 ranks differs from one card: {rep}")


def hybrid_partial_parity(torch):
    """The tiny DLRM-DCNv2 with a partial placement
    (`tools/flagship.py::build_tiny_partial`: tables 0 and 9 on 2 shards,
    21 and 22 on 1) on 4 ranks against one card (`parity_phase`), the state
    carried by table. `hybrid_parity`'s tolerances, the 6 shard arrays
    (`shard_replicas`) bitwise equal on the ranks that hold them."""
    rep, ranks = parity_phase(torch, "hybrid_partial_parity", 4, "tiny_partial")
    if not (rep["loss_rel_diff"] <= 1e-4 and rep["worst_excess"] <= 0 and rep["auc_diff"] <= 1e-4
            and rep["shard_replicas"] == 6):
        raise AssertionError(f"partial placement on 4 ranks differs from one card: {rep}")
    if ranks[0]["routes"] != {"mp_ev16_x2": "dense", "mp_ev16": "sorted", "onehot_ev16": "onehot",
                              "mp_ev16_x1": "sorted"}:
        raise AssertionError(f"partial placement routes {ranks[0]['routes']}")


def hybrid_exchange_parity(torch):
    """The exchanges over ranks: 2 spawned ranks on one card over gloo
    (`tools/hybrid.py::exchange_checks`). (1) The tiny bench-configured
    model's forward on each rank's block of its first batch by the
    owner-partitioned forward (bf16 rows added one by one, a rounding after
    each add) against the masked gather (float32 sums rounded once): every
    output within (h + 4 t) x 2^-8 x S, h the slots that feed it, t its
    tiers, S the same forward of |tables|. (2) Each kernel against its plain
    version on each rank's inputs, the ordered pool bitwise. (3) The
    unique-key dense exchange (tests/test_dense_exchange.py's concat tables,
    AdaGrad) with lists of 64 rows (the compressed branch: one all_to_all in
    the forward and one in the backward) and of 2 (the overflow branch: no
    all_to_all) against one card from the same tables and batch: outputs
    bitwise (each is one row), tables after one update rtol 1e-4 / atol
    1e-5 (float32 sums in another order). (4) Capacity factor 1.25, which
    drops nothing at W 2 on uniform keys, against no factor: outputs and
    tables bitwise."""
    import numpy as np

    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools import hybrid

    t0 = time.perf_counter()
    inputs = {"dx": hybrid.collection_inputs(hybrid.DX_SPEC, 32, 1),
              "cap": hybrid.collection_inputs(hybrid.CAP_SPEC, 512, 5)}
    ranks = hybrid.run(hybrid.exchange_checks, 2, inputs, backend="gloo", timeout=600.0)
    one = hybrid.collection_run(ResourceManager.create(), hybrid.DX_SPEC, inputs["dx"])

    def same(a, b):
        return all(np.array_equal(a[k], b[k]) for k in b)

    dx = {}
    for cap in (64, 2):
        res = [r[f"dx{cap}"] for r in ranks]
        fwd = {top: np.concatenate([r["fwd"][top] for r in res]) for top in one["fwd"]}
        worst = max(float(np.max(np.abs(r["tables"][t] - w) - 1e-5 - 1e-4 * np.abs(w)))
                    for r in res for t, w in one["tables"].items())
        dx[cap] = dict(all_to_all_calls=[r["calls"].get("all_to_all", 0) for r in res],
                       all_reduce_calls=[r["calls"].get("all_reduce", 0) for r in res],
                       forward_bitwise=same(fwd, one["fwd"]), tables_worst_excess=worst)
    cap_same = all(same(r["cap"]["fwd"], r["nocap"]["fwd"]) and same(r["cap"]["tables"], r["nocap"]["tables"])
                   for r in ranks)
    parity = [hybrid.jsonable(r["kernel_parity"]) for r in ranks]
    rec = dict(phase="hybrid_exchange_parity", card=card_line(), world=2, backend="gloo",
               forward_excess=[r["forward_excess"] for r in ranks],
               forward_max_abs_diff=[r["forward_max_abs_diff"] for r in ranks],
               forward_outputs_differing=[r["forward_outputs_differing"] for r in ranks],
               forward_outputs=[r["forward_outputs"] for r in ranks],
               kernel_parity=parity, dense_exchange=dx, capacity_factor_drops_nothing_bitwise=cap_same,
               seconds=time.perf_counter() - t0)
    emit(rec)
    if not all(x <= 0 for x in rec["forward_excess"]):
        raise AssertionError(f"the partitioned forward strays past per-key rounding: {rec}")
    for r, p in enumerate(parity):
        if not (p.get("ordered_pool", {}).get("shapes") and all(p[k]["scaled_err"] <= RANK_TOL[k] for k in p)):
            raise AssertionError(f"a kernel disagrees with its plain version on rank {r}: {p}")
    if not (dx[64]["all_to_all_calls"] == [2, 2] and dx[2]["all_to_all_calls"] == [0, 0]
            and all(d["forward_bitwise"] and d["tables_worst_excess"] <= 0 for d in dx.values())):
        raise AssertionError(f"the dense exchange differs from one card: {dx}")
    if not cap_same:
        raise AssertionError("a capacity factor that drops nothing changed the results")


def hybrid_world(torch) -> int:
    """The ranks of the full-width hybrid phases: a card each, at least 2
    (sharing one card over gloo), at most 8."""
    return min(8, max(2, torch.cuda.device_count()))


def hybrid_run(torch, model: str, dynamic: bool = False, world: int = 0, lay=None, **extra):
    """A full-width model (`tools/hybrid.py::full_width_config`) trained on
    W = `world` ranks (default `hybrid_world`), on the mesh and with the
    settings of `lay` (`hybrid.layout`): 6 steps and a 20-batch eval over
    NCCL with a card per rank; over gloo, W ranks sharing the card(s), 4
    steps and 4 eval batches, since every collective is staged through the
    host (its ms/step is then no speed number). Counters are set to 0 on
    every rank just before the steps and read just after, and again around
    the eval. Returns (the phase's record, the ranks' results)."""
    from hugectr_tpu_torch.tools import hybrid

    t0 = time.perf_counter()
    w = world or hybrid_world(torch)
    backend = hybrid.default_backend(w)
    cfg = dict(hybrid.full_width_config(model, backend == "gloo", B, dynamic, lay), **extra)
    ranks = hybrid.run(hybrid.train_model, w, {"config": json.dumps(cfg)}, backend=backend, timeout=900.0)
    rec = dict(backend=backend, device_count=torch.cuda.device_count(), staged_through_host=backend == "gloo",
               **hybrid.path_summary(ranks, cfg), seconds=time.perf_counter() - t0)
    return rec, ranks


def mp_groups(rec) -> int:
    """The model-parallel rowop groups of a path's record (plan names "mp_")."""
    return sum(1 for g, route in rec["routes"].items() if g.startswith("mp_") and route != "onehot")


def check_path_launches(rec, per_step: dict, eval_fwd: bool = True):
    """Every rank's launches: `per_step` {kernel: n} a step exactly (None:
    at least once in the steps), `onehot_fwd` once an eval batch, the
    ordered pool once a model-parallel rowop group and forward (step or
    eval batch: the owner-partitioned forward), and no backward kernel in
    the eval."""
    steps, eval_batches = rec["steps"], rec["eval_batches"]
    per_step = dict(per_step, ordered_pool=mp_groups(rec))
    for r, (tl, el) in enumerate(zip(rec["launches"], rec["eval_launches"])):
        ok = all(tl[k] > 0 if n is None else tl[k] == n * steps for k, n in per_step.items())
        ok = ok and el["onehot_bwd"] == 0 and el["segscan"] == 0
        ok = ok and el["ordered_pool"] == mp_groups(rec) * eval_batches and mp_groups(rec) > 0
        ok = ok and el["onehot_fwd"] == (eval_batches if eval_fwd else 0)
        if not ok:
            raise AssertionError(f"{rec['phase']} launches on rank {r}: train {tl}, eval {el}")


def hybrid_path(torch):
    """The full-width flagship (f32, global batch 16,384, rowwise AdaGrad)
    trained hybrid-parallel (`hybrid_run`), at the default owner-partitioned
    forward. Every rank must launch `onehot_fwd` once a step and once an
    eval batch, the ordered pool once a model-parallel group and forward,
    `onehot_bwd` and `segscan` in the steps; losses finite; every
    replicated array bitwise equal across the ranks (SHA-256)."""
    rec, _ranks = hybrid_run(torch, "dlrm_dcnv2")
    rec = dict(phase="hybrid_path", **rec)
    emit(rec)
    if not rec["finite"]:
        raise AssertionError(f"non-finite loss on the hybrid path: {rec['losses']}")
    check_path_launches(rec, {"onehot_fwd": 1, "onehot_bwd": None, "segscan": None})
    if not rec["replicas_equal"]:
        raise AssertionError("replicated arrays differ across the ranks of the hybrid path")
    return [{k: tl[k] + el[k] for k in tl} for tl, el in zip(rec["launches"], rec["eval_launches"])], rec


def check_mesh_path(rec, ranks):
    """A full-width mesh path's checks: finite losses, every replicated
    array and every shard's replicas bitwise equal across the ranks, the
    launches (`check_path_launches`), each kernel within `RANK_TOL` of its
    plain version on every rank's inputs. Returns the per-rank kernel
    parity."""
    from hugectr_tpu_torch.tools import hybrid

    parity = [hybrid.jsonable(r["kernel_parity"]) for r in ranks]
    if not rec["finite"]:
        raise AssertionError(f"non-finite loss on {rec['phase']}: {rec['losses']}")
    check_path_launches(rec, {"onehot_fwd": 1, "onehot_bwd": None, "segscan": None})
    if not (rec["replicas_equal"] and rec["shard_replicas_equal"]):
        raise AssertionError(f"replicas differ across the ranks of {rec['phase']}")
    for r, p in enumerate(parity):
        if set(p) != set(RANK_TOL) or any(p[k]["scaled_err"] > tol for k, tol in RANK_TOL.items()):
            raise AssertionError(f"{rec['phase']}: a kernel disagrees with its plain version on rank {r}: {p}")
    return parity


def hybrid_hier_path(torch, flat_rec):
    """samples/dlrm_dcnv2.py --num_slices 2 --comm_strategy hierarchical:
    the f32 flagship of `hybrid_path` at global batch 16,384 on 4 ranks as
    the (dcn, ici) = (2, 2) mesh with Hierarchical communication (NCCL with
    4 cards, else gloo with the 4 ranks on one card, staged, 4 steps and 4
    eval batches). Each rank holds each kernel against its plain version on
    its own inputs. The two-level exchange's bytes a step: the ICI level's
    reduce-scatter equals `hybrid_path`'s flat one (the gathered batch's
    partial pools, whatever W is) and the DCN level's is 1 / I of it."""
    from hugectr_tpu_torch.tools import hybrid

    lay = hybrid.layout(num_slices=2, comm_strategy="hierarchical")
    rec, ranks = hybrid_run(torch, "dlrm_dcnv2", world=4, lay=lay, kernel_check=True)
    hier, flat = rec["collective_bytes_per_step"], flat_rec["collective_bytes_per_step"]["reduce_scatter"]
    rec = dict(phase="hybrid_hier_path", mesh="(dcn, ici) = (2, 2)", comm_strategy="hierarchical", **rec,
               flat_reduce_scatter_bytes_per_step=flat, dcn_over_flat=hier.get("reduce_scatter_dcn", 0) / flat)
    rec["kernel_parity"] = check_mesh_path(rec, ranks)
    emit(rec)
    if not (hier.get("reduce_scatter_dcn", 0) * 2 == flat == hier.get("reduce_scatter_ici")
            and "reduce_scatter" not in hier):
        raise AssertionError(f"the two-level exchange's bytes: {hier}, flat {flat}")
    return [{k: tl[k] + el[k] for k in tl} for tl, el in zip(rec["launches"], rec["eval_launches"])]


def hybrid_column_path(torch):
    """The f32 flagship on `hybrid_world` ranks on the flat mesh with column
    factor 2 on its sorted-route tables 0, 9, 10, 19, 21, 22: each becomes
    sub-tables t#col0, t#col1 of E 64 on the sorted route, so segscan and
    the ordered pool run at E 64 on every rank, each held against its plain
    version on the rank's inputs. Routes, launches, finite losses, replicas
    bitwise."""
    from hugectr_tpu_torch.tools import hybrid

    rec, ranks = hybrid_run(torch, "dlrm_dcnv2", lay=hybrid.layout(column_factor=2), kernel_check=True)
    rec = dict(phase="hybrid_column_path", column_factors={t: 2 for t in hybrid.SORTED_TABLES}, **rec)
    rec["kernel_parity"] = check_mesh_path(rec, ranks)
    emit(rec)
    split = {g: r for g, r in rec["routes"].items() if "#col" in g}
    widths = {s[2] for p in rec["kernel_parity"] for s in p["segscan"]["shapes"]}
    if not (len(split) == 2 * len(hybrid.SORTED_TABLES) and set(split.values()) == {"sorted"}
            and E // 2 in widths):
        raise AssertionError(f"column-split groups and routes: {rec['routes']}, segscan shapes {widths}")
    return [{k: tl[k] + el[k] for k in tl} for tl, el in zip(rec["launches"], rec["eval_launches"])]


def mesh_parity(torch):
    """The meshes on the tiny model (`tools/hybrid.py::mesh_parity_runs`:
    the sorted route, no one-hot group, every run from one carried state on
    the global batches of ranks on 2 hosts), ranks sharing the card over
    gloo (NCCL with 4 cards). (1) 4 ranks flat and as the (2, 2)
    hierarchical mesh with Hierarchical communication against one card fed
    the same batches: losses rtol 1e-4, tables rtol 1e-4 / atol 1e-5. (2)
    The ("data", "ev") (2, 2) mesh against 2 flat ranks: losses and tables
    bitwise, the ev replicas bitwise. (3) `--hosts 2` at W 4: each rank's
    first batch is rows [l B/4, (l + 1) B/4) of host h's batch of B / 2 rows
    from seed + 7919 h, bitwise. (4) The repaired bf16 sums over 4 ranks of
    1.0 + 3 x 2^-9: 1.0078125 on every rank for every placement. (5) On the
    card: the column model's split table (factor 2) against the unsplit one
    from the same columns, bitwise; `group_rows` 4,000 against no binning
    on the tiny model, 3 steps, tables within 1e-7 + 1e-6 |w| (and whether
    bitwise: bins change the sorted lists, so segscan's float32 sums may
    take another order on the card)."""
    import numpy as np

    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools import flagship, hybrid
    from hugectr_tpu_torch.tools.carry import export_table_state

    t0 = time.perf_counter()
    backend = hybrid.default_backend(4)
    res = hybrid.mesh_parity_runs(backend)
    one, four, two = res["one"], res["four"], res["two"]

    def excess(runs, ref):
        return max(float(np.max(np.abs(r["tables"][k] - w) - 1e-5 - 1e-4 * np.abs(w)))
                   for r in runs for k, w in ref["tables"].items())

    def loss_rel(runs, ref):
        return max(float(np.max(np.abs(r["losses"] - ref["losses"]) / np.abs(ref["losses"]))) for r in runs)

    rec = dict(phase="mesh_parity", card=card_line(), backend=backend, device_count=torch.cuda.device_count())
    for name in ("flat", "hier"):
        runs = [r[name] for r in four]
        rec[f"{name}_w4_loss_rel_diff"] = loss_rel(runs, one)
        rec[f"{name}_w4_worst_excess"] = excess(runs, one)
        rec[f"{name}_w4_replicas_equal"] = all(r["replicated"] == runs[0]["replicated"] for r in runs)
    ev = [r["ev"] for r in four]
    rec["ev_vs_flat_w2_bitwise"] = all(
        np.array_equal(e["losses"], two[0]["losses"])
        and all(np.array_equal(e["tables"][k], v) for k, v in two[0]["tables"].items()) for e in ev)
    rec["ev_replicas_equal"] = all(e["replicated"] == ev[0]["replicated"] for e in ev) and all(
        ev[a]["shards"] == ev[b]["shards"] for a, b in ((0, 1), (2, 3)))
    rec["hier_collective_bytes"] = four[0]["hier"]["collective_bytes"]
    rec["flat_collective_bytes"] = four[0]["flat"]["collective_bytes"]
    glob = one["first_batch"]  # one device's first global batch of the 2 hosts
    rec["host_batches_bitwise"] = all(
        np.array_equal(r["flat"]["first_batch"][k], v[i * 16 : (i + 1) * 16])
        for i, r in enumerate(four) for k, v in glob.items())
    rec["bf16_sums"] = sorted({float(x) for r in four for x in (*r["bf16_all_reduce"], *r["bf16_reduce_scatter"])})
    # (5) on the card, in this process
    rm = ResourceManager.create()
    m1, m2 = flagship.build_tiny_column(rm, 1), flagship.build_tiny_column(rm, 2)
    full = m1.ec.export_table(m1.tables, "t0")
    m2.ec.import_table(m2.tables, "t0#col0", full[:, :8])
    m2.ec.import_table(m2.tables, "t0#col1", full[:, 8:])
    keys = np.random.default_rng(0).integers(0, 100, (64, 2)).astype(np.int32)
    keys[1, 1] = -1
    batch = {"label": np.zeros((64, 1), np.float32), "dense": np.zeros((64, 4), np.float32), "d0": keys}
    rec["column_split_bitwise"] = bool(np.array_equal(m1.check_out_tensor("emb", batch),
                                                      m2.check_out_tensor("emb", batch)))
    for m in (m1, m2):
        m._close_readers()
    base = flagship.build_tiny_dlrm(rm, **hybrid.TINY_SORTED["kwargs"])
    state = export_table_state(base)
    base._close_readers()
    runs = [hybrid.train_model(rm, {"config": json.dumps(dict(hybrid.TINY_SORTED, kwargs=dict(
        hybrid.TINY_SORTED["kwargs"], group_rows=cap))), "table_state": state}) for cap in (None, 4000)]
    rec["group_rows_groups"] = [len(r["routes"]) for r in runs]
    rec["group_rows_worst_excess"] = max(float(np.max(np.abs(runs[1]["tables"][k] - w) - 1e-7 - 1e-6 * np.abs(w)))
                                         for k, w in runs[0]["tables"].items())
    rec["group_rows_bitwise"] = all(np.array_equal(runs[1]["tables"][k], w) for k, w in runs[0]["tables"].items())
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    ok = (max(rec["flat_w4_loss_rel_diff"], rec["hier_w4_loss_rel_diff"]) <= 1e-4
          and max(rec["flat_w4_worst_excess"], rec["hier_w4_worst_excess"]) <= 0
          and rec["flat_w4_replicas_equal"] and rec["hier_w4_replicas_equal"]
          and rec["ev_vs_flat_w2_bitwise"] and rec["ev_replicas_equal"] and rec["host_batches_bitwise"]
          and rec["bf16_sums"] == [1.0078125] and rec["column_split_bitwise"]
          and rec["group_rows_groups"][1] > rec["group_rows_groups"][0] and rec["group_rows_worst_excess"] <= 0)
    if not ok:
        raise AssertionError(f"the meshes disagree: {rec}")


# per-rank kernel checks against the plain versions: the forward in the
# tables' type (bf16), the backward's and segscan's float32 sums
RANK_TOL = {"onehot_fwd": TOL["bfloat16"], "onehot_bwd": TOL["float32"], "segscan": TOL["float32"],
            "ordered_pool": 0.0}


def hybrid_bench_path(torch):
    """The full-width flagship with `bench_settings()` (bf16 tables and
    state, mixed precision, the hot/cold/superhot split) trained
    hybrid-parallel (`hybrid_run`). Every rank launches `onehot_fwd` once a
    step and once an eval batch, `onehot_bwd` 20 times a step (13 tables, 7
    superhot tiers), `segscan` in the steps (the 7 cold tiers' owned
    prefixes), the ordered pool once a model-parallel group and forward;
    then each rank holds each kernel against its plain version on its own
    inputs of the step (`tools/hybrid.py::kernel_parity`, `RANK_TOL`; the
    ordered pool bitwise). Losses finite; every replicated array bitwise equal (SHA-256);
    the binned AUC of the eval's buffers within 1e-4 of the exact one."""
    from hugectr_tpu_torch.tools import hybrid

    rec, ranks = hybrid_run(torch, "bench", kernel_check=True, auc_both=True)
    parity = [hybrid.jsonable(r["kernel_parity"]) for r in ranks]
    rec = dict(phase="hybrid_bench_path", **rec, auc_binned=ranks[0]["auc_binned"], auc_exact=ranks[0]["auc_exact"],
               kernel_parity=parity)
    emit(rec)
    if not rec["finite"]:
        raise AssertionError(f"non-finite loss on the hybrid bench path: {rec['losses']}")
    check_path_launches(rec, {"onehot_fwd": 1, "onehot_bwd": 20, "segscan": None})
    if not rec["replicas_equal"]:
        raise AssertionError("replicated arrays differ across the ranks of the hybrid bench path")
    for r, p in enumerate(parity):
        if set(p) != set(RANK_TOL) or any(p[k]["scaled_err"] > tol for k, tol in RANK_TOL.items()):
            raise AssertionError(f"a kernel disagrees with its plain version on rank {r}: {p}")
    if not abs(rec["auc_binned"] - rec["auc_exact"]) <= 1e-4:
        raise AssertionError(f"binned AUC {rec['auc_binned']} vs exact {rec['auc_exact']}")
    return [{k: tl[k] + el[k] for k in tl} for tl, el in zip(rec["launches"], rec["eval_launches"])]


def hybrid_ftrl_dynamic_path(torch):
    """Full-width DLRM-FTRL on exact dynamic tables (4,096 rows each)
    trained hybrid-parallel (`hybrid_run`), twice from one seed: each
    shard's store fill and dropped keys a step; every key of a table in at
    most one shard's store; each shard's store bitwise equal across the two
    runs; losses finite; replicas bitwise equal. The one hand-written
    kernel on this path is the ordered pool of the owner-partitioned
    forward (no table takes the one-hot engine)."""
    import numpy as np

    rec, ranks = hybrid_run(torch, "dlrm_ftrl", dynamic=True)
    again, again_ranks = hybrid_run(torch, "dlrm_ftrl", dynamic=True)
    stores = [r["key_stores"]["mp_ev128#keys"] for r in ranks]
    overlap = 0
    # the 26 tables' stores, each the same number of rows a shard, in order
    for parts in zip(*(np.split(s, 26) for s in stores)):
        held = np.concatenate([p[p != 2**31 - 1] for p in parts])
        overlap += held.size - np.unique(held).size
    rec = dict(phase="hybrid_ftrl_dynamic_path", **rec, key_store_rows_per_rank=int(stores[0].size),
               keys_in_two_shards=int(overlap),
               key_store_repeat_equal=all(np.array_equal(a["key_stores"]["mp_ev128#keys"], s)
                                          for a, s in zip(again_ranks, stores)),
               repeat_losses=again["losses"])
    emit(rec)
    if not rec["finite"]:
        raise AssertionError(f"non-finite loss on the hybrid dynamic FTRL path: {rec['losses']}")
    if rec["routes"] != FTRL_ROUTES["dynamic"]:
        raise AssertionError(f"hybrid dynamic FTRL path routes {rec['routes']}")
    check_path_launches(rec, {"onehot_fwd": 0, "onehot_bwd": 0, "segscan": 0}, eval_fwd=False)
    if not (overlap == 0 and rec["key_store_repeat_equal"] and rec["replicas_equal"]
            and min(f["mp_ev128"][-1] for f in rec["store_fill"]) > 0):
        raise AssertionError(f"hybrid dynamic FTRL key stores: {rec}")


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _dirs, names in os.walk(path) for f in names)


def snapshot_bytes_predicted(model) -> int:
    """The bytes a snapshot of a one-card model must hold, from its plan:
    each table's rows once (`sparse_<table>`, a split table's merged view
    again), each group's optimizer state as its storage, the key stores,
    the dense parameters and their state."""
    ec = model.ec
    item = ec.dtype.itemsize
    rows = sum(int(v) for g in ec.plan.groups for v in g.table_vocab)
    rows += sum(int(v) for g in ec.plan.groups for t, v in zip(g.tables, g.table_vocab) if "::" in t.name)
    n = rows * ec.plan.groups[0].ev_size * item
    n += sum(t.numel() * t.element_size() for st in model.eopt.values() for t in st.values())
    n += sum(t.numel() * t.element_size() for k, t in model.tables.items() if k.endswith("#keys"))
    n += sum(p.numel() * 4 for ps in model.network.param_tree().values() for p in ps.values())
    n += sum(t.numel() * 4 for tree in model.dopt.values() for ps in tree.values() for t in ps.values())
    return n


def snapshot_run(torch, dynamic: bool):
    """Full-width DLRM-FTRL (`ftrl_path`'s model, or the dynamic one):
    3 steps, a snapshot into a temporary directory, a second model from
    another seed that loads it, the arrays that differ bitwise, then both
    models trained on the same 3 cached batches. Returns (the record, the
    first model, its cached batches, the snapshot dir's context)."""
    import tempfile

    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools.flagship import build_dlrm_ftrl
    from hugectr_tpu_torch.tools.hybrid import model_state, state_differs

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    build = lambda seed: build_dlrm_ftrl(ResourceManager.create(), batchsize=B, dynamic=dynamic, ev_size=E,
                                         synthetic_batches=6, max_eval_batches=1, seed=seed)
    a = build(0)
    a.start_data_reading()
    batches = [next(a._train_iter) for _ in range(6)]  # one pass: the cycle is back at batch 0
    losses = [a.train() for _ in range(3)]
    tmp = tempfile.TemporaryDirectory(prefix="hctr_snapshot_")
    prefix = os.path.join(tmp.name, "snap")
    torch.cuda.synchronize()
    t = time.perf_counter()
    a.download_params_to_files(prefix, 3)
    write_s = time.perf_counter() - t
    written = model_state(a)
    b = build(7)
    differ_before = state_differs(written, model_state(b))
    torch.cuda.synchronize()
    t = time.perf_counter()
    b.load_params_from_files(f"{prefix}_iter3")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    differ = state_differs(written, model_state(b))
    resumed = [(float(a.train_step(x)), float(b.train_step(x))) for x in batches[3:6]]
    rel = max(abs(la - lb) / max(abs(la), 1e-30) for la, lb in resumed)
    del b
    rec = dict(phase="snapshot_dynamic_path" if dynamic else "snapshot_path", card=card_line(), tables=26, ev=E,
               batch=B, losses=losses, bytes_written=dir_bytes(f"{prefix}_iter3"),
               bytes_predicted=snapshot_bytes_predicted(a), files=sum(len(f) for _d, _s, f in os.walk(prefix + "_iter3")),
               write_seconds=write_s, load_seconds=load_s, arrays_differing_before_load=len(differ_before),
               arrays_differing_after_load=differ, resumed_losses=resumed, resumed_loss_max_rel_diff=rel,
               max_memory_allocated=torch.cuda.max_memory_allocated(), seconds=time.perf_counter() - t0)
    return rec, a, batches, tmp


def check_snapshot_run(rec):
    if rec["arrays_differing_after_load"] or not rec["arrays_differing_before_load"]:
        raise AssertionError(f"{rec['phase']}: the reloaded state is not bitwise the written one: {rec}")
    if not (rec["resumed_loss_max_rel_diff"] <= 1e-6 and all(math.isfinite(x) for p in rec["resumed_losses"] for x in p)):
        raise AssertionError(f"{rec['phase']}: the resumed losses differ: {rec['resumed_losses']}")


def snapshot_path(torch):
    """The full-width static DLRM-FTRL saved after 3 steps and reloaded into
    a model from another seed (`snapshot_run`): every table, the FTRL state
    z and n, the dense parameters and their state and the step bitwise
    equal; 3 more steps of both on the same batches agree within 1e-6
    relative (the one-hot backward's global atomics promise no bitwise
    sums). Reports the bytes written beside the plan's prediction, the
    seconds to write and to load and the peak memory."""
    rec, a, _batches, tmp = snapshot_run(torch, dynamic=False)
    tmp.cleanup()
    del a
    emit(rec)
    check_snapshot_run(rec)


def snapshot_dynamic_path(torch):
    """The full-width dynamic DLRM-FTRL (`snapshot_run`): key stores and
    tables bitwise after the reload; then `embedding_dump` of table 3 with
    its key_store.npy and `embedding_load` into a third model: its lookup
    of table 3 gives the first model's rows for the same keys."""
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools.flagship import build_dlrm_ftrl

    rec, a, batches, tmp = snapshot_run(torch, dynamic=True)
    dump = os.path.join(tmp.name, "dump")
    a.embedding_dump(dump, ["3"])
    c = build_dlrm_ftrl(ResourceManager.create(), batchsize=B, dynamic=True, ev_size=E, synthetic_batches=1,
                        max_eval_batches=1, seed=8)
    c.embedding_load(dump)
    g, _ti = a.ec._find_table("3")
    top = next(lm.top_name for lm in g.lookups if g.tables[lm.table_index].name == "3")
    with torch.no_grad():
        fk = a._feature_keys(batches[0])
        same = torch.equal(a.ec.forward(a.tables, fk)[top], c.ec.forward(c.tables, fk)[top])
    rec.update(dumped_files=sorted(os.listdir(os.path.join(dump, "3"))), dump_load_rows_equal=same,
               key_store_fill={k: int((t != 2**31 - 1).sum()) for k, t in a.tables.items() if k.endswith("#keys")})
    tmp.cleanup()
    del a, c
    emit(rec)
    check_snapshot_run(rec)
    if not (same and rec["dumped_files"] == ["emb_vector.npy", "key_store.npy"] and rec["key_store_fill"]
            and min(rec["key_store_fill"].values()) > 0):
        raise AssertionError(f"snapshot_dynamic_path: embedding_dump / embedding_load: {rec}")


def snapshot_bf16(torch):
    """The tiny bench-configured model (bf16 tables and state, the split)
    on the card: 3 steps, a snapshot whose bf16 arrays are 2-byte void
    files as the JAX package writes them, with the merged view of each
    split table; a model from another seed reloads it bitwise."""
    import tempfile

    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools.flagship import TINY_BENCH, bench_settings, build_dlrm_dcnv2
    from hugectr_tpu_torch.tools.hybrid import model_state, state_differs

    t0 = time.perf_counter()
    kw = dict(bench_settings(), **TINY_BENCH)
    a = build_dlrm_dcnv2(ResourceManager.create(), **kw)
    losses = [a.train() for _ in range(3)]
    with tempfile.TemporaryDirectory(prefix="hctr_snapshot_") as tmp:
        a.download_params_to_files(os.path.join(tmp, "snap"), 3)
        snap = os.path.join(tmp, "snap_iter3")
        b = build_dlrm_dcnv2(ResourceManager.create(), **dict(kw, seed=1))
        b.load_params_from_files(snap)
        names = sorted(os.listdir(snap))
        descr = {}
        for rel in (os.path.join("emb_opt_states", f"{a.ec.plan.groups[0].name}.accum.npy"),
                    os.path.join(f"sparse_{next(iter(a.ec.plan.table_splits))}", "emb_vector.npy")):
            with open(os.path.join(snap, rel), "rb") as f:
                descr[rel] = "'descr': '<V2'" in f.read(128).decode("latin-1")
    wa = model_state(a)
    differ = state_differs(wa, model_state(b))
    merged = [u for u in a.ec.plan.table_splits if f"sparse_{u}" in names]
    rec = dict(phase="snapshot_bf16", card=card_line(), losses=losses, bf16_void_files=descr,
               split_tables=sorted(a.ec.plan.table_splits), merged_views_written=merged,
               arrays=len(wa), arrays_differing_after_load=differ, seconds=time.perf_counter() - t0)
    emit(rec)
    if differ or not all(descr.values()) or len(merged) != len(a.ec.plan.table_splits) or not merged:
        raise AssertionError(f"snapshot_bf16: {rec}")


def freeze_path(torch):
    """The full-width static DLRM-FTRL with a one-hot table (5), a table
    with a sorted-route group of its own (20) and the dense network frozen:
    2 steps in which `onehot_bwd` launches 12 times a step (not 13) and
    table 20's group hands segscan no key (its K drops by the frozen slots,
    to 0: no launch), the frozen rows and dense weights bitwise unchanged
    and the other tables moved; each kernel against its plain version on
    these inputs (`tools/hybrid.py::kernel_parity`, which leaves out the
    frozen lookups and slots as the step does); then unfrozen, 1 step, and
    the frozen rows and dense weights move."""
    from hugectr_tpu_torch import ops
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.embedding import sparse_optimizer
    from hugectr_tpu_torch.tools.flagship import build_dlrm_ftrl
    from hugectr_tpu_torch.tools.hybrid import kernel_parity

    t0 = time.perf_counter()
    model = build_dlrm_ftrl(ResourceManager.create(), batchsize=B, ev_size=E, synthetic_batches=3, max_eval_batches=1)
    model.start_data_reading()
    batches = [next(model._train_iter) for _ in range(3)]
    ec = model.ec
    frozen = ["5", "20"]
    model.freeze_dense()
    for n in frozen:
        model.freeze_embedding(n)
    views = lambda names: {n: model.ec.export_rows(model.tables, n) for n in names}
    dense = lambda: {f"{layer}.{k}": p.detach().clone() for layer, ps in model.network.param_tree().items()
                     for k, p in ps.items()}
    others = ["0", "10", "8"]  # a dense-sweep, a sorted and a one-hot table
    before_t, before_d = views(frozen + others), dense()
    # each rowop group's keys a step: (valid, valid less the frozen slots);
    # the second is K of a group on the sorted route
    expected = []
    for x in batches[:2]:
        fk = model._feature_keys(x)
        row = {}
        for g in ec.plan.groups:
            if g.compute_kind == "rowop":
                valid = ec._slot_placement(g.name, ec._group_keys(g, fk))[0]
                live = torch.as_tensor([not ec._is_frozen(g.tables[ti].name) for ti in g.slot_table],
                                       device=valid.device)
                row[g.name] = (int(valid.sum()), int((valid & live).sum()))
        expected.append(row)
    ks = []
    scan = sparse_optimizer.segmented_sum_sorted
    sparse_optimizer.segmented_sum_sorted = lambda v, *a: ks.append(int(v.shape[0])) or scan(v, *a)
    try:
        ops.reset_counts()
        losses = [model.train() for _ in range(2)]
        launches = ops.launch_counts()
    finally:
        sparse_optimizer.segmented_sum_sorted = scan
    sorted_groups = [g.name for g in ec.plan.groups if ec.group_routes.get(g.name) == "sorted"]
    after_t, after_d = views(frozen + others), dense()
    frozen_same = all(torch.equal(after_t[n], before_t[n]) for n in frozen)
    dense_same = all(torch.equal(after_d[k], v) for k, v in before_d.items())
    others_moved = all(not torch.equal(after_t[n], before_t[n]) for n in others)
    want_ks = [row[g][1] for row in expected for g in sorted_groups]
    parity = kernel_parity(model, {k: v for k, v in batches[0].items()})
    model.unfreeze_dense()
    model.unfreeze_embedding()
    ops.reset_counts()
    losses.append(model.train())
    unfrozen_launches = ops.launch_counts()
    moved_t, moved_d = views(frozen), dense()
    rec = dict(phase="freeze_path", card=card_line(), frozen_tables=frozen, frozen_dense=True, losses=losses,
               launches=launches, launches_per_step={k: n / 2 for k, n in launches.items()},
               unfrozen_step_launches=unfrozen_launches, segscan_k=ks, segscan_k_expected=want_ks,
               sorted_group_keys={g: [row[g] for row in expected] for g in sorted_groups},
               frozen_rows_unchanged=frozen_same, dense_unchanged=dense_same, other_tables_moved=others_moved,
               kernel_parity={k: {"scaled_err": v["scaled_err"], "max_abs_err": v["max_abs_err"],
                                  "calls": len(v["shapes"])} for k, v in parity.items()},
               frozen_rows_moved_after_unfreeze=all(not torch.equal(moved_t[n], before_t[n]) for n in frozen),
               dense_moved_after_unfreeze=any(not torch.equal(moved_d[k], v) for k, v in before_d.items()),
               seconds=time.perf_counter() - t0)
    emit(rec)
    n_onehot = len(next(g for g in ec.plan.groups if g.compute_kind == "onehot").lookups)
    if not (launches["onehot_fwd"] == 2 and launches["onehot_bwd"] == 2 * (n_onehot - 1) and n_onehot == 13
            and launches["segscan"] == 2 * (len(sorted_groups) - 1) and unfrozen_launches["onehot_bwd"] == 13):
        raise AssertionError(f"freeze_path launches: {rec}")
    if ks != want_ks or 0 not in want_ks:
        raise AssertionError(f"freeze_path segscan K: {ks} against {want_ks}")
    if not (frozen_same and dense_same and others_moved and rec["frozen_rows_moved_after_unfreeze"]
            and rec["dense_moved_after_unfreeze"] and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"freeze_path: {rec}")
    if not (parity["onehot_fwd"]["scaled_err"] <= TOL["float32"] and parity["onehot_bwd"]["scaled_err"] <= TOL["float32"]
            and parity["segscan"]["scaled_err"] <= TOL["float32"] and len(parity["onehot_bwd"]["shapes"]) == 12):
        raise AssertionError(f"freeze_path kernels against their plain versions: {rec['kernel_parity']}")
    return launches


def hybrid_snapshot(torch):
    """The tiny DLRM-DCNv2 on 2 spawned ranks (gloo on one card, NCCL with a
    card each, as `hybrid_parity`): 3 steps, a snapshot that rank 0 alone
    writes, then a model from another seed on each rank reloads it
    bitwise (`tools/hybrid.py::snapshot_round_trip`)."""
    import tempfile

    from hugectr_tpu_torch.tools import hybrid

    t0 = time.perf_counter()
    backend = hybrid.default_backend(2)
    with tempfile.TemporaryDirectory(prefix="hctr_snapshot_") as tmp:
        cfg = dict(builder=hybrid.TINY_PARITY["builder"], kwargs=hybrid.TINY_PARITY["kwargs"], before=3,
                   prefix=os.path.join(tmp, "snap"), iteration=3, after=1)
        ranks = hybrid.run(hybrid.snapshot_round_trip, 2, {"config": json.dumps(cfg)}, backend=backend)
    rec = dict(phase="hybrid_snapshot", card=card_line(), world=2, backend=backend,
               writes=[r["writes"] for r in ranks], arrays=[r["arrays"] for r in ranks],
               arrays_differing_after_load=[json.loads(r["differ"]) for r in ranks],
               steps=[r["step"] for r in ranks], bytes_written=ranks[0]["bytes"],
               write_seconds=[r["write_seconds"] for r in ranks], load_seconds=[r["load_seconds"] for r in ranks],
               losses_after=[r["losses"].tolist() for r in ranks], seconds=time.perf_counter() - t0)
    emit(rec)
    if not (rec["writes"][0] > 0 and rec["writes"][1] == 0 and rec["arrays_differing_after_load"] == [[], []]
            and rec["steps"] == [3, 3]):
        raise AssertionError(f"hybrid_snapshot: {rec}")


WEIGHTED_SOURCE = "benchmarks/weighted_bench.py:30-37"


def weighted_kernel_checks(torch, np, dev, results):
    """Each kernel's weighted case (per-key weights, a weighted lookup of
    the JAX package's sp_weight_name) against its plain version at the
    shapes `weighted_path` and `hybrid_weighted_path` give it
    (`tools/weighted.py`: the 2,000,000-row table, hotness 20, batch
    16,384, weights uniform in [0, 1)), f32 and bf16, with the bound, the
    plain version's time and one library call: the grouped forward of the
    superhot tier (V 1,024, the keys' window [0, 1,024)) beside
    `embedding_bag(per_sample_weights=)`; the backward of that tier (global
    route) and of a privatised shape (V 108, h 40) beside `index_add_` of the
    w-scaled cotangents (counts: the sums of |w|, touched rows exact);
    segscan over the untiered sorted route's per-key rows (K = 16,384 x 20);
    and the ordered pool of rank 0's shapes of the tiered table over the
    hybrid phases' W ranks (bitwise) beside `embedding_bag(per_sample_weights=)`
    over its owned rows. Then a weighted row whose weights cancel (+1, -1 in
    two samples) is touched and its gradient is exact."""
    import torch.nn.functional as F

    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.core.types import Optimizer_t
    from hugectr_tpu_torch.embedding.collection import EmbeddingCollection, onehot_fwd_lookups
    from hugectr_tpu_torch.ops import onehot_matmul as oh
    from hugectr_tpu_torch.ops import ordered_pool as op
    from hugectr_tpu_torch.ops import segscan as ss
    from hugectr_tpu_torch.optim.params import OptParams
    from hugectr_tpu_torch.tools import weighted as wt
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms

    keys_np, w_np, d_np = wt.weighted_batch(0)
    keys = torch.as_tensor(keys_np, device=dev)
    w = torch.as_tensor(w_np, device=dev)
    d32 = torch.as_tensor(d_np, device=dev)
    h = keys.shape[1]
    plan = wt.weighted_plan(True)
    g = next(x for x in plan.groups if x.compute_kind == "onehot")
    lks = onehot_fwd_lookups(g)
    (lk,) = lks
    gen = torch.Generator(device=dev).manual_seed(23)
    in_win = (keys >= lk.key_lo) & (keys < lk.key_hi)
    k_rel = torch.where(in_win, keys, -1).to(torch.int32).contiguous()
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        isz = 2 if dt == torch.bfloat16 else 4
        # the superhot tier's weighted forward: one launch for the group
        t0 = time.perf_counter()
        table = torch.empty((g.total_local_rows, E), device=dev).normal_(generator=gen).to(dt)
        call = lambda: oh.onehot_fwd_group([keys], lks, table, g.out_width, [w])  # noqa: E731
        got = call()
        want = oh.onehot_fwd_group_plain([keys], lks, table, g.out_width, [w])
        scale = oh.onehot_fwd_group_plain([keys], lks, table.float().abs(), g.out_width, [w.abs()])
        uniq = int(torch.unique(keys[in_win]).numel())
        valid = int(in_win.sum())
        b_ms, b_by = bound(keys.numel() * 8 + uniq * E * isz + B * E * isz, 2 * valid * E)
        dms, per_call = device_ms(call, KERNEL_NAMES["onehot_fwd"])
        kl, wl = torch.where(in_win, keys, 0).long(), torch.where(in_win, w, 0.0).to(dt)
        lib = lambda: F.embedding_bag(kl, table, mode="sum", per_sample_weights=wl)  # noqa: E731
        rec = dict(kernel="onehot_fwd", case="weighted_superhot_V1024_h20", dtype=dname, B=B, V=lk.vocab, h=h, E=E,
                   weighted=True, route=oh.fwd_route(lk.vocab, h, E, dev, weighted=True), in_window=valid,
                   scaled_err=scaled_err(got, want, scale), max_abs_err=float((got.float() - want.float()).abs().max()),
                   tol=TOL[dname], ms=time_ms(call), device_ms=dms, device_launches_per_call=per_call,
                   plain_ms=time_ms(lambda: oh.onehot_fwd_group_plain([keys], lks, table, g.out_width, [w]),
                                    samples=5, inner=1),
                   library_ms=time_ms(lib),
                   library="torch.nn.functional.embedding_bag(mode='sum', per_sample_weights=) of the window's keys",
                   bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0)
        results.append(rec)
        emit(rec)
        if not (rec["scaled_err"] <= TOL[dname] and per_call in (1, None)):
            raise AssertionError(f"weighted one-hot forward disagrees with its plain version: {rec}")
        # the weighted backward: the superhot tier (global atomics) and a privatised shape
        rng = np.random.default_rng(29)
        k108 = torch.as_tensor(power_law(rng, 108, (B, 40)).astype(np.int32), device=dev)
        w108 = torch.as_tensor(rng.standard_normal((B, 40), dtype=np.float32), device=dev)
        for case, kk, ww, v in (("weighted_superhot_V1024_h20", k_rel, w, lk.vocab),
                                ("weighted_V108_h40", k108, w108, 108)):
            t0 = time.perf_counter()
            d = d32.to(dt)
            call = lambda: oh.onehot_matmul_bwd(kk, d, v, dt, weights=ww)  # noqa: E731
            grad, cnt = call()
            want_g, want_c = oh.onehot_matmul_bwd_plain(kk, d, v, dt, weights=ww)
            scale_g, _ = oh.onehot_matmul_bwd_plain(kk, d.float().abs(), v, torch.float32, weights=ww.abs())
            torch.cuda.synchronize()
            ok_keys = (kk >= 0) & (kk < v)
            flat = kk[ok_keys].long()
            rows = (d.float().repeat_interleave(kk.shape[1], dim=0) * ww.reshape(-1, 1))[ok_keys.reshape(-1)].to(dt)
            lib = lambda: torch.zeros((v, E), dtype=dt, device=dev).index_add_(0, flat, rows)  # noqa: E731
            b_ms, b_by = bound(kk.numel() * 8 + B * E * isz + v * E * 4 + v * 4, 2 * int(ok_keys.sum()) * E)
            dms, per_call = device_ms(call, KERNEL_NAMES["onehot_bwd"])
            cnt_err = float(((cnt - want_c).abs() / want_c.clamp(min=1e-30)).max())
            rec2 = dict(kernel="onehot_bwd", case=case, dtype=dname, B=B, V=v, h=int(kk.shape[1]), E=E, weighted=True,
                        route=oh.bwd_route(B, int(kk.shape[1]), v, E, dev),
                        scaled_err=scaled_err(grad, want_g, scale_g),
                        max_abs_err=float((grad.float() - want_g.float()).abs().max()),
                        touched_exact=bool(torch.equal(cnt > 0, want_c > 0)), counts_rel_err=cnt_err, tol=TOL[dname],
                        ms=time_ms(call), device_ms=dms, device_launches_per_call=per_call,
                        plain_ms=time_ms(lambda: oh.onehot_matmul_bwd_plain(kk, d, v, dt, weights=ww)),
                        library_ms=time_ms(lib),
                        library="Tensor.index_add_ of the w-scaled cotangent rows (grad only)",
                        bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0)
            results.append(rec2)
            emit(rec2)
            if not (rec2["scaled_err"] <= TOL[dname] and rec2["touched_exact"] and cnt_err <= TOL["float32"]):
                raise AssertionError(f"weighted one-hot backward disagrees with its plain version: {rec2}")
        # segscan over the untiered sorted route's per-key rows (K = B x 20)
        t0 = time.perf_counter()
        srt, perm = torch.sort(keys.reshape(-1).long(), stable=True)
        src = torch.arange(B, device=dev).repeat_interleave(h)[perm]
        vals = (d32[src] * w.reshape(-1)[perm].unsqueeze(1)).to(dt).contiguous()
        heads = torch.ones_like(srt, dtype=torch.bool)
        heads[1:] = srt[1:] != srt[:-1]
        k = int(srt.numel())
        call = lambda: ss.segmented_sum_sorted(vals, heads)  # noqa: E731
        got = call()
        want = ss.segmented_sum_sorted_plain(vals, heads)
        scale = ss.segmented_sum_sorted_plain(vals.float().abs(), heads)
        b_ms, b_by = bound(k * E * isz + k * E * 4 + k, k * E)
        dms, per_call = device_ms(call, KERNEL_NAMES["segscan"])
        rec3 = dict(kernel="segscan", case=f"weighted_K{k}", dtype=dname, K=k, E=E, weighted=True,
                    segments=int(heads.sum()), scaled_err=scaled_err(got, want, scale),
                    max_abs_err=float((got.float() - want.float()).abs().max()), tol=TOL[dname],
                    bitwise_repeat=bool(torch.equal(call(), got)), ms=time_ms(call), device_ms=dms,
                    device_launches_per_call=per_call,
                    plain_ms=time_ms(lambda: ss.segmented_sum_sorted_plain(vals, heads), samples=5, inner=1, warmup=1),
                    library_ms=None, library="none: no single PyTorch call computes a segmented scan",
                    bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0)
        results.append(rec3)
        emit(rec3)
        if not (rec3["scaled_err"] <= TOL[dname] and rec3["bitwise_repeat"]):
            raise AssertionError(f"segscan disagrees on the weighted per-key rows: {rec3}")
    # the weighted ordered pool at rank 0's shapes of hybrid_weighted_path (bf16, as the bench)
    world = hybrid_world(torch)
    ec = EmbeddingCollection(wt.weighted_plan(True, world), ResourceManager(dev, 0, world),
                             OptParams(Optimizer_t.RowWiseAdaGrad), dtype=torch.bfloat16)
    for gp in ec.plan.groups:
        if gp.compute_kind != "rowop":
            continue
        t0 = time.perf_counter()
        gk = ec._group_keys(gp, {"f": keys})
        gw = ec._group_weights(gp, {"w": w}, gk)
        srows, offsets, sw = ec._pool_segments(gp.name, gk, gp.total_local_rows, None, gw)
        n = offsets.numel() - 1
        table = torch.empty((gp.total_local_rows, E), device=dev).normal_(generator=gen).to(torch.bfloat16)
        call = lambda: op.ordered_pool(table, srows, offsets, sw)  # noqa: E731
        got = call()
        want = op.ordered_pool_plain(table, srows, offsets, sw)
        torch.cuda.synchronize()
        pooled = srows < gp.total_local_rows
        lens = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
            0, torch.repeat_interleave(torch.arange(n, device=dev), offsets.diff()), pooled.long())
        owned = srows[pooled]
        obounds = torch.cat([lens.new_zeros(1), lens.cumsum(0)])
        uniq = int(torch.unique(owned).numel())
        ids_read = int(torch.minimum(lens + 1, offsets.diff()).sum())
        b_ms, b_by = bound(uniq * E * 2 + ids_read * 12 + 8 * (n + 1) + n * E * 2, 2 * int(owned.numel()) * E)
        dms, per_call = device_ms(call, KERNEL_NAMES["ordered_pool"])
        wo = sw[pooled].to(torch.bfloat16)
        lib = lambda: F.embedding_bag(owned, table, obounds[:-1], mode="sum", per_sample_weights=wo)  # noqa: E731
        rec = dict(kernel="ordered_pool", case=f"weighted_{gp.name}_w{world}", dtype="bfloat16", K=int(srows.numel()),
                   slots=n, E=E, weighted=True, owned=int(owned.numel()), unique_rows=uniq,
                   bitwise=bool(torch.equal(bits(torch, got), bits(torch, want))),
                   bitwise_repeat=bool(torch.equal(bits(torch, call()), bits(torch, got))),
                   max_abs_err=float((got.float() - want.float()).abs().max()), tol=0.0, ms=time_ms(call),
                   device_ms=dms, device_launches_per_call=per_call,
                   plain_ms=time_ms(lambda: op.ordered_pool_plain(table, srows, offsets, sw), samples=5, inner=1,
                                    warmup=1),
                   library_ms=time_ms(lib),
                   library="torch.nn.functional.embedding_bag(mode='sum', offsets, per_sample_weights=) over the "
                           "owned rows (float32 sums, one rounding)",
                   bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0)
        rec["scaled_err"] = 0.0 if rec["bitwise"] else math.inf
        results.append(rec)
        emit(rec)
        if not (rec["bitwise"] and rec["bitwise_repeat"]):
            raise AssertionError(f"weighted ordered_pool differs from its plain version: {rec}")
    # weights that cancel across samples: the row is touched, its gradient exact
    kc = torch.tensor([[5], [5]], dtype=torch.int32, device=dev)
    wc = torch.tensor([[1.0], [-1.0]], device=dev)
    dc = torch.zeros((2, E), device=dev)
    dc[0, 0] = 1.0
    gc, cc = oh.onehot_matmul_bwd(kc, dc, 16, torch.float32, weights=wc)
    rec = dict(kernel="onehot_bwd", case="weighted_cancel", touch_count=float(cc[5]), grad_row=gc[5, :4].tolist())
    emit(rec)
    if not (float(cc[5]) == 2.0 and float(cc.sum()) == 2.0 and gc[5, 0].item() == 1.0 and float(gc.abs().sum()) == 1.0):
        raise AssertionError(f"a weighted row whose weights cancel is not touched, or its gradient is wrong: {rec}")


WEIGHTED_STEPS = 6


def weighted_case(results, name: str, weighted_launches):
    """A kernel's weighted case for the `kernels` line: the bf16 case (the
    weighted path's type) with the most device time, and its launches on
    `weighted_path` (the tiered run's weighted launches of the one-hot
    kernels; segscan's on the untiered run, on the per-key rows)."""
    r = max((x for x in results if x["kernel"] == name and x.get("weighted") and x["dtype"] == "bfloat16"),
            key=lambda x: x["device_ms"])
    out = {k: r[k] for k in ("case", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")}
    if weighted_launches is not None:
        out["launches"] = (weighted_launches["untiered"]["launches"][name] if name == "segscan"
                           else weighted_launches["tiered"]["weighted"][name])
    return out


def weighted_path(torch):
    """The repo's weighted configuration at full width
    (benchmarks/weighted_bench.py:30-37, `tools/weighted.py`: one
    2,000,000-row weighted Sum table, ev 128, hotness 20, batch 16,384, bf16
    tables, rowwise AdaGrad, weights uniform in [0, 1) from the seed),
    untiered and tiered (hot 131,072 / split vocab 16,384 / superhot 1,024),
    6 steps of the collection each (the bench's step). Counters set to 0
    just before the steps and read just after: untiered, segscan on the
    per-key rows (K = 16,384 x 20) once a step; tiered, the weighted one-hot
    forward and backward once a step each and segscan for the cold tier; no
    plain version. Reports median ms/step of steps 2-6, ex/s, routes,
    launches a step, peak memory and the card. The bench's UCAP settings
    (HCTR_TPU_UCAP_*) are not ported: cut."""
    from hugectr_tpu_torch import ops
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools import weighted as wt

    rm = ResourceManager.create()
    keys, w, d = (torch.as_tensor(a, device=rm.device) for a in wt.weighted_batch(0))
    out = {}
    for tiers in (False, True):
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ec = wt.weighted_collection(rm, tiers)
        tables = ec.init(rm.generator(0))
        state = ec.init_optimizer(tables)
        torch.cuda.synchronize()
        ops.reset_counts()
        run = wt.run_steps(ec, tables, state, keys, w, d, WEIGHTED_STEPS)
        lc, wc, pc = ops.launch_counts(), ops.weighted_counts(), ops.plain_counts()
        with torch.no_grad():
            pooled = ec.forward(tables, {"f": keys}, {"w": w})["e"]
        rec = dict(phase="weighted_path", tiers=tiers, card=card_line(), source=WEIGHTED_SOURCE,
                   table_rows=wt.VOCAB, ev=wt.EV, hotness=wt.HOT, batch=B, dtype="bfloat16",
                   optimizer="rowwise_adagrad", cut="HCTR_TPU_UCAP_* (no counterpart in the port)",
                   groups={g.name: [g.compute_kind, g.total_local_rows] for g in ec.plan.groups},
                   routes=dict(ec.group_routes), step_ms=run["step_ms"],
                   median_ms_per_step=run["median_ms_per_step"],
                   examples_per_s=B / (run["median_ms_per_step"] / 1e3),
                   launches_per_step={k: v / WEIGHTED_STEPS for k, v in lc.items()},
                   weighted_launches_per_step={k: v / WEIGHTED_STEPS for k, v in wc.items()}, plain_calls=pc,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   output_finite=bool(torch.isfinite(pooled.float()).all()), seconds=time.perf_counter() - t0)
        emit(rec)
        ok = rec["output_finite"] and not any(pc.values()) and lc["segscan"] >= WEIGHTED_STEPS
        if tiers:
            ok = ok and wc["onehot_fwd"] == lc["onehot_fwd"] == WEIGHTED_STEPS
            ok = ok and wc["onehot_bwd"] == lc["onehot_bwd"] == WEIGHTED_STEPS and "onehot" in rec["routes"].values()
        else:
            ok = ok and rec["routes"] == {"mp_ev128": "sorted"} and lc["onehot_fwd"] == 0
        if not ok:
            raise AssertionError(f"weighted path did not run its kernels as planned: {rec}")
        out["tiered" if tiers else "untiered"] = {"launches": lc, "weighted": wc}
        del ec, tables, state
    return out


def weighted_parity(torch):
    """A tiny weighted collection (`tools/weighted.py::TINY["split"]`: Sum
    and Mean lookups with signed weights, a Mean row whose weights are all
    0, a split table whose superhot tier takes the weighted one-hot
    kernels) 3 steps on the card against the port on the CPU from the same
    tables: outputs and tables within rtol 1e-4 / atol 1e-5 (the kernels sum
    in another order). Then W = 2 ranks on the card over gloo against one
    card, "split" (the weighted ordered pool of the partitioned forward) and
    "dx" (weighted Concat lookups on the unique-key dense exchange, its
    all_to_all counted), the same tolerance."""
    import numpy as np

    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools import hybrid
    from hugectr_tpu_torch.tools import weighted as wt

    t0 = time.perf_counter()
    rec = dict(phase="weighted_parity", card=card_line())

    def worst(got, want):
        e = 0.0
        for s in want["fwd"]:
            for k, v in want["fwd"][s].items():
                g = got["fwd"][s][k] if isinstance(got, dict) else np.concatenate([r["fwd"][s][k] for r in got])
                e = max(e, float((np.abs(g - v) - (1e-5 + 1e-4 * np.abs(v))).max()))
        for t, v in want["tables"].items():
            g = got["tables"][t] if isinstance(got, dict) else got[0]["tables"][t]
            e = max(e, float((np.abs(g - v) - (1e-5 + 1e-4 * np.abs(v))).max()))
        return e

    inp = wt.tiny_inputs("split", 256, 3, 11)
    card = wt.tiny_run(ResourceManager.create(), inp)
    cpu = wt.tiny_run(ResourceManager.create(device="cpu"), inp)
    rec["card_vs_cpu_excess"] = worst(card, cpu)
    rec["card_weighted_launches"] = card["weighted_launches"]
    rec["routes"] = card["routes"]
    backend = hybrid.default_backend(2)
    rec["backend"] = backend
    for case in ("split", "dx"):
        inp = wt.tiny_inputs(case, 256, 3, 13)
        one = wt.tiny_run(ResourceManager.create(), inp)
        ranks = hybrid.run(wt.tiny_run, 2, inp, backend=backend, timeout=300.0)
        rec[f"w2_{case}_excess"] = worst(ranks, one)
        rec[f"w2_{case}_weighted_launches"] = [r["weighted_launches"] for r in ranks]
        rec[f"w2_{case}_all_to_all"] = [r["collective_calls"].get("all_to_all", 0) for r in ranks]
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    wl = card["weighted_launches"]
    if not (rec["card_vs_cpu_excess"] <= 0 and wl["onehot_fwd"] == 3 and wl["onehot_bwd"] > 0
            and rec["w2_split_excess"] <= 0 and rec["w2_dx_excess"] <= 0
            and all(x["ordered_pool"] > 0 for x in rec["w2_split_weighted_launches"])
            and all(n > 0 for n in rec["w2_dx_all_to_all"])):
        raise AssertionError(f"weighted parity: {rec}")


def hybrid_weighted_path(torch):
    """`weighted_path`'s tiered case over W = max(2, cards) ranks as
    `hybrid_path` runs its model (`tools/hybrid.py --model weighted`, rank
    function `tools/weighted.py::rank_run`): each rank its block of the
    global batch of 16,384; the owner-partitioned forward launches the
    weighted ordered pool for the hot and cold tiers on every rank, the
    one-hot group's weighted kernels once a step; each rank's ordered pool
    against its plain version on its own shapes of the gathered batch,
    bitwise. Gloo with ranks sharing a card runs 4 steps."""
    from hugectr_tpu_torch.tools import hybrid
    from hugectr_tpu_torch.tools import weighted as wt

    t0 = time.perf_counter()
    world = hybrid_world(torch)
    backend = hybrid.default_backend(world)
    steps = 4 if backend == "gloo" else WEIGHTED_STEPS
    cfg = dict(tiers=True, steps=steps, seed=0, batch=B, vocab=wt.VOCAB, dtype="bfloat16")
    ranks = hybrid.run(wt.rank_run, world, {"config": json.dumps(cfg)}, backend=backend, timeout=900.0)
    rec = dict(phase="hybrid_weighted_path", card=card_line(), world=world, backend=backend,
               staged_through_host=backend == "gloo", device_count=torch.cuda.device_count(), **cfg,
               source=WEIGHTED_SOURCE,
               ranks=[{k: hybrid.jsonable(r[k]) for k in ("median_ms_per_step", "routes", "launches_per_step",
                                                           "weighted_launches_per_step", "collective_calls_per_step",
                                                           "peak_memory_bytes", "pool_checks")} for r in ranks],
               seconds=time.perf_counter() - t0)
    emit(rec)
    for r in ranks:
        wl, lc = r["weighted_launches_per_step"], r["launches_per_step"]
        checks = r["pool_checks"]
        if not (wl["ordered_pool"] >= 2 and wl["ordered_pool"] == lc["ordered_pool"] and wl["onehot_fwd"] == 1
                and wl["onehot_bwd"] == 1 and checks and all(c["bitwise"] for c in checks.values())):
            raise AssertionError(f"hybrid weighted path: {rec}")
    return [{k: v * steps for k, v in r["weighted_launches_per_step"].items()} for r in ranks]


def _entries(ec, model, names):
    """{table: {key: (row, *state rows)}} of dynamic tables, host copies."""
    out = {}
    for name in names:
        g, ti = ec._find_table(name)
        keys, vals, st = ec._collect_dynamic_entries(model.tables, model.eopt, g, ti)
        out[name] = dict(zip(keys.tolist(), zip(vals, *st.values())))
    return out


def _dropped(ec, model, batch, names):
    """{table: distinct keys of the batch that its store holds nowhere}."""
    import numpy as np

    fk = model._feature_keys(model._decode_batch(batch))
    out = {}
    for name in names:
        g, ti = ec._find_table(name)
        lm = next(lm for lm in g.lookups if lm.table_index == ti)
        keys = fk[lm.bottom_name].cpu().numpy().reshape(-1)
        keys = np.unique(keys[keys >= 0])
        slots = ec._dynamic_host_slots(ec._host_key_store(model.tables, g), g, ti, keys)
        out[name] = int((slots < 0).sum())
    return out


def upkeep_path(torch):
    """Eviction and growth on the full-width dynamic DLRM-FTRL
    (`ftrl_dynamic_path`'s model: 26 dynamic tables of 4,096 rows, batch
    16,384): 3 steps; `evict` of 256 resident keys of each of two tables
    (their rows and FTRL state become 0, their store rows EMPTY; they insert
    again in the next step); `grow_dynamic_capacity` of the two tables that
    dropped the most keys in step 3 to 4x their capacity (every carried
    key's row and state bitwise; the grown tables lose no key; a table that
    kept its capacity may lose the keys the JAX package's re-insertion
    order loses, counted); 3 more steps; each grown table's dropped keys
    before and after."""
    import numpy as np

    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools.flagship import build_dlrm_ftrl

    t0 = time.perf_counter()
    model = build_dlrm_ftrl(ResourceManager.create(), batchsize=B, dynamic=True, ev_size=E, synthetic_batches=6,
                            max_eval_batches=1)
    model.start_data_reading()
    batches = [next(model._train_iter) for _ in range(6)]
    names = [str(i) for i in range(26)]
    losses = [model.train() for _ in range(3)]
    ec = model.ec
    dropped3 = _dropped(ec, model, batches[2], names)
    # evict: 256 resident keys of tables 0 and 1
    evicted, ev_ok = {}, True
    for name in ("0", "1"):
        g, ti = ec._find_table(name)
        slots, live = ec._live_slots(ec._host_key_store(model.tables, g), g, ti)
        keys = live[:256]
        ec.evict(model.tables, model.eopt, name, keys)
        idx = torch.as_tensor(slots[:256], device=ec.device)
        ev_ok = ev_ok and bool((model.tables[g.name][idx] == 0).all()) and bool(
            (model.tables[f"{g.name}#keys"][idx] == ec.EMPTY_KEY).all()) and all(
            bool((v[idx] == 0).all()) for v in model.eopt[g.name].values())
        evicted[name] = keys
    grow = sorted(names, key=lambda n: -dropped3[n])[:2]
    before = _entries(ec, model, names)
    t1 = time.perf_counter()
    for name in grow:
        g, ti = model.ec._find_table(name)
        model.ec, model.tables, model.eopt = model.ec.grow_dynamic_capacity(
            model.tables, model.eopt, name, 4 * int(g.table_vocab[ti]))
    torch.cuda.synchronize()
    grow_s = time.perf_counter() - t1
    after = _entries(model.ec, model, names)
    # the growth re-inserts every dynamic table's keys one by one in row
    # order, as the JAX package does, so a nearly full table that kept its
    # capacity may lose a key whose probe run the new order fills first
    lost = {n: len(set(before[n]) - set(after[n])) for n in names}
    carried = all(set(after[n]) <= set(before[n]) and all(
        all(torch.equal(a, b) for a, b in zip(v, before[n][k])) for k, v in after[n].items()) for n in names)
    losses += [model.train() for _ in range(3)]
    dropped6 = _dropped(model.ec, model, batches[5], names)
    reinserted = {n: int(np.isin(k, list(_entries(model.ec, model, [n])[n])).sum()) for n, k in evicted.items()}
    rec = dict(phase="upkeep_path", card=card_line(), tables=26, capacity=4096, batch=B, losses=losses,
               evicted={n: int(k.size) for n, k in evicted.items()}, evicted_zero=ev_ok,
               reinserted_after_evict=reinserted, grown={n: 4 * 4096 for n in grow},
               dropped_step3={n: dropped3[n] for n in grow}, dropped_step6={n: dropped6[n] for n in grow},
               carried_bitwise=carried, carried_keys=sum(len(v) for v in after.values()),
               lost_in_growth={n: k for n, k in lost.items() if k}, grow_seconds=grow_s,
               groups={g.name: g.total_local_rows for g in model.ec.plan.groups},
               max_memory_allocated=torch.cuda.max_memory_allocated(), seconds=time.perf_counter() - t0)
    emit(rec)
    model._close_readers()
    if not (ev_ok and carried and all(math.isfinite(x) for x in losses) and not any(lost[n] for n in grow)
            and all(rec["dropped_step6"][n] <= rec["dropped_step3"][n] for n in grow)):
        raise AssertionError(f"upkeep path: {rec}")


def host_spill_model(rm, batch: int, capacity: int, ev: int, hotness: int):
    """benchmarks/host_spill_bench.py:34's model: one dynamic table of
    `capacity` rows (bf16), Concat with 13 dense, MLP 256-1, BCE, AdaGrad."""
    import hugectr_tpu_torch as hugectr

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


HOST_TIER = dict(batch=4096, capacity=131072, ev=64, hotness=5)  # benchmarks/host_spill_bench.py:116-121


def host_tier_path(torch):
    """The host-spill tier at benchmarks/host_spill_bench.py:116-121's
    settings (batch 4,096, a dynamic table of 131,072 rows, ev 64, hotness
    5, bf16, AdaGrad): in one call, 20 warm-up and 20 timed steps without a
    tier on keys below the capacity, then with `HostSpillTier` on a
    power-law stream over 4x the capacity (each step stages the batch's
    master rows first, spilling the least recently used half under the 0.75
    watermark): ex/s of each (host clock around synchronised steps), rows
    staged a step, the master's size. Then one `EmbeddingTrainingCache` pass
    over a 64-row staging table of a 20,000-row master: stage, map, one
    step, flush (touched rows changed, others bitwise)."""
    import numpy as np

    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.data.generator import power_law_keys
    from hugectr_tpu_torch.embedding.host_spill import HostSpillTier
    from hugectr_tpu_torch.embedding.training_cache import EmbeddingTrainingCache

    t0 = time.perf_counter()
    hs = HOST_TIER
    rm = ResourceManager.create()
    model = host_spill_model(rm, **hs)
    rng, lab = np.random.default_rng(0), np.random.default_rng(1)

    def phase(tier, vocab, warm=20, steps=20):
        staged = []

        def step():
            keys = power_law_keys(rng, vocab, hs["batch"] * hs["hotness"], 1.05).reshape(hs["batch"], -1)
            keys = keys.astype(np.int32)
            if tier is not None:
                staged.append(tier.stage_batch(keys))
            model._staged_train_batch = model._put_batch({
                "label": (lab.random((hs["batch"], 1)) > 0.5).astype(np.float32),
                "dense": lab.random((hs["batch"], 13)).astype(np.float32), "d0": keys})
            return model.train_async()

        for _ in range(warm):
            step()
        torch.cuda.synchronize()
        staged.clear()
        t = time.perf_counter()
        for _ in range(steps):
            loss = step()
        torch.cuda.synchronize()
        return steps * hs["batch"] / (time.perf_counter() - t), staged, float(loss)

    ex_ref, _s, loss_ref = phase(None, hs["capacity"])
    tier = HostSpillTier(model, "dyn", spill_watermark=0.75)
    ex_tier, staged, loss_tier = phase(tier, 4 * hs["capacity"])
    g, ti = model.ec._find_table("dyn")
    resident = int((model.tables[f"{g.name}#keys"] != model.ec.EMPTY_KEY).sum())
    model._close_readers()
    del model
    # one pass of the embedding training cache
    static = build_etc_model(rm)
    host = np.random.default_rng(2).normal(size=(20000, 16)).astype(np.float32)
    before = host.copy()
    etc = EmbeddingTrainingCache(static, "huge", host)
    keyset = np.arange(5000, 5060)
    etc.update(keyset)
    mapped = etc.map_keys(np.random.default_rng(3).integers(4990, 5070, (256, 2)))
    static.train_step(static._put_now({"label": np.ones((256, 1), np.float32),
                                       "dense": np.zeros((256, 2), np.float32), "d0": mapped.astype(np.int32)}))
    etc.flush()
    touched = np.unique(mapped[mapped >= 0]) + 5000
    etc_ok = (not np.array_equal(host[touched], before[touched])
              and np.array_equal(np.delete(host, touched, 0), np.delete(before, touched, 0)))
    static._close_readers()
    rec = dict(phase="host_tier_path", card=card_line(), **hs, dtype="bfloat16", source="benchmarks/host_spill_bench.py",
               steps=20, warmup_steps=20, no_tier_examples_per_s=ex_ref, tier_examples_per_s=ex_tier,
               tier_over_no_tier=ex_tier / ex_ref, staged_rows_per_step=float(np.mean(staged)),
               staged_rows_max=int(max(staged)), host_size=tier.host_size, device_resident=resident,
               losses=[loss_ref, loss_tier], etc_pass_ok=bool(etc_ok), etc_rows_touched=int(touched.size),
               seconds=time.perf_counter() - t0)
    emit(rec)
    if not (etc_ok and math.isfinite(loss_ref) and math.isfinite(loss_tier) and tier.host_size > hs["capacity"] // 2
            and resident <= hs["capacity"]):
        raise AssertionError(f"host tier path: {rec}")


def build_etc_model(rm):
    """tests/test_training_cache.py:15's model: a 64-row static table (ev
    16), InnerProduct, BCE, SGD, batch 256."""
    import hugectr_tpu_torch as hugectr

    solver = hugectr.CreateSolver(max_eval_batches=1, batchsize_eval=256, batchsize=256, lr=0.1)
    reader = hugectr.DataReaderParams(data_reader_type=hugectr.DataReaderType_t.Synthetic, synthetic_num_batches=2)
    model = hugectr.Model(solver, reader, hugectr.CreateOptimizer(optimizer_type=hugectr.Optimizer_t.SGD),
                          resource_manager=rm)
    model.add(hugectr.Input(label_dim=1, label_name="label", dense_dim=2, dense_name="dense",
                            data_reader_sparse_param_array=[hugectr.DataReaderSparseParam("d0", 2, True, 1)]))
    ebc = hugectr.EmbeddingCollectionConfig()
    ebc.embedding_lookup(hugectr.EmbeddingTableConfig(name="huge", max_vocabulary_size=64, ev_size=16), "d0",
                         "emb", "sum")
    ebc.shard(shard_matrix=[["huge"]], shard_strategy=[("mp", ["huge"])])
    model.add(ebc)
    model.add(hugectr.DenseLayer(layer_type=hugectr.Layer_t.InnerProduct, bottom_names=["emb"],
                                 top_names=["logit"], num_output=1, act_type=hugectr.Activation_t.Non))
    model.add(hugectr.DenseLayer(layer_type=hugectr.Layer_t.BinaryCrossEntropyLoss, bottom_names=["logit", "label"],
                                 top_names=["loss"]))
    model.compile()
    model.start_data_reading()
    return model


def sok_path(torch):
    """`sok.LookupEngine` over DLRM-FTRL's 26 tables (the sample's slot
    sizes capped at 400,000, ev 128, hotness 1; the engine's default
    thresholds, so the small tables take the one-hot group), batch 16,384,
    `OptimizerWrapper` rowwise AdaGrad for 3 steps: the engine's lookup
    bitwise equal to an `EmbeddingCollection` of the same plan on the same
    tables and keys, `sok.dump` / `sok.load` bitwise, routes and launches a
    step."""
    import shutil
    import tempfile

    import numpy as np

    from hugectr_tpu_torch import ops, sok
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.embedding.collection import EmbeddingCollection
    from hugectr_tpu_torch.optim.params import OptParams
    from hugectr_tpu_torch.parallel.plan import EmbeddingTableConfig
    from hugectr_tpu_torch.core.types import Optimizer_t
    from hugectr_tpu_torch.tools.flagship import FTRL_SLOT_SIZES

    t0 = time.perf_counter()
    rm = ResourceManager.create()
    sok.init(rm)
    cfgs = [EmbeddingTableConfig(str(i), min(v, 400_000), E) for i, v in enumerate(FTRL_SLOT_SIZES)]
    opt = OptParams(Optimizer_t.RowWiseAdaGrad, lr=0.01)
    eng = sok.LookupEngine(cfgs, [1] * 26, ["sum"] * 26, opt)
    tables = eng.init(0)
    wrapper = sok.OptimizerWrapper(eng)
    state = wrapper.initialize(tables)
    rng = np.random.default_rng(3)
    batches = [[torch.as_tensor(power_law(rng, c.max_vocabulary_size, (B, 1)).astype(np.int32), device=rm.device)
                for c in cfgs] for _ in range(3)]
    d = [torch.as_tensor(rng.standard_normal((B, E), dtype=np.float32), device=rm.device) for _ in range(26)]
    # the same plan as a plain collection on the same tables
    ref = EmbeddingCollection(eng.compiled, rm, opt)
    with torch.no_grad():
        got = sok.lookup_sparse(eng, tables, batches[0])
        want = ref.forward(tables, {lk.bottom_name: batches[0][i] for i, lk in enumerate(eng.compiled.lookups)})
    equal = all(torch.equal(got[i], want[lk.top_name]) for i, lk in enumerate(eng.compiled.lookups))
    torch.cuda.synchronize()
    ops.reset_counts()
    step_ms = []
    for keys in batches:
        t = time.perf_counter()
        with torch.no_grad():
            sok.lookup_sparse(eng, tables, keys)
            wrapper.apply_gradients(tables, state, keys, d, 0.01, 1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = ops.launch_counts()
    tmp = tempfile.mkdtemp(prefix="hctr_sok_")
    try:
        t = time.perf_counter()
        sok.dump(tmp, eng, tables)
        dump_s = time.perf_counter() - t
        back = sok.load(tmp, eng, eng.init(9))
        dump_bytes = dir_bytes(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    round_trip = all(torch.equal(back[g], tables[g]) for g in tables)
    rec = dict(phase="sok_path", card=card_line(), tables=26, ev=E, hotness=1, batch=B, optimizer="rowwise_adagrad",
               groups={g.name: [g.compute_kind, g.total_local_rows] for g in eng.compiled.groups},
               routes=dict(eng.ec.group_routes), lookup_equals_collection=equal, step_ms=step_ms,
               launches_per_step={k: v / 3 for k, v in launches.items()}, dump_load_bitwise=round_trip,
               dump_bytes=dump_bytes, dump_seconds=dump_s, seconds=time.perf_counter() - t0)
    emit(rec)
    sok._RM = None
    if not (equal and round_trip and launches["onehot_fwd"] == 3 and launches["onehot_bwd"] > 0):
        raise AssertionError(f"sok path: {rec}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hugectr_tpu_torch.core import mesh
    from hugectr_tpu_torch.ops import _lib
    from hugectr_tpu_torch.tools import devtime

    t0 = time.perf_counter()
    card = card_line()
    _lib.library()
    ptxas = [ln.strip() for ln in _lib.build_info["log"].splitlines() if "Used" in ln or "spill" in ln]
    emit(dict(phase="card", card=card, torch=torch.__version__, cuda=torch.version.cuda,
              device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
              collectives=mesh.COLLECTIVE_NAMES, nvcc_seconds=_lib.build_info["seconds"], ptxas=ptxas, seconds=time.perf_counter() - t0))

    results, sample_results = [], []
    kernel_checks(torch, results)
    sample_kernel_checks(torch, sample_results)
    tiny_parity(torch)
    samples_parity(torch)
    weighted_parity(torch)
    launches, main_rec = main_path(torch)
    torch.cuda.empty_cache()
    file_launches = file_path(torch, main_rec)
    torch.cuda.empty_cache()
    bench_launches = bench_path(torch)
    torch.cuda.empty_cache()
    ftrl_launches = ftrl_path(torch)
    torch.cuda.empty_cache()
    ftrl_dynamic_path(torch)
    torch.cuda.empty_cache()
    weighted_launches = weighted_path(torch)
    torch.cuda.empty_cache()
    upkeep_path(torch)
    torch.cuda.empty_cache()
    host_tier_path(torch)
    torch.cuda.empty_cache()
    sok_path(torch)
    torch.cuda.empty_cache()
    file_i64_path(torch)
    torch.cuda.empty_cache()
    snapshot_path(torch)
    torch.cuda.empty_cache()
    snapshot_dynamic_path(torch)
    torch.cuda.empty_cache()
    snapshot_bf16(torch)
    freeze_launches = freeze_path(torch)
    torch.cuda.empty_cache()
    samples_launches = samples_path(torch)
    hybrid_parity(torch)
    hybrid_file_parity(torch)
    hybrid_bench_parity(torch)
    hybrid_partial_parity(torch)
    hybrid_exchange_parity(torch)
    mesh_parity(torch)
    hybrid_launches, hybrid_rec = hybrid_path(torch)
    hier_launches = hybrid_hier_path(torch, hybrid_rec)
    column_launches = hybrid_column_path(torch)
    hybrid_bench_launches = hybrid_bench_path(torch)
    hybrid_weighted = hybrid_weighted_path(torch)
    hybrid_ftrl_dynamic_path(torch)
    hybrid_snapshot(torch)

    sources = {
        "onehot_fwd": ("hugectr_tpu_torch/csrc/onehot_matmul.cu",
                       "hugectr_tpu/ops/pallas/onehot_matmul.py:63"),
        "onehot_bwd": ("hugectr_tpu_torch/csrc/onehot_matmul.cu",
                       "hugectr_tpu/ops/pallas/onehot_matmul.py:118"),
        "segscan": ("hugectr_tpu_torch/csrc/segscan.cu", "hugectr_tpu/ops/pallas/segscan.py:58"),
    }
    kernels = []
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "case")
    # the E 64 cases of the column-split sub-tables (`column_kernel_checks`)
    column = {x["kernel"]: x for x in results if x["case"].startswith("column_E")}
    bench_cases = {"onehot_fwd": "group20", "onehot_bwd": "superhot_", "segscan": "cold_tier_20"}
    rank_sfx = f"_w{hybrid_world(torch)}"
    for name, (src, replaces) in sources.items():
        # the float32 flagship case that costs the step most device time;
        # for onehot_fwd the step's one launch, the 13-table group
        r = max((x for x in results if x["kernel"] == name and x["dtype"] == "float32" and not x.get("weighted")
                 and (name != "onehot_fwd" or x["case"] == "group13")),
                key=lambda x: x["device_ms"])
        # beside it, the bench path's bf16 case with the most device time
        rb = max((x for x in results if x["kernel"] == name and x["dtype"] == "bfloat16"
                  and x["case"].startswith(bench_cases[name]) and not x["case"].endswith(rank_sfx)),
                 key=lambda x: x["device_ms"])
        # and the hybrid bench path's per-rank shapes (B/W rows; segscan over
        # one rank's owned keys)
        rh = max((x for x in results if x["kernel"] == name and x["case"].startswith(bench_cases[name])
                  and x["case"].endswith(rank_sfx)), key=lambda x: x["device_ms"])
        # and the DLRM-FTRL path's launches and its case with the most device time
        rf = max((x for x in results if x["kernel"] == name and x["case"].startswith("ftrl_")),
                 key=lambda x: x["device_ms"])
        # and the samples' widths: each graph's launches and the case with the most device time
        # (among the profiled ones: CUDA events at these sizes time the launch)
        cases = [x for x in sample_results if x["kernel"] == name]
        rs = max([x for x in cases if x["device_launches_per_call"] is not None] or cases,
                 key=lambda x: x["device_ms"])
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces, launches=launches[name],
            **{k: r[k] for k in keys}, file_path_launches=file_launches[name],
            bench_path_launches=bench_launches[name],
            bench_case={k: rb[k] for k in keys}, ftrl_path_launches=ftrl_launches[name],
            ftrl_case={k: rf[k] for k in keys}, freeze_path_launches=freeze_launches[name],
            hybrid_path_launches=[x[name] for x in hybrid_launches],
            hybrid_hier_path_launches=[x[name] for x in hier_launches],
            hybrid_column_path_launches=[x[name] for x in column_launches],
            hybrid_bench_path_launches=[x[name] for x in hybrid_bench_launches],
            hybrid_bench_case={k: rh[k] for k in keys},
            samples_path_launches={g: x[name] for g, x in samples_launches.items()},
            samples_case={**{k: rs[k] for k in keys}, "dtype": rs["dtype"]},
            **({"column_case": {k: column[name][k] for k in keys}} if name in column else {}),
            weighted_case=weighted_case(results, name, weighted_launches),
        ))
    # the ordered pool: a kernel of the paths over W ranks; its launches are
    # rank 0's on the hybrid path (steps and eval), beside the bench path's
    # and its bf16 case with the most device time (the unweighted cases of
    # `ordered_pool_checks`, which carry `index_add_ms`; the E 64 and the
    # weighted cases stand in `column_case` and `weighted_case`)
    pool = [x for x in results if x["kernel"] == "ordered_pool" and "index_add_ms" in x]
    r = max((x for x in pool if x["dtype"] == "float32"), key=lambda x: x["device_ms"])
    rb = max((x for x in pool if x["dtype"] == "bfloat16"), key=lambda x: x["device_ms"])
    kernels.append(dict(
        name="ordered_pool", route="cuda", source="hugectr_tpu_torch/csrc/ordered_pool.cu",
        replaces="hugectr_tpu/embedding/collection.py:882-900 (the scatter-add of _mp_fwd_partitioned; no Pallas kernel)",
        launches=hybrid_launches[0]["ordered_pool"], **{k: r[k] for k in keys},
        hybrid_path_launches=[x["ordered_pool"] for x in hybrid_launches],
        hybrid_hier_path_launches=[x["ordered_pool"] for x in hier_launches],
        hybrid_column_path_launches=[x["ordered_pool"] for x in column_launches],
        hybrid_bench_path_launches=[x["ordered_pool"] for x in hybrid_bench_launches],
        bench_case={k: rb[k] for k in keys}, index_add_ms=r["index_add_ms"], bench_index_add_ms=rb["index_add_ms"],
        column_case={k: column["ordered_pool"][k] for k in keys},
        weighted_case=dict(weighted_case(results, "ordered_pool", None),
                           launches=hybrid_weighted[0]["ordered_pool"],
                           hybrid_weighted_path_launches=[x["ordered_pool"] for x in hybrid_weighted]),
    ))
    # device times taken by CUDA events because the profiler recorded nothing
    emit(dict(phase="profiler", event_fallbacks=[list(x) for x in devtime.FALLBACKS]))
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
