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
   group storage. The grouped one-hot backward, one launch a group, at the
   f32 flagship's 13-table group (f32 and bf16 cotangents) and bench.py's
   20-lookup group: each lookup's route, one launch per call, the counts
   exact, two calls bitwise equal where every lookup takes the counts
   matmul, its times beside the bound and one `index_add_` of every (row,
   cotangent) pair of the group. Then the edge cases of the designs: grouped forward with Sum and Mean
   lookups, negative and >= V keys, int64 keys >= 2^31, all padding, h 1
   beside h 128, a one-lookup group against the per-table forward; every
   one-hot key on one row on each backward route, V at the privatised
   route's shared-memory tile edges, all padding, a group of int64 keys,
   wrapping keys, a window, Mean and Sum and shared rows on each route,
   the per-table backward on local keys, accumulation into a caller's
   buffers; segscan over one segment, all heads, K at a tile's
   edges, K below a tile and K = 0, and two runs compared bitwise. Then
   the shapes of bench.py's configuration: the grouped forward at its
   20-lookup group (seven superhot tiers reading the raw keys through their
   windows), f32 and bf16; the window's edge cases (lo - 1, lo, hi - 1, hi,
   keys past V and below -1, dropped by a tier and wrapped beside it by an
   unsplit lookup); table 20's superhot backward alone (V 1,024, h 100)
   through the per-table entry with the `index_add_` time beside it; the
   bf16 segscan of table 20's cold
   tier (bf16 rows, float32 sums). Then the shapes of DLRM with FTRL: the
   grouped forward at its 13-lookup hotness-1 group beside one
   `embedding_bag`, its grouped backward beside one `index_add_`, and
   segscan at K 16,384. Then the bench shapes of one of the W ranks of the
   hybrid phases (cases `_w{W}`): the 20-lookup group's forward and
   backward on B/W rows, the cold tier's segscan over the keys rank 0
   owns. Then the ordered pool of the owner-partitioned forward
   (csrc/ordered_pool.cu) bitwise against its plain version at rank 0's
   shapes of the hybrid phases (the f32 flagship's table-20 and 5-lookup
   groups, the bench configuration's bf16 tiers of table 20) and at the
   compact forward's shapes on one card (every valid key of the bench cold
   and hot tiers of table 20, bf16; the cold tier's also on the first 128
   columns of the [R, 129] rows of `rowwise_pack`), with its plan, its
   bound, `embedding_bag` and `index_add_` beside it (CUDA events and
   profiler device ms), and at its design's edges (row strides 128 to
   132, E 13 to 512, long and short slots across the id batches of 8, 16
   and 32 lanes, the first foreign id at 0, 1, 7, 8, 31, 32 and 33,
   weights; 3,000 slots of 0 to 100 rows).
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
   16,384, the caps measured on the first batch with a headroom of 1.05),
   6 training steps, a warm-up `eval()` and a timed `eval()` over 320
   batches of 16,384. Counters are set to 0 before the steps and before
   the timed eval; every kernel must launch in the steps, `onehot_fwd` once
   per step and once per eval batch (one launch for the 20-lookup group),
   the ordered pool once a step and eval batch for each group with a valid
   cap (the compact forward); each group's caps and route are printed;
   every loss must be finite and the eval's binned AUC within 1e-4 of the
   exact AUC of the same buffers. Reports ms/step, train and eval ex/s,
   peak memory, the routes and the launch counts.
   Both paths (4 and 5) print `Model.step_mode` ("graph": the steps after
   the first replay the captured step, and every launch count above holds
   on replays) and end with `graph_ab` ("main_path_graph_ab",
   "bench_path_graph_ab"): the captured step against the eager one from
   one saved state, in turns eager, graph, graph, eager: the losses
   bitwise, every table and state array bitwise or within the two modes'
   measured atomic spreads (at least one step of its type at its largest
   value), ms/step and ex/s (the graph turns under
   `torch.cuda.set_sync_debug_mode("error")`), replayed eval predictions
   bitwise the per-batch eval's with equal AUCs and its ms a batch, and
   `tools/trace_step.py::profile_steps` in each mode (device-busy ms, idle
   share, host operators and waits a step, each confirmed by a second
   trace of its mode); the graph's device-busy ms at most 1.1x the
   eager's. The kernel phase ends with
   `row_scatter_checks`: segscan with a device count against the run on
   the counted prefix (bitwise), the drop-mode row update and scatter of
   `csrc/row_scatter.cu` against their plain versions, in the forms and
   at the shapes of the float32 flagship (float32 rows; RowWiseAdaGrad
   on float32 at table 21's sorted list, the dense sweep's scatter at
   tables 20 and 11) and of bench's table 20 (bf16 rows; RowWiseAdaGrad
   on bf16 and AdaGrad on float32 at its cold tier, the scatter at its
   hot tier).
   "packed_path" (after it): the packed layouts and the drop mode: the
   bench-configured flagship with `rowwise_pack` (the 7 cold tiers and
   table 11's group [R, 129]) and the f32 flagship (cap 400,000) with
   AdaGrad and `packed_state` ([R, 256]), 3 steps each, a snapshot with
   `packed_<group>.npy` reloaded bitwise into a model from another seed and
   3 resumed losses within 1e-6 relative; then the bench-configured
   flagship with `unique_cap_factor=0.5, ucap_drop=True`, 3 steps, the rows
   dropped a step.
6. "ftrl_path": DLRM with FTRL at full width (`build_dlrm_ftrl`: 26
   tables capped at 400,000 rows, ev 128, hotness 1, batch 16,384) as one
   captured program (`step_mode` "graph"), 6 steps and a 20-batch eval,
   counters read around each: `onehot_fwd` once per step and per eval
   batch, `onehot_bwd` once per step, `segscan` and `ftrl_rows` 5 a step
   (one each per sorted group), the route map as planned, finite losses;
   learnable synthetic labels, and whether the loss falls. Then
   `graph_ab` ("ftrl_path_graph_ab"), as for paths 4 and 5.
7. "ftrl_dynamic_path": the same on exact dynamic tables (4,096 rows
   each, no hand-written kernel on this path), captured too: the key
   store's fill and the keys dropped after each step; then `graph_ab`
   ("ftrl_dynamic_path_graph_ab"), whose four turns from one state must
   leave the key store bitwise equal (`key_store_repeat_equal`).
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
   exchange's two branches (lists of 64 and of 2 rows; both run in each
   pass, the device-side flag selects) against one card,
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
   Over NCCL (a card per rank, as on a machine of four cards) each rank
   captures its whole step and eval forward, collectives inside, as on one
   card: "hybrid_path", "hybrid_bench_path", "hybrid_ftrl_dynamic_path",
   "hybrid_hier_path" and "hybrid_column_path" each require `step_mode`
   "graph" on every rank and end with a `graph_ab` over the ranks
   (`hybrid_graph_ab`: "<phase>_graph_ab", rank 0's record, and
   "<phase>_graph_ab_ranks": every rank's losses bitwise over the four
   turns, the storage groups' rule, replicas bitwise across the ranks after
   each turn, collectives a step equal in both modes, graph device-busy
   ms at most 1.1 x eager's, the replays free of host syncs; ms/step,
   idle share and NCCL device ms per rank and mode). On one card the ranks
   share it over gloo, whose collectives go through the host: the phases
   print "<phase>_graph_ab" with `captured` false and the reason, and
   require "eager: the gloo backend" on every rank.

10. The samples (`hugectr_tpu_torch/tools/samples.py`, the graphs of the
   JAX package's samples/*.py): "sample_kernels" holds each kernel against
   its plain version at the samples' widths and batch 2,048 (one-hot
   forward and backward on BST's category group at E 1, 11, 16, 18 and 32;
   segscan at the sorted-route K of WDL's wide table, DeepFM, DCN and DIN's
   item table, E 1 to 18), f32 and bf16, with times, bound and library
   call; Adam's row update (`adam_rows`) bitwise its plain version at the
   samples' Adam sorted groups and at its edges (E 1, 11, 16, 18; f32,
   bf16 table, bf16 state; counts 0 to K; zero summed gradients);
   Dropout's mask (`dropout_mask`) bitwise at the samples' layers; SGD's
   scatter into MMoE's table. "samples_parity": the tiny DeepFM (E 11,
   sorted route) and the tiny DIN (Dice, one-hot at E 18) on the card
   against the CPU from one state. "samples_path": each of the eleven
   graphs at its sample's own sizes as one captured program (`step_mode`
   "graph"), 6 steps and a 20-batch eval: ms/step, ex/s, peak memory,
   routes, launches a step (`adam_rows` once per Adam sorted group,
   `dropout_mask` once per Dropout layer), the step-1 and step-6 losses,
   the eval (both tasks' AUC for MMoE); then `graph_ab` on each graph.

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
   eager steps: `onehot_bwd` once a step (12 lookups), segscan's device
   count per group against the keys less the frozen slots (0 for table
   20), frozen rows and dense weights bitwise, each
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

14. The serving path and the rest of the module surface:
   "serving_path" (inside "snapshot_path", on its full-width static
   DLRM-FTRL and its snapshot): `graph_to_json`, the model rebuilt from the
   graph file with its snapshot loaded (`Model.construct_from_json`,
   `load_params_from_files`), `tools/predict.py::predict` over 4 eval
   batches of 16,384, bitwise against the trained model's own eval
   predictions (else the largest difference, within 1e-6 relative), the
   launches of the sweep (`onehot_fwd` once a batch); then
   `tools/hugectr2onnx.py::convert` of the snapshot without the tables,
   every float initializer of the ONNX file bitwise one of
   `dense_model.npz`'s arrays; ex/s, host seconds, the rebuild-and-load
   and conversion seconds, the file's bytes. "layers_parity" (after
   "weighted_parity"): the eleven layer types no sample uses, the MLP's
   ELU and GELU and both regularizers, card against CPU at batch 2,048
   (GRU at DIN's history widths: 10 steps of 36, 36 out; MatrixMultiply
   [2,048, 10, 36] x [2,048, 36, 10]; BatchNorm over 512 features), f32
   and bf16, forward and gradients; then 3 steps of a graph with GRU,
   BatchNorm and an L2 regularizer, card against CPU from one state.
   "cache_path" (after "sok_path"): a `UvmTable` over a 2,000,000 x 128
   host master with a 131,072-entry cache of 8 ways, 20 power-law batches
   of 16,384 x 20 keys: every row bitwise the master's, the hit rate a
   batch and ms a query; one `EmbeddingCache` sequence with repeated and
   colliding keys, the card's state bitwise the CPU's.

15. The entry points users start from (after "hybrid_snapshot"):
   "fullscale_path": `tools/fullscale_dryrun.py`'s entry function in a
   child process of its own (its memory comes back at exit), bench.py's
   settings at vocab_cap 40,000,000 (204,184,588 rows, 52,271,254,528
   bytes of bf16 tables), 6 steps and a 4-batch eval: the rows total, the
   tables' bytes against the plan's and the workspace calculator's, the
   state's against the calculator's, finite losses, `onehot_fwd` once a
   step and every kernel launched, the five 40 M-row cold tiers on the
   sorted route, peak memory; after step 1, 64 keys of table 0's cold tier
   at storage rows past 2^24 (elements past 2^31) that the step touched
   changed and 64 that it did not bitwise unchanged, and the pooled forward
   of a batch of only such keys equal to the sum of their rows copied to
   the host (scaled error <= 1e-2). "auc_scale_path":
   `tools/auc_scale_probe.py` at 5,242,880, 16,777,216 and 89,137,319
   samples, the binned AUC within 1e-4 of the exact one at each, each
   finalize's ms. "eval_profile": `tools/eval_profile.py` at bench.py's
   operating point over 20 cached eval batches. "sample_cli": `python -m
   hugectr_tpu_torch.samples.dlrm_dcnv2 --max_iter 4 --display 1
   --eval_interval 4` in a subprocess: rc 0, 4 finite losses, an AUC line.

16. The benchmark suite, the SKIP_* ablations and the last engine
   settings: the kernel phase ends with the grouped forward past 48
   lookups (`chunked_group_checks`: the 510-table case's one-hot group at
   49, 96 and 100 lookups, batch 2,048, f32 and bf16, weighted and not,
   ceil(n / 48) launches a call against one plain call; the 100-lookup
   cases timed beside the bound and one `embedding_bag`), the one-hot
   forward and backward at the scatter ratio's shapes (`scatter_ratio_checks`:
   V 131,072, h 100, batch 16,384, f32 and bf16, beside `embedding_bag`
   and `index_add_`) and the dense sweep's bf16 gradient buffer
   (`bf16_grad_checks`: `index_add_` into bf16 on the card against the
   ordered adds, within 2^-7 x sqrt(n) x sum |g|). "scatter_ratio_path"
   (after "bench_path"): the bench-configured flagship with
   `onehot_scatter_ratio=2000`, 3 steps: table 20's hot tier and table 14
   in the one-hot group, the grouped forward once a step, the backward
   once a one-hot lookup and step. "benchmarks_path": the suite's
   `dcnv2` case at the runner's defaults with no flag and under each of
   SKIP_EMBEDDING, SKIP_EMBEDDING_UPDATE, SKIP_BOTTOM_MLP and SKIP_TOP_MLP
   (5 warm-up and 20 timed steps each: ms/step and its difference from no
   flag, launches and the dense layers' forward calls, which must be 0 for
   a skipped stage), then the four synthetic cases at the JAX README's
   operating points (bf16 tables and state, rowwise AdaGrad; the 7-table
   case untiered and tiered), 2 warm-up and 5 timed steps each; the
   510-table case must hold a one-hot group of more than 48 lookups.

Then a "kernels" JSON line (per kernel: source, the TPU kernel it replaces,
main-path launches, error, ms, device_ms, plain_ms, bound_ms, bound_by,
library_ms, for the float32 flagship case with the most device time; for
`onehot_fwd`, the 13-table group; for segscan the counted form at table
21's sorted list (`counted_sorted_21`, the bench cold tier's beside it as
`counted_case`); beside them the file path's launches,
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
`weighted_path`, the ordered pool's on rank 0 of `hybrid_weighted_path`;
and each kernel's launches on `serving_path`, `fullscale_path`,
`scatter_ratio_path`, `benchmarks_path` and `packed_path` (the ordered
pool's also on `bench_path`, its compact cases of the cold and hot tiers
and its compact case on a packed table beside its others), the one-hot
kernels' f32 case at the scatter ratio's shapes (`ratio_case`) and the
forward's 100-lookup f32 case (`chunked_case`); and the two drop-mode
kernels of `csrc/row_scatter.cu`: `row_scatter` at the float32
flagship's table 20 (table 11 as `table11_case`, bench's hot tier as
`bench_case`), `adagrad_rows` RowWiseAdaGrad on float32 at its table 21
(bench's cold tier on bf16 as `bench_case`, AdaGrad on float32 as
`dcnv2_case`), with their launches on the main, bench, benchmarks,
full-scale and FTRL paths; and `ftrl_rows`, FTRL's row update, at the
FTRL path's table 21 (float32) with its launches there (`launches`),
its edges' bf16 case with the most device time (`bf16_case`) and its
launches on the main, freeze and serving paths; `row_scatter` also with
SGD's scatter into MMoE's table (`sgd_case`) and each sample graph's
launches; and the samples' kernels, `adam_rows` (Adam's row update, its
float32 sample case with the most device time, its bf16 edge case as
`bf16_case`) and `dropout_mask` (Dropout's mask at a sample layer), each
with its launches on `samples_path`, the eleven graphs' steps and evals
summed (`launches`) and by graph),
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
    shapes (one-hot forward: tables 3, 24 and 5; the one-hot backward: the
    groups; segscan: table 21's K), then the edge cases of the designs."""
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
            rec["seconds"] = time.perf_counter() - t0
            emit(rec)
            if not rec["scaled_err"] <= TOL[dname]:
                raise AssertionError(f"one-hot forward disagrees with its plain version: {rec}")
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
    onehot_bwd_group_checks(torch, np, oh, dev, results)
    onehot_bwd_edges(torch, np, rng, oh, dev)
    segscan_checks(torch, np, rng, ss, dev, results)
    bench_shape_checks(torch, np, oh, ss, dev, results)
    bench_shape_checks(torch, np, oh, ss, dev, results, world=hybrid_world(torch))
    ftrl_shape_checks(torch, np, oh, ss, dev, results)
    ordered_pool_checks(torch, np, dev, results)
    column_kernel_checks(torch, np, dev, results)
    weighted_kernel_checks(torch, np, dev, results)
    chunked_group_checks(torch, np, oh, dev, results)
    scatter_ratio_checks(torch, np, oh, dev, results)
    bf16_grad_checks(torch, np, dev)
    row_scatter_checks(torch, np, dev, results)


def row_scatter_checks(torch, np, dev, results):
    """The fixed-shape sparse update's kernels on the lists the two
    flagships give them, 16,384 power-law keys a lookup slot:

    * the float32 flagship (`main_path`, RowWiseAdaGrad on float32 tables
      and state): table 21's sorted list (K 442,368, every key valid, as
      its synthetic keys are), float32 gradient rows. segscan with the
      device count against the run on the gathered prefix, bitwise, at the
      list's count and at a count an eighth below it; then `adagrad_rows`
      on the tails against its plain version: the row mean of g^2 is
      summed in another order (a warp's tree against torch's reduction),
      so the accumulator agrees within 2^-15 of itself and the table
      within 2^-15 of its step plus two float32 roundings of its value.
      Then the dense sweep's drop-mode scatter, float32 rows into float32,
      on table 20's list (2,000,000 rows, h 100) and table 11's (405,282,
      h 8), against its plain version (atomic adds: the float32 tolerance
      of the scaled error), with one `index_add_` of the valid rows beside
      it;
    * bench.py's flagship (`bench_path`, bfloat16): the list of table 20's
      tiers (each tier's window over the raw keys, the rest the sentinel).
      On the cold tier's list, sorted: segscan with the device count n
      (about an eighth of the list) against the n-row prefix run,
      bitwise; `adagrad_rows` RowWiseAdaGrad on bf16 table and accumulator
      (within one bf16 rounding of the table's values), and AdaGrad on
      float32 (the optimizer of the suite's dcnv2 case on
      `benchmarks_path`: bitwise). The same for RowWiseAdaGrad on the
      shorter cold-tier lists of tables 21 and 0 (a count of about 60,500
      and 6,900 of K 442,368 and 49,152). On the hot tier's list the
      drop-mode scatter of bf16 rows into the float32 buffer;
    * the row update's edges at the samples' widths (`adagrad_rows_edges`);
    * DLRM-FTRL's table 21 and FTRL's row update (`ftrl_row_checks`)."""
    from hugectr_tpu_torch.core.types import Optimizer_t
    from hugectr_tpu_torch.ops import onehot_matmul as oh
    from hugectr_tpu_torch.tools.flagship import BENCH_PLAN, flagship_plan, raw_vocab

    rng = np.random.default_rng(21)
    f32_plan, bench_plan = flagship_plan(ev_size=E), flagship_plan(ev_size=E, **BENCH_PLAN)

    def key_list(plan, name):
        g = next(x for x in plan.groups if x.name == name)
        lm = g.lookups[0]
        rows = int(g.total_local_rows)
        raw = torch.as_tensor(power_law(rng, raw_vocab(plan, lm), (B, lm.hotness)), device=dev)
        wk = oh.window_keys(raw, lm.key_lo, lm.key_hi).reshape(-1).long()
        src = torch.arange(B, device=dev).repeat_interleave(lm.hotness)
        return torch.where(wk >= 0, wk, rows), rows, src

    def grads(dt):
        return torch.as_tensor(rng.standard_normal((B, E), dtype=np.float32), device=dev).to(dt)

    # the float32 flagship
    idx, rows, src = key_list(f32_plan, "mp_ev128_21")
    dsrc = grads(torch.float32)
    k = idx.numel()
    sorted_list = counted_segscan_case(torch, dev, results, "counted_sorted_21", idx, rows, src, dsrc, cut=k // 8)
    adagrad_rows_case(torch, dev, results, "sorted_21_rowwise_adagrad", Optimizer_t.RowWiseAdaGrad,
                      torch.float32, rows, *sorted_list)
    for name, case in (("mp_ev128_20", "dense_20_f32"), ("mp_ev128_11", "dense_11_f32")):
        idx, rows, src = key_list(f32_plan, name)
        scatter_rows_case(torch, dev, results, case, idx, rows, src, dsrc)
    # bench.py's flagship
    idx, rows, src = key_list(bench_plan, "mp_ev128_20::cold")
    dsrc = grads(torch.bfloat16)
    sorted_list = counted_segscan_case(torch, dev, results, "counted_cold_tier_20", idx, rows, src, dsrc)
    for case, kind, dt in (("cold_tier_20_rowwise_adagrad", Optimizer_t.RowWiseAdaGrad, torch.bfloat16),
                           ("cold_tier_20_adagrad", Optimizer_t.AdaGrad, torch.float32)):
        adagrad_rows_case(torch, dev, results, case, kind, dt, rows, *sorted_list)
    idx, rows, src = key_list(bench_plan, "mp_ev128_20::hot")
    scatter_rows_case(torch, dev, results, "dense_hot_20", idx, rows, src, dsrc)
    # two of the step's shorter cold-tier lists: counts of about 60,500 and 6,900
    for table in (21, 0):
        idx, rows, src = key_list(bench_plan, f"mp_ev128_{table}::cold")
        sorted_list = counted_segscan_case(torch, dev, results, f"counted_cold_tier_{table}", idx, rows, src, dsrc)
        adagrad_rows_case(torch, dev, results, f"cold_tier_{table}_rowwise_adagrad", Optimizer_t.RowWiseAdaGrad,
                          torch.bfloat16, rows, *sorted_list)
    adagrad_rows_edges(torch, np, dev, results)
    ftrl_row_checks(torch, np, dev, results)


def ftrl_row_checks(torch, np, dev, results):
    """DLRM-FTRL's sorted groups (`ftrl_path`, FTRL on float32 tables and
    state): table 21's list (K 16,384 power-law keys of its 400,000 rows,
    every key valid, as the synthetic keys are), float32 gradient rows; the
    counted segscan as `row_scatter_checks` runs it and `ftrl_rows` against
    its plain version (`ftrl_rows_case`), then its edges
    (`ftrl_rows_edges`)."""
    from hugectr_tpu_torch.tools.flagship import ftrl_plan

    g = next(x for x in ftrl_plan(ev_size=E, vocab_cap=FTRL_ROWS).groups if x.name == "mp_ev128_21")
    rows = int(g.total_local_rows)
    rng = np.random.default_rng(23)
    idx = torch.as_tensor(power_law(rng, rows, B), device=dev)
    src = torch.arange(B, device=dev)
    dsrc = torch.as_tensor(rng.standard_normal((B, E), dtype=np.float32), device=dev)
    sorted_list = counted_segscan_case(torch, dev, results, "counted_ftrl_21", idx, rows, src, dsrc)
    ftrl_rows_case(torch, dev, results, "ftrl_21", rows, *sorted_list)
    ftrl_rows_edges(torch, np, dev, results)


def counted_segscan_case(torch, dev, results, case, idx, rows, src, dsrc, cut: int = 0):
    """segscan on the stably sorted list `idx` (the sentinel `rows` last)
    with the device count of its valid prefix and the rows read through the
    sort (`rowsrc`), as `sparse_optimizer._sorted_rows` calls it: against
    the run on the gathered prefix (bitwise) and its plain version; with
    `cut` > 0 also at a count `cut` rows lower (bitwise its prefix run).
    Returns (sorted ids, the sums, the count, n, unique rows) for the row
    update."""
    from hugectr_tpu_torch.ops import segscan as ss
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms

    t0 = time.perf_counter()
    k = idx.numel()
    sidx, perm = torch.sort(idx, stable=True)
    count = torch.count_nonzero(sidx < rows)
    n = int(count)
    heads = torch.ones(k, dtype=torch.bool, device=dev)
    heads[1:] = sidx[1:] != sidx[:-1]
    rowsrc = src[perm].contiguous()

    def prefix_run(m):
        return ss.segmented_sum_sorted(dsrc[rowsrc[:m]].contiguous(), heads[:m].contiguous(), torch.float32)

    call = lambda: ss.segmented_sum_sorted(dsrc, heads, torch.float32, count, rowsrc)  # noqa: E731
    got = call()
    want = ss.segmented_sum_sorted_plain(dsrc, heads, torch.float32, count, rowsrc)
    scale = ss.segmented_sum_sorted_plain(dsrc.float().abs(), heads, torch.float32, count, rowsrc)
    cut_bitwise = None
    if cut:
        m = n - cut
        cut_got = ss.segmented_sum_sorted(dsrc, heads, torch.float32, torch.tensor(m, device=dev), rowsrc)
        cut_bitwise = bool(torch.equal(cut_got[:m], prefix_run(m)))
    torch.cuda.synchronize()
    isz = dsrc.element_size()
    b_ms, b_by = bound(n * (E * isz + 8 + 1 + E * 4) + k, n * E)
    dms, per_call = device_ms(call, KERNEL_NAMES["segscan"])
    rec = dict(
        kernel="segscan", case=case, dtype=str(dsrc.dtype).split(".")[1], out_dtype="float32", K=k, count=n, E=E,
        prefix_bitwise=bool(torch.equal(got[:n], prefix_run(n))), cut=cut, cut_prefix_bitwise=cut_bitwise,
        scaled_err=scaled_err(got[:n], want[:n], scale[:n]), max_abs_err=float((got[:n] - want[:n]).abs().max()),
        tol=TOL["float32"], bitwise_repeat=bool(torch.equal(call()[:n], got[:n])), ms=time_ms(call), device_ms=dms,
        device_launches_per_call=per_call, prefix_ms=time_ms(lambda: prefix_run(n)),
        plain_ms=time_ms(lambda: ss.segmented_sum_sorted_plain(dsrc, heads, torch.float32, count, rowsrc),
                         samples=3, inner=1, warmup=1),
        library_ms=None, library="none: no single PyTorch call computes a segmented scan",
        bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0,
    )
    results.append(rec)
    emit(rec)
    if not (rec["prefix_bitwise"] and cut_bitwise in (None, True) and rec["scaled_err"] <= TOL["float32"]
            and rec["bitwise_repeat"]):
        raise AssertionError(f"counted segscan disagrees with the prefix run or its plain version: {rec}")
    return sidx, got, count, n, int(heads[:n].sum())


def adagrad_rows_case(torch, dev, results, case, kind, dt, rows, sidx, got, count, n, u):
    """The drop-mode row update of a sorted list's tails (`adagrad_rows`)
    against its plain version, on a random [rows, E] table of `dt` and its
    accumulator of `dt`: AdaGrad bitwise; RowWiseAdaGrad within the spread
    of its row mean's sum order (float32: two orders of E = 128 positive
    terms differ by at most 2 x 127 x 2^-24 of the sum, so 2^-15 of the
    accumulator, and 2^-15 of the table's step plus two roundings of its
    value; bfloat16: one rounding at the table's and the accumulator's
    scale)."""
    from hugectr_tpu_torch.core.types import Optimizer_t
    from hugectr_tpu_torch.ops import row_scatter as rs
    from hugectr_tpu_torch.optim.params import OptParams
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms

    t0 = time.perf_counter()
    k = sidx.numel()
    opt = OptParams(optimizer=kind, initial_accu_value=0.0)
    width = 1 if kind == Optimizer_t.RowWiseAdaGrad else E
    table = (torch.randn((rows, E), device=dev) * 0.01).to(dt)
    accum = (torch.rand((rows, width), device=dev) * 1e-3).to(dt)
    lr = torch.tensor(0.005, device=dev).to(dt)
    t1, a1, t2, a2 = table.clone(), accum.clone(), table.clone(), accum.clone()
    t3, a3 = table.clone(), accum.clone()
    rs.adagrad_rows(opt, t1, a1, sidx, got, count, lr)
    rs.adagrad_rows(opt, t3, a3, sidx, got, count, lr)
    rs.adagrad_rows_plain(opt, t2, a2, sidx, got, count, lr)
    torch.cuda.synchronize()
    ok_t, ok_a, bitwise, d_t, d_a = row_update_agrees(torch, kind, dt, table, t1, a1, t2, a2)
    repeat = bool(torch.equal(t1, t3) and torch.equal(a1, a3))
    changed = int((t1 != table).any(dim=1).sum())
    call = lambda: rs.adagrad_rows(opt, t1, a1, sidx, got, count, lr)  # noqa: E731
    isz = table.element_size()
    b_ms, b_by = bound(n * 8 + u * (2 * E * isz + E * 4 + 2 * width * isz), 6 * u * E)
    dms, per_call = device_ms(call, KERNEL_NAMES["adagrad_rows"])
    rec = dict(
        kernel="adagrad_rows", case=case, optimizer=kind.value, dtype=str(dt).split(".")[1], K=k, count=n,
        unique_rows=u, rows=rows, E=E, max_abs_err=float(d_t.max()), accum_max_abs_err=float(d_a.max()),
        table_within=ok_t, accum_within=ok_a, bitwise=bitwise, bitwise_repeat=repeat,
        rows_changed=changed, ms=time_ms(call), device_ms=dms, device_launches_per_call=per_call,
        plain_ms=time_ms(lambda: rs.adagrad_rows_plain(opt, t2, a2, sidx, got, count, lr),
                         samples=5, inner=1, warmup=1),
        library_ms=None, library="none: no single PyTorch call computes a row-wise optimizer update",
        bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0,
    )
    results.append(rec)
    emit(rec)
    if not (ok_t and ok_a and repeat and 0 < changed <= u):
        raise AssertionError(f"the drop-mode row update disagrees with its plain version: {rec}")


def row_update_agrees(torch, kind, dt, table, t1, a1, t2, a2):
    """(table within, accumulator within, bitwise, |table diff|, |accum
    diff|) of the row update's result t1, a1 against its plain version's
    t2, a2 from `table`, under the tolerance of `adagrad_rows_case`."""
    from hugectr_tpu_torch.core.types import Optimizer_t

    d_t = (t1.float() - t2.float()).abs()
    d_a = (a1.float() - a2.float()).abs()
    bitwise = bool(torch.equal(t1, t2) and torch.equal(a1, a2))
    if kind == Optimizer_t.AdaGrad:
        return bitwise, bitwise, bitwise, d_t, d_a
    if dt == torch.float32:
        ok_t = bool((d_t <= 2.0**-15 * (t2 - table).abs() + 2.0**-22 * t2.abs()).all())
        ok_a = bool((d_a <= 2.0**-15 * a2.abs()).all())
    else:
        ok_t = float(d_t.max()) <= 2.0**-7 * float(t2.float().abs().max())
        ok_a = float(d_a.max()) <= 2.0**-7 * float(a2.float().abs().max())
    return ok_t, ok_a, bitwise, d_t, d_a


def adagrad_rows_edges(torch, np, dev, results):
    """The row update at its design's edges against its plain version, at
    the samples' batch 2,048 and their widths E 11 (DeepFM's sorted list, K
    53,248) and E 18 (DIN's items, K 22,528), which take the general kernel:
    uniform row ids of a 100,000-row table, sorted, a negative id first
    and the last eighth the padding (the sentinel, `rows`), with runs made
    to cross the 32-id tiles' edges (positions 28-36, 60-70 and 220-230
    each hold one id). Counts 0, 7 x 32 (a tile's end, inside the run over
    220-230: entry 223 is no tail), 7 x 32 + 1 and the valid prefix.
    AdaGrad on float32 with a float32 lr bitwise, RowWiseAdaGrad on
    bfloat16 with a bfloat16 lr within one rounding (the tolerance of
    `adagrad_rows_case`), and two runs bitwise; at the valid prefix the
    device ms by the profiler beside the bound, CUDA events ms and the
    plain version's."""
    from hugectr_tpu_torch.core.types import Optimizer_t
    from hugectr_tpu_torch.ops import row_scatter as rs
    from hugectr_tpu_torch.optim.params import OptParams
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms

    rng = np.random.default_rng(2048)
    rows = 100_000
    for e, k in ((11, 53_248), (18, 22_528)):
        valid = k - k // 8
        ids = np.sort(rng.integers(0, rows, size=valid))
        ids[0] = -1
        for lo, hi in ((28, 37), (60, 71), (220, 231)):
            ids[lo:hi] = ids[lo]
        # the tails: every run's end (the last valid entry's too) but the negative id's
        tails = int((ids[:-1] != ids[1:]).sum())
        sidx = torch.as_tensor(np.concatenate([ids, np.full(k // 8, rows)]), device=dev)
        g = torch.as_tensor(rng.standard_normal((k, e), dtype=np.float32), device=dev)
        for kind, dt in ((Optimizer_t.AdaGrad, torch.float32), (Optimizer_t.RowWiseAdaGrad, torch.bfloat16)):
            t0 = time.perf_counter()
            opt = OptParams(optimizer=kind, initial_accu_value=0.0)
            width = 1 if kind == Optimizer_t.RowWiseAdaGrad else e
            table = (torch.randn((rows, e), device=dev) * 0.01).to(dt)
            accum = (torch.rand((rows, width), device=dev) * 1e-3).to(dt)
            lr = torch.tensor(0.005, device=dev).to(dt)
            checks = []
            for n in (0, 224, 225, valid):
                count = torch.tensor(n, device=dev)
                t1, a1, t2, a2, t3, a3 = (x.clone() for x in (table, accum) * 3)
                rs.adagrad_rows(opt, t1, a1, sidx, g, count, lr)
                rs.adagrad_rows(opt, t3, a3, sidx, g, count, lr)
                rs.adagrad_rows_plain(opt, t2, a2, sidx, g, count, lr)
                ok_t, ok_a, bitwise, d_t, _d_a = row_update_agrees(torch, kind, dt, table, t1, a1, t2, a2)
                checks.append(dict(count=n, table_within=ok_t, accum_within=ok_a, bitwise=bitwise,
                                   max_abs_err=float(d_t.max()),
                                   bitwise_repeat=bool(torch.equal(t1, t3) and torch.equal(a1, a3)),
                                   rows_changed=int((t1 != table).any(dim=1).sum())))
            torch.cuda.synchronize()
            isz = table.element_size()
            b_ms, b_by = bound(valid * 8 + tails * (2 * e * isz + e * 4 + 2 * width * isz), 6 * tails * e)
            call = lambda: rs.adagrad_rows(opt, t1, a1, sidx, g, count, lr)  # noqa: E731
            dms, per_call = device_ms(call, KERNEL_NAMES["adagrad_rows"])
            rec = dict(kernel="adagrad_rows", case=f"edges_E{e}_{kind.value}", optimizer=kind.value,
                       dtype=str(dt).split(".")[1], K=k, E=e, rows=rows, count=valid, unique_rows=tails,
                       checks=checks, ms=time_ms(call), device_ms=dms, device_launches_per_call=per_call,
                       plain_ms=time_ms(lambda: rs.adagrad_rows_plain(opt, t2, a2, sidx, g, count, lr),
                                        samples=5, inner=1, warmup=1),
                       bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms,
                       ok=all(c["table_within"] and c["accum_within"] and c["bitwise_repeat"]
                              and bool(c["rows_changed"]) == bool(c["count"]) for c in checks),
                       seconds=time.perf_counter() - t0)
            results.append(rec)
            emit(rec)
            if not rec["ok"]:
                raise AssertionError(f"the row update disagrees with its plain version at its edges: {rec}")


# DLRM-FTRL's optimizer (samples/dlrm_ftrl.py:38-44: beta 0, lambda1 = lambda2 = 0.01),
# `build_dlrm_ftrl`'s lr and its tables' cap (samples/dlrm_ftrl.py:36)
FTRL_OPT = dict(lambda1=0.01, lambda2=0.01, ftrl_beta=0.0)
FTRL_LR = 0.001
FTRL_ROWS = 400_000


def ftrl_state(torch, rows, tdt, sdt, dev):
    """A [rows, E] table of `tdt` near FTRL's lambda1 edge and its state z,
    n of `sdt`, as a few steps leave them."""
    return ((torch.randn((rows, E), device=dev) * 0.02).to(tdt), (torch.randn((rows, E), device=dev) * 0.02).to(sdt),
            (torch.rand((rows, E), device=dev) * 0.1).to(sdt))


def ftrl_bound(n, u, e, tdt, sdt):
    """FTRL's row update: the ids up to the count, then a tail's float32
    gradient row once and its table and state rows read and written
    (`csrc/row_scatter.cu`), about 16 float32 operations an element."""
    return bound(n * 8 + u * e * (4 + 2 * tdt.itemsize + 4 * sdt.itemsize), 16 * u * e)


def rows_changed(new, old) -> int:
    """The rows where any of the arrays `new` differs from `old`."""
    return int(sum((x != y).any(dim=1).int() for x, y in zip(new, old)).bool().sum())


def ftrl_rows_case(torch, dev, results, case, rows, sidx, got, count, n, u):
    """FTRL's drop-mode row update of a sorted list's tails (`ftrl_rows`)
    against its plain version on a float32 [rows, E] table and float32
    state, at the sample's constants and lr: bitwise (the kernel's
    arithmetic is torch's op by op), two runs bitwise."""
    from hugectr_tpu_torch.core.types import Optimizer_t
    from hugectr_tpu_torch.ops import row_scatter as rs
    from hugectr_tpu_torch.optim.params import OptParams
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms

    t0 = time.perf_counter()
    k = sidx.numel()
    opt = OptParams(optimizer=Optimizer_t.FTRL, **FTRL_OPT)
    state = ftrl_state(torch, rows, torch.float32, torch.float32, dev)
    lr = torch.tensor(FTRL_LR, device=dev)
    a, b, c = ([x.clone() for x in state] for _ in range(3))
    rs.ftrl_rows(opt, *a, sidx, got, count, lr)
    rs.ftrl_rows(opt, *c, sidx, got, count, lr)
    rs.ftrl_rows_plain(opt, *b, sidx, got, count, lr)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(x, y) for x, y in zip(a, b))
    repeat = all(torch.equal(x, y) for x, y in zip(a, c))
    err = max(max_abs_diff(torch, x, y) for x, y in zip(a, b))
    changed = rows_changed(a, state)
    call = lambda: rs.ftrl_rows(opt, *a, sidx, got, count, lr)  # noqa: E731
    b_ms, b_by = ftrl_bound(n, u, E, torch.float32, torch.float32)
    dms, per_call = device_ms(call, KERNEL_NAMES["ftrl_rows"])
    rec = dict(
        kernel="ftrl_rows", case=case, optimizer="ftrl", dtype="float32", state_dtype="float32", K=k, count=n,
        unique_rows=u, rows=rows, E=E, max_abs_err=err, bitwise=bitwise, bitwise_repeat=repeat,
        rows_changed=changed, ms=time_ms(call), device_ms=dms, device_launches_per_call=per_call,
        plain_ms=time_ms(lambda: rs.ftrl_rows_plain(opt, *b, sidx, got, count, lr), samples=5, inner=1, warmup=1),
        library_ms=None, library="none: no single PyTorch call computes a row-wise optimizer update",
        bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0,
    )
    results.append(rec)
    emit(rec)
    if not (bitwise and repeat and changed == u):
        raise AssertionError(f"FTRL's row update disagrees with its plain version: {rec}")


def ftrl_rows_edges(torch, np, dev, results):
    """FTRL's row update at its edges against its plain version, at the
    FTRL path's list length (K 16,384) into a 400,000-row table: sorted
    power-law ids with a negative id first, one row repeated over
    positions 28-300 (across the 32-id tiles' edges), 64 ids at or past R
    inside the count, then the padding (the sentinel); counts 0, the ids
    below R, those and the 64 past R, and K; a float32 table and state, a
    bfloat16 table with float32 state, bfloat16 state, each with an lr of
    the table's type. Bitwise its plain version in every case, two runs
    bitwise; the device ms at count K beside the bound, CUDA events ms and
    the plain version's."""
    from hugectr_tpu_torch.core.types import Optimizer_t
    from hugectr_tpu_torch.ops import row_scatter as rs
    from hugectr_tpu_torch.optim.params import OptParams
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms

    rng = np.random.default_rng(22)
    rows, k, past, pad = FTRL_ROWS, B, 64, 1024
    ids = np.sort(power_law(rng, rows, k - past - pad))
    ids[0] = -1
    ids[28:301] = ids[28]
    valid = k - past - pad
    sidx = torch.as_tensor(np.concatenate([ids, rows + np.arange(past), np.full(pad, rows + past)]), device=dev)
    tails = int((ids[1:-1] != ids[2:]).sum()) + 1  # every run's end but the negative id's
    g = torch.as_tensor(rng.standard_normal((k, E), dtype=np.float32), device=dev)
    opt = OptParams(optimizer=Optimizer_t.FTRL, **FTRL_OPT)
    for tdt, sdt in ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                     (torch.bfloat16, torch.bfloat16)):
        t0 = time.perf_counter()
        state = ftrl_state(torch, rows, tdt, sdt, dev)
        lr = torch.tensor(FTRL_LR, device=dev).to(tdt)
        checks = []
        for n in (0, valid, valid + past, k):
            count = torch.tensor(n, device=dev)
            a, b, c = ([x.clone() for x in state] for _ in range(3))
            rs.ftrl_rows(opt, *a, sidx, g, count, lr)
            rs.ftrl_rows(opt, *c, sidx, g, count, lr)
            rs.ftrl_rows_plain(opt, *b, sidx, g, count, lr)
            checks.append(dict(count=n, bitwise=all(torch.equal(x, y) for x, y in zip(a, b)),
                               bitwise_repeat=all(torch.equal(x, y) for x, y in zip(a, c)),
                               max_abs_err=max(max_abs_diff(torch, x, y) for x, y in zip(a, b)),
                               rows_changed=rows_changed(a, state)))
        torch.cuda.synchronize()
        b_ms, b_by = ftrl_bound(k, tails, E, tdt, sdt)
        call = lambda: rs.ftrl_rows(opt, *a, sidx, g, count, lr)  # noqa: E731
        dms, per_call = device_ms(call, KERNEL_NAMES["ftrl_rows"])
        rec = dict(kernel="ftrl_rows", case=f"edges_{str(tdt).split('.')[1]}_{str(sdt).split('.')[1]}",
                   optimizer="ftrl", dtype=str(tdt).split(".")[1], state_dtype=str(sdt).split(".")[1], K=k, E=E,
                   rows=rows, count=k, unique_rows=tails, checks=checks,
                   max_abs_err=max(c["max_abs_err"] for c in checks), ms=time_ms(call), device_ms=dms,
                   device_launches_per_call=per_call,
                   plain_ms=time_ms(lambda: rs.ftrl_rows_plain(opt, *b, sidx, g, count, lr), samples=3, inner=1,
                                    warmup=1),
                   library_ms=None, library="none: no single PyTorch call computes a row-wise optimizer update",
                   bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms,
                   ok=all(c["bitwise"] and c["bitwise_repeat"]
                          and c["rows_changed"] == (0 if c["count"] == 0 else tails) for c in checks),
                   seconds=time.perf_counter() - t0)
        results.append(rec)
        emit(rec)
        if not rec["ok"]:
            raise AssertionError(f"FTRL's row update disagrees with its plain version at its edges: {rec}")


def scatter_rows_case(torch, dev, results, case, idx, rows, src, dsrc):
    """The dense sweep's drop-mode scatter of the rows dsrc[src] into a
    float32 [rows, E] buffer against its plain version (atomic adds: the
    float32 tolerance of the scaled error), one `index_add_` of the valid
    rows (taken out beforehand) beside it."""
    from hugectr_tpu_torch.ops import row_scatter as rs
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms

    t0 = time.perf_counter()
    k = idx.numel()
    valid = idx < rows
    n = int(valid.sum())
    call = lambda: rs.scatter_add_rows(idx, src, dsrc, rows, torch.float32)  # noqa: E731
    got = call()
    want = rs.scatter_add_rows_plain(idx, src, dsrc, rows, torch.float32)
    scale = rs.scatter_add_rows_plain(idx, src, dsrc.float().abs(), rows, torch.float32)
    vidx, vals = idx[valid], dsrc[src[valid]].float()
    buf = torch.zeros((rows, E), device=dev)
    torch.cuda.synchronize()
    b_ms, b_by = bound(k * 16 + n * E * dsrc.element_size() + rows * E * 4, n * E)
    dms, per_call = device_ms(call, KERNEL_NAMES["row_scatter"])
    rec = dict(
        kernel="row_scatter", case=case, dtype=str(dsrc.dtype).split(".")[1], out_dtype="float32", K=k, valid=n,
        rows=rows, E=E, scaled_err=scaled_err(got, want, scale), max_abs_err=float((got - want).abs().max()),
        tol=TOL["float32"], ms=time_ms(call), device_ms=dms, device_launches_per_call=per_call,
        plain_ms=time_ms(lambda: rs.scatter_add_rows_plain(idx, src, dsrc, rows, torch.float32),
                         samples=5, inner=1, warmup=1),
        library_ms=time_ms(lambda: buf.index_add_(0, vidx, vals)),
        library="torch.Tensor.index_add_ of the valid rows (taken out beforehand)",
        bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0,
    )
    results.append(rec)
    emit(rec)
    if not rec["scaled_err"] <= TOL["float32"]:
        raise AssertionError(f"the drop-mode scatter disagrees with its plain version: {rec}")


def ftrl_shape_checks(torch, np, oh, ss, dev, results):
    """The shapes the DLRM-FTRL path gives the kernels (`ftrl_plan()`,
    hotness 1, float32): the grouped forward of its 13-table one-hot group
    beside one embedding_bag call, its grouped backward (h 1) beside one
    index_add_, and segscan at K 16,384 (the sorted keys of a 400,000-row
    table, one key per sample)."""
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
    d = torch.as_tensor(rng.standard_normal((B, width), dtype=np.float32), device=dev)
    bwd_group_case(torch, oh, dev, results, f"ftrl_group{len(lookups)}", keys, lookups, d, table.shape[0], E)
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
        plain_ms=time_ms(lambda: ss.segmented_sum_sorted_plain(vals, heads), samples=5, inner=1, warmup=1),
        library_ms=None, library="none: no single PyTorch call computes a segmented scan",
        bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0,
    )
    results.append(rec)
    emit(rec)
    if not (rec["scaled_err"] <= TOL["float32"] and rec["bitwise_repeat"]):
        raise AssertionError(f"DLRM-FTRL segscan disagrees with its plain version: {rec}")


def bench_shape_checks(torch, np, oh, ss, dev, results, world: int = 1):
    """The shapes only bench.py's configuration gives the kernels: table
    20's superhot backward alone through the per-table entry (V 1,024 of
    the split table's first rows, h 100, power-law keys through the window
    [0, 1024), d in bf16 as the step gives it, float32 sums; the bench
    group's single launch is in `onehot_bwd_group_checks`) and the bf16
    segscan of table 20's cold tier (the valid keys of [131072, 2M) of
    16,384 x 100 power-law keys: bf16 rows, float32 sums). With `world` W >
    1, the shapes of one of W ranks (case names end in `_w{W}`): the
    20-lookup group forward and backward on B/W rows, and the cold tier's
    segscan over the keys rank 0's shard owns among the 16,384 x 100
    gathered ones."""
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms
    from hugectr_tpu_torch.tools.flagship import BENCH_PLAN, flagship_plan, onehot_group_inputs, raw_vocab

    plan = flagship_plan(ev_size=E, num_shards=world, **BENCH_PLAN)
    g = plan.groups[0]
    rng = np.random.default_rng(13 + world)
    b = B // world
    sfx = f"_w{world}" if world > 1 else ""
    if world > 1:
        bench_group_check(torch, np, oh, dev, results, plan, b, sfx)
        keys, lookups, table, width = onehot_group_inputs(rng, b, E, torch.bfloat16, dev, plan=plan)
        d = torch.as_tensor(rng.standard_normal((b, width), dtype=np.float32), device=dev).to(torch.bfloat16)
        bwd_group_case(torch, oh, dev, results, f"group{len(lookups)}{sfx}", keys, lookups, d, table.shape[0], E)
    else:  # table 20's superhot tier alone, through the per-table entry
        lm = next(x for x in g.lookups if x.windowed and g.tables[x.table_index].name.startswith("20::"))
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
            kernel="onehot_bwd", case=f"superhot_{g.tables[lm.table_index].name}", dtype="bfloat16",
            B=b, V=v, h=h, E=E, keys=nkeys, route=oh.bwd_route(b, h, v, E, dev),
            scaled_err=scaled_err(grad, want_g, scale_g),
            max_abs_err=float((grad - want_g).abs().max()), counts_exact=bool(torch.equal(cnt, want_c)),
            bitwise_repeat=bool(torch.equal(bits(torch, call()[0]), bits(torch, grad))),
            tol=TOL["float32"], ms=time_ms(call), device_ms=dms, device_launches_per_call=per_call,
            plain_ms=time_ms(lambda: oh.onehot_matmul_bwd_plain(keys, d, v, torch.float32)),
            library_ms=time_ms(library), library_device_ms=device_ms(library, KERNEL_NAMES["index_add_"])[0],
            library="Tensor.index_add_ over the valid keys (grad only)",
            bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0,
        )
        results.append(rec)
        emit(rec)
        # float32 sums of bf16 values: the float32 tolerance
        if not (rec["scaled_err"] <= TOL["float32"] and rec["counts_exact"]
                and (rec["bitwise_repeat"] or rec["route"] != "mma")):
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
        device_launches_per_call=per_call, plain_ms=time_ms(lambda: ss.segmented_sum_sorted_plain(vals, heads, torch.float32), samples=5, inner=1, warmup=1),
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


def bwd_pairs(torch, oh, keys, lookups, d, e, weights=None):
    """(group rows, float32 cotangent rows) of every non-padding key of a
    backward group: the pairs one `index_add_` over the group storage adds
    (Mean divisions and weights applied as the plain version applies
    them)."""
    rows, src = [], []
    for i, (k, lk) in enumerate(zip(keys, lookups)):
        valid, local = oh.place_keys(oh.window_keys(k, lk.key_lo, lk.key_hi), lk.vocab)
        dd = d[:, lk.out_begin : lk.out_begin + e]
        w = weights[i] if weights is not None else None
        if lk.mean:
            den = (torch.clamp(valid.to(d.dtype).sum(dim=1, keepdim=True), min=1.0) if w is None else
                   torch.where(valid, w, 0.0).to(d.dtype).float().sum(dim=1, keepdim=True).to(d.dtype))
            dd = dd / torch.where(den == 0, torch.ones((), dtype=d.dtype, device=d.device), den)
        x = dd.float().unsqueeze(1).expand(-1, k.shape[1], -1)
        if w is not None:
            x = x * w.unsqueeze(-1)
        rows.append((local + lk.row_off)[valid])
        src.append(x[valid])
    return torch.cat(rows), torch.cat(src)


def bwd_group_case(torch, oh, dev, results, case, keys, lookups, d, rows, e, weights=None, tol=None,
                   route=None, **extra):
    """One grouped one-hot backward launch against its plain version: the
    gradient within `tol` (default the float32 one, in either type of d) of
    the float32 sums' scale (plain version on |d| and |w|), the touch counts exact (weighted: the touched rows exact and
    the counts within the float32 tolerance), one launch a call, two calls
    bitwise equal where every lookup takes the counts matmul; CUDA-event ms,
    profiler device ms, the plain version's ms, one `index_add_` of every
    (row, cotangent) pair of the group, and the bound: each key read once, d
    read once a lookup, the float32 gradient and counts written once, one
    add a key and column. Returns the record; raises on disagreement."""
    from hugectr_tpu_torch import ops
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms

    t0 = time.perf_counter()
    dname = str(d.dtype).split(".")[1]
    tol = TOL["float32"] if tol is None else tol  # float32 sums of values exact in d's type
    b = d.shape[0]
    call = lambda: oh.onehot_bwd_chunked(keys, lookups, d, rows, e, weights) if route is None else \
        oh.onehot_bwd_group(keys, lookups, d, rows, e, weights, route=route)  # noqa: E731
    before = ops.launch_counts()["onehot_bwd"]
    grad, cnt = call()
    launches = ops.launch_counts()["onehot_bwd"] - before
    want_g, want_c = oh.onehot_bwd_group_plain(keys, lookups, d, rows, e, weights)
    scale_g, _ = oh.onehot_bwd_group_plain(keys, lookups, d.float().abs(), rows, e,
                                           None if weights is None else [None if w is None else w.abs()
                                                                         for w in weights])
    torch.cuda.synchronize()
    routes = [route or oh.bwd_route(b, k.shape[1], lk.vocab, e, dev, weights is not None and weights[i] is not None)
              for i, (k, lk) in enumerate(zip(keys, lookups))]
    weighted = weights is not None and any(w is not None for w in weights)
    if weighted:
        cnt_ok = bool(torch.equal(cnt > 0, want_c > 0)) and \
            float(((cnt - want_c).abs() / want_c.clamp(min=1e-30)).max()) <= TOL["float32"]
    else:
        cnt_ok = bool(torch.equal(cnt, want_c))
    repeat = None
    spans = sorted((lk.row_off, lk.row_off + lk.vocab) for lk in lookups)
    disjoint = all(a[1] <= b_[0] for a, b_ in zip(spans, spans[1:]))
    if set(routes) == {"mma"} and disjoint:  # lookups on the same rows add in either order
        g2, c2 = call()
        repeat = bool(torch.equal(bits(torch, g2), bits(torch, grad)) and torch.equal(c2, cnt))
    flat, src = bwd_pairs(torch, oh, keys, lookups, d, e, weights)
    nkeys = int(flat.numel())
    lib = lambda: torch.zeros((rows, e), device=dev).index_add_(0, flat, src)  # noqa: E731
    nbytes = (sum(k.numel() * k.element_size() for k in keys) + len(keys) * b * e * d.element_size()
              + rows * e * 4 + rows * 4 + sum(w.numel() * 4 for w in (weights or ()) if w is not None))
    b_ms, b_by = bound(nbytes, nkeys * e)
    dms, per_call = device_ms(call, KERNEL_NAMES["onehot_bwd"])
    rec = dict(
        kernel="onehot_bwd", case=case, dtype=dname, B=b, lookups=len(lookups), E=e, rows=rows, keys=nkeys,
        routes=routes, weighted=weighted, scaled_err=scaled_err(grad, want_g, scale_g),
        max_abs_err=float((grad - want_g).abs().max()), counts_exact=cnt_ok, bitwise_repeat=repeat, tol=tol,
        launches_per_call=launches, ms=time_ms(call), device_ms=dms, device_launches_per_call=per_call,
        plain_ms=time_ms(lambda: oh.onehot_bwd_group_plain(keys, lookups, d, rows, e, weights), samples=5, inner=1),
        library_ms=time_ms(lib), library_device_ms=device_ms(lib, KERNEL_NAMES["index_add_"])[0],
        library="one Tensor.index_add_ of every (row, cotangent) pair of the group (grad only)",
        bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0, **extra,
    )
    results.append(rec)
    emit(rec)
    want_launches = -(-len(lookups) // oh.MAX_GROUP_LOOKUPS) if route is None else 1
    if not (rec["scaled_err"] <= tol and cnt_ok and repeat is not False and launches == want_launches):
        raise AssertionError(f"grouped onehot_bwd disagrees with its plain version: {rec}")
    return rec


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


def onehot_bwd_group_checks(torch, np, oh, dev, results):
    """The grouped backward at the main paths' one-hot groups, one launch a
    group: the f32 flagship's 13 lookups (f32 and bf16 cotangents) and
    bench.py's 20 (13 tables and 7 windowed superhot tiers of power-law
    keys, bf16 cotangents), keys as column views of one [B, H] tensor and
    the cotangent [B, W] read in place; then table 20's superhot tier alone
    through the per-table entry (`bench_shape_checks`)."""
    from hugectr_tpu_torch.tools.flagship import BENCH_PLAN, onehot_group_inputs

    for dt, plan_kw in ((torch.float32, {}), (torch.bfloat16, {}), (torch.bfloat16, BENCH_PLAN)):
        rng = np.random.default_rng(31)
        keys, lookups, table, width = onehot_group_inputs(rng, B, E, dt, dev, **plan_kw)
        d = torch.as_tensor(rng.standard_normal((B, width), dtype=np.float32), device=dev).to(dt)
        bwd_group_case(torch, oh, dev, results, f"group{len(lookups)}", keys, lookups, d, table.shape[0], E,
                       windowed=sum(lk.windowed for lk in lookups))


def onehot_bwd_edges(torch, np, rng, oh, dev):
    """The backward's edge cases, one-lookup groups of raw keys unless
    named: every key on one row on each route, V one below, at and one
    above the privatised route's shared-memory limit, the engine's largest
    table, all padding, bfloat16 cotangents; a group of int64 keys past
    2^31, keys that wrap, -1 padding, a window, Mean and Sum, two lookups on
    the same rows, a ragged batch and d read through a row stride, on each
    route; the per-table entry on local keys, accumulation into a caller's
    buffers."""
    vt = oh.bwd_tile_rows(E, dev)
    cases = [("one_row", np.full((B, 40), 5, np.int32), 108, torch.float32, None)]
    cases += [(f"one_row_{r}", np.full((B, 40), 5, np.int32), 108, torch.float32, r) for r in oh.BWD_ROUTES]
    # V one below and at the most rows the privatised route holds in shared
    # memory, and one above
    for v in (vt - 1, vt, vt + 1):
        cases.append((f"V{v}_h40", power_law(rng, v, (B, 40)).astype(np.int32), v, torch.float32, None))
    cases.append((f"V{vt}_h40_privatised", power_law(rng, vt, (B, 40)).astype(np.int32), vt, torch.float32,
                  "privatised"))
    # the engine's largest table at high and low hotness
    for hh in (128, 2):
        cases.append((f"V8192_h{hh}", power_law(rng, 8192, (B, hh)).astype(np.int32), 8192, torch.float32, None))
    cases.append(("all_padding", np.full((B, 3), -1, np.int32), 100, torch.float32, None))
    cases.append(("one_row_bf16", np.full((B, 40), 5, np.int32), 108, torch.bfloat16, None))
    for name, keys_np, v, dt, route in cases:
        keys = torch.as_tensor(keys_np, device=dev)
        d = torch.as_tensor(rng.standard_normal((B, E), dtype=np.float32), device=dev).to(dt)
        bwd_group_case(torch, oh, dev, [], f"edge_{name}", [keys], [oh.GroupLookup(0, v, 0, False)], d, v,
                       E, route=route, tile_rows=vt)
    try:  # one row past the privatised route's limit: refused, not run
        k = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        oh.onehot_bwd_group([k], [oh.GroupLookup(0, vt + 1, 0, False)], torch.zeros((B, E), device=dev), vt + 1,
                            E, route="privatised")
        raise AssertionError("the privatised route took a table past its shared memory")
    except ValueError:
        pass
    # a group: int64 keys with bits past 2^31 (cut to int32), keys that wrap
    # (negative and past V), -1 padding, a window [40, 90) of raw keys, Mean
    # and Sum, two lookups on the same rows; a ragged batch, E 24 (an odd
    # number of 8-column tiles), d a column slice of a wider tensor
    b, e = 1000, 24
    raw = rng.integers(-300, 300, size=(b, 12)).astype(np.int64)
    raw[rng.random(raw.shape) < 0.15] = -1
    raw[:, 0] += 2**33
    kt = torch.as_tensor(raw, device=dev)
    lookups = [oh.GroupLookup(0, 57, 0, False), oh.GroupLookup(57, 100, e, True),
               oh.GroupLookup(157, 50, 2 * e, True, 40, 90), oh.GroupLookup(0, 57, 3 * e, False)]
    keys = [kt[:, 0:3], kt[:, 3:7], kt[:, 7:10], kt[:, 10:12].to(torch.int32)]
    wide = torch.as_tensor(rng.standard_normal((b, 5 * e), dtype=np.float32), device=dev)
    for dt in (torch.float32, torch.bfloat16):
        d = wide.to(dt)[:, e:]
        for route in (None, *oh.BWD_ROUTES):
            bwd_group_case(torch, oh, dev, [], f"edge_group_{route or 'auto'}", keys, lookups, d, 207, e,
                           route=route)
    # the per-table entry (local keys; outside [0, V) padding) on each route
    keys = torch.as_tensor(power_law(rng, 300, (B, 8)).astype(np.int32) - 4, device=dev)
    d = torch.as_tensor(rng.standard_normal((B, E), dtype=np.float32), device=dev)
    scale_g, _ = oh.onehot_matmul_bwd_plain(keys, d.abs(), 300, torch.float32)
    for route in (None, *oh.BWD_ROUTES):
        for dt in (torch.float32, torch.bfloat16):  # the gradient's output type
            dname = str(dt).split(".")[1]
            g, c = oh.onehot_matmul_bwd(keys, d, 300, dt, route=route)
            want_g, want_c = oh.onehot_matmul_bwd_plain(keys, d, 300, dt)
            rec = dict(kernel="onehot_bwd", case=f"per_table_local_{route or 'auto'}", dtype=dname,
                       scaled_err=scaled_err(g.float(), want_g.float(), scale_g), tol=TOL[dname],
                       counts_exact=bool(torch.equal(c, want_c)), dtype_ok=g.dtype == dt)
            emit(rec)
            if not (rec["scaled_err"] <= TOL[dname] and rec["counts_exact"] and rec["dtype_ok"]):
                raise AssertionError(f"the per-table backward disagrees on local keys: {rec}")
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
            plain_ms=time_ms(lambda: ss.segmented_sum_sorted_plain(vals, heads), samples=5, inner=1, warmup=1),
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
    """The ordered pool (csrc/ordered_pool.cu): its main paths' cases
    (`ordered_pool_cases`), then its design's edges (`ordered_pool_edges`)."""
    ordered_pool_cases(torch, np, dev, results)
    ordered_pool_edges(torch, np, dev)


def ordered_pool_cases(torch, np, dev, results):
    """The ordered pool of the owner-partitioned forward against its plain
    version, bitwise, at the shapes of rank 0 of the hybrid phases' W
    ranks: the owned prefix of the gathered 16,384 x h power-law keys of
    the f32 flagship's table-20 group (h 100) and its 5-lookup group, and
    of bench.py's configuration's bf16 cold and hot tiers of table 20; and
    at W 1 the compact forward's shapes (bench.py's measured caps: every
    valid key of the bench cold and hot tiers of table 20, bf16,
    `_pool_segments(..., cut=False)`), and the cold tier's keys on the
    first 128 columns of the [R, 129] rows `rowwise_pack` stores (row
    stride 129); with the kernel's plan (`pool_plan`: elements an access,
    lanes a slot, accesses a lane, shifted accesses), its bound, the plain version's time,
    one `embedding_bag` over the same slots (float32 sums, no rounding
    after each add) and `index_add_` of the gathered rows, each timed by
    CUDA events and by the profiler (`device_ms`: the kernel's launches;
    `library_device_ms`, `index_add_device_ms`: every kernel of the call);
    and two runs compared bitwise."""
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
    for label, dt, plan_kw, names, world, ld in (
            ("flagship", torch.float32, {}, ("mp_ev128_20", "mp_ev128"), w, E),
            ("bench", torch.bfloat16, BENCH_PLAN, ("mp_ev128_20::cold", "mp_ev128_20::hot"), w, E),
            ("compact", torch.bfloat16, BENCH_PLAN, ("mp_ev128_20::cold", "mp_ev128_20::hot"), 1, E),
            ("compact_packed", torch.bfloat16, BENCH_PLAN, ("mp_ev128_20::cold",), 1, E + 1)):
        plan = flagship_plan(ev_size=E, num_shards=world, **plan_kw)
        ec = EmbeddingCollection(plan, ResourceManager(dev, 0, world), OptParams(Optimizer_t.RowWiseAdaGrad),
                                 dtype=dt)
        for gname in names:
            t0 = time.perf_counter()
            g = next(x for x in plan.groups if x.name == gname)
            raw = {}
            for lm in g.lookups:
                raw.setdefault(lm.bottom_name, torch.as_tensor(
                    power_law(rng, raw_vocab(plan, lm), (B, lm.hotness)).astype(np.int32), device=dev))
            srows, offsets, _w = ec._pool_segments(gname, ec._group_keys(g, raw), g.total_local_rows,
                                                   cut=world > 1)
            n = offsets.numel() - 1
            table = torch.empty((g.total_local_rows, ld), device=dev).normal_(generator=gen).to(dt)[:, :E]
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
            # the row ids the kernel must read: its slot's owned rows and the
            # first foreign one after them, where the slot has one
            ids_read = int(torch.minimum(lens + 1, offsets.diff()).sum())
            b_ms, b_by = bound(uniq * E * isz + ids_read * 8 + 8 * (n + 1) + n * E * isz, int(owned.numel()) * E)
            dms, per_call = device_ms(call, KERNEL_NAMES["ordered_pool"])
            dense = table.contiguous()  # embedding_bag's weight: the packed view's columns copied out
            bag = lambda: F.embedding_bag(owned, dense, obounds[:-1], mode="sum")  # noqa: E731
            add = lambda: torch.zeros((n, E), dtype=dt, device=dev).index_add_(0, slot_ids, table[owned])  # noqa: E731
            rec = dict(
                kernel="ordered_pool", case=f"{label}_{gname}_w{world}", dtype=str(dt).split(".")[1], K=k, slots=n,
                E=E, row_stride=ld, owned=int(owned.numel()), ids_read=ids_read, unique_rows=uniq, max_slot_rows=int(lens.max()),
                empty_slots=int((lens == 0).sum()),
                plan=op.pool_plan(E, isz, ld, table.data_ptr(), got.data_ptr(), k / n),
                bitwise=bool(torch.equal(bits(torch, got), bits(torch, want))),
                bitwise_repeat=bool(torch.equal(bits(torch, call()), bits(torch, got))),
                max_abs_err=float((got.float() - want.float()).abs().max()), tol=0.0,
                ms=time_ms(call), device_ms=dms, device_launches_per_call=per_call,
                plain_ms=time_ms(lambda: op.ordered_pool_plain(table, srows, offsets), samples=5, inner=1, warmup=1),
                library_ms=time_ms(bag), library_device_ms=device_ms(bag, KERNEL_NAMES["embedding_bag"])[0],
                library="torch.nn.functional.embedding_bag(mode='sum', offsets) over the owned rows (float32 "
                        "sums, one rounding)",
                index_add_ms=time_ms(add), index_add_device_ms=device_ms(add, KERNEL_NAMES["embedding_bag"])[0],
                bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0,
            )
            rec["scaled_err"] = 0.0 if rec["bitwise"] else math.inf
            results.append(rec)
            emit(rec)
            if not (rec["bitwise"] and rec["bitwise_repeat"]):
                raise AssertionError(f"ordered_pool differs from its plain version: {rec}")


def ordered_pool_edges(torch, np, dev):
    """The ordered pool's design edges against its plain version, bitwise,
    each at the plan's choice: f32 and bf16 at row strides 128, 129, 130
    and 132 and E 13, 16, 64 and 128 (each stride's access width), and at
    E 256 (f32) and 512 (bf16), which take two walks of a slot, on rows of
    E and E + 4 elements; each with long slots (31, 32, 33, 64, 65, 0 and 1
    rows, and slots whose first foreign id stands at 0, 31, 32 and 33: the
    id batches of 8, 16 and 32 lanes turning over; one access a lane) and
    with short ones (0, 1, 2, 3, 7, 8, 9 and 17 rows, the first foreign id
    at 0, 1, 7 and 8: several accesses a lane where they are aligned 16-byte
    ones), weighted at E 128; then 3,000 slots of 0 to 100 rows with
    repeated rows and a tenth of the keys on another rank's shard, f32 and
    bf16 at E 128."""
    from hugectr_tpu_torch.ops import ordered_pool as op

    t0 = time.perf_counter()
    rng = np.random.default_rng(19)
    gen = torch.Generator(device=dev).manual_seed(19)
    shapes = [(dt, stride, e) for dt, stride, e in itertools.product(
        (torch.float32, torch.bfloat16), (128, 129, 130, 132), (13, 16, 64, 128))]
    shapes += [(torch.float32, ld, 256) for ld in (256, 260)] + [(torch.bfloat16, ld, 512) for ld in (512, 516)]
    n_cases = 0
    for (dt, stride, e), (lens, foreign_at, n_ids) in itertools.product(
            shapes, (((31, 32, 33, 64, 65, 0, 1), (0, 31, 32, 33), 40), ((0, 1, 2, 3, 7, 8, 9, 17), (0, 1, 7, 8), 9))):
        ids = [np.sort(rng.integers(0, 70, size=n)) for n in lens]
        for at in foreign_at:
            r = np.sort(rng.integers(0, 70, size=n_ids))
            r[at:] = 70 + np.arange(n_ids - at) % 3
            ids.append(r)
        rows = torch.as_tensor(np.concatenate(ids), device=dev)
        offsets = torch.as_tensor(np.concatenate([[0], np.cumsum([len(x) for x in ids])]), device=dev)
        full = torch.as_tensor((rng.normal(size=(70, stride)) * np.exp2(rng.integers(-8, 4, size=(70, 1))))
                               .astype(np.float32), device=dev).to(dt)
        table = full[:, :e]
        sw = torch.as_tensor((rng.random(rows.numel()) * 3).astype(np.float32), device=dev) if e == E else None
        got = op.ordered_pool(table, rows, offsets, sw)
        n_cases += 1
        if not torch.equal(bits(torch, got), bits(torch, op.ordered_pool_plain(table, rows, offsets, sw))):
            plan = op.pool_plan(e, full.element_size(), stride, table.data_ptr(), got.data_ptr(),
                                rows.numel() / (offsets.numel() - 1))
            raise AssertionError(f"ordered_pool edge case differs from its plain version: {str(dt)} stride "
                                 f"{stride} E {e} slots {lens} plan {plan}")
    for dt in (torch.float32, torch.bfloat16):
        n = 3000
        lens = rng.integers(1, 101, size=n)
        lens[rng.random(n) < 0.2] = 0
        slots = torch.as_tensor(np.repeat(np.arange(n), lens), device=dev)
        # a tenth of the keys on another rank's shard (row id 500)
        rows = torch.as_tensor(np.minimum(rng.integers(0, 550, size=int(lens.sum())), 500), device=dev)
        srows, offsets = op.segments(rows, slots, n, 500)
        table = (torch.empty((500, E), device=dev).normal_(generator=gen)
                 * torch.exp2(torch.randint(-8, 4, (500, 1), device=dev, generator=gen).float())).to(dt)
        got = op.ordered_pool(table, srows, offsets)
        n_cases += 1
        ok = bool(torch.equal(bits(torch, got), bits(torch, op.ordered_pool_plain(table, srows, offsets))))
        if not (ok and bool((got[torch.as_tensor(lens == 0, device=dev)] == 0).all())):
            raise AssertionError(f"ordered_pool differs from its plain version over 3,000 slots, {dt}")
    emit(dict(kernel="ordered_pool", case="edges", cases=n_cases, bitwise=True, seconds=time.perf_counter() - t0))


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
    slot_ids = torch.repeat_interleave(torch.arange(n, device=dev), lens)
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
               index_add_ms=time_ms(lambda: torch.zeros((n, e), device=dev).index_add_(0, slot_ids, table[owned])),
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
               plain_ms=time_ms(lambda: ss.segmented_sum_sorted_plain(vals, heads), samples=5, inner=1, warmup=1),
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
    one-hot forward and backward on BST's category group (11 lookups, 10
    of them into its 8,010-row table) at E 1, 11, 16, 18 and 32 (E 16 is BST's own step; E
    1, 11 and 18 take the one-element lanes, and only E 16 and 32 may take
    the counts matmul); segscan at the sorted-route K of WDL's wide table
    (E 1, K 4,096), DeepFM's table (E 11, K 53,248), DCN's (E 16, K 106,496:
    two keys a slot) and DIN's item table (E 18, K 22,528). Limits as in
    `kernel_checks`; times, bound and library call for each case. Then
    Adam's row update (`adam_row_checks`), Dropout's mask
    (`dropout_mask_checks`) and SGD's scatter into the table
    (`sgd_scatter_checks`) at the samples' shapes."""
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
            rec["seconds"] = time.perf_counter() - t0
            results.append(rec)
            emit(rec)
            if not (err <= TOL[dname] and launches == 1 and per_call in (1, None) and ok_shape):
                raise AssertionError(f"one-hot forward disagrees at the samples' width E {e}: {rec}")
            # the group's backward: 11 lookups, 10 of them on the history table's rows
            d = torch.as_tensor(rng.standard_normal((SAMPLE_B, width), dtype=np.float32), device=dev).to(dt)
            bwd_group_case(torch, oh, dev, results, f"sample_bst_group_E{e}", keys, lookups, d, table.shape[0], e,
                           phase="sample_kernels")
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
                plain_ms=time_ms(lambda: ss.segmented_sum_sorted_plain(vals, heads), samples=5, inner=1, warmup=1),
                library_ms=None, library="none: no single PyTorch call computes a segmented scan",
                bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0,
            )
            results.append(rec)
            emit(rec)
            if not (rec["scaled_err"] <= TOL[dname] and repeat_equal):
                raise AssertionError(f"segscan disagrees at the samples' width E {e}: {rec}")
    adam_row_checks(torch, np, dev, results)
    dropout_mask_checks(torch, np, dev, results)
    sgd_scatter_checks(torch, np, dev, results)


ADAM_WIDTHS = (1, 11, 16, 18)  # the samples' widths on Adam's sorted route
ADAM_LR = 0.001  # the samples' lr (samples/common.py)
ADAM_STEP = 3  # the bias corrections' step in the checks


def adam_bound(n, u, e, tdt, sdt):
    """Adam's row update: the ids up to the count, then each tail's float32
    gradient row once and its table, m and v rows read and written
    (`csrc/row_scatter.cu`), 14 float32 operations an element."""
    return bound(n * 8 + u * e * (4 + 2 * tdt.itemsize + 4 * sdt.itemsize), 14 * u * e)


def adam_setup(torch, rows, e, tdt, sdt, dev):
    """A [rows, e] table of `tdt`, its moments of `sdt` as a few steps leave
    them (v > 0), the lr of the table's type and step 3's bias corrections
    on the device."""
    from hugectr_tpu_torch.core.types import Optimizer_t
    from hugectr_tpu_torch.optim.params import OptParams, StepScalars

    opt = OptParams(optimizer=Optimizer_t.Adam, beta1=0.9, beta2=0.999, epsilon=1e-7)
    state = ((torch.randn((rows, e), device=dev) * 0.05).to(tdt), (torch.randn((rows, e), device=dev) * 0.01).to(sdt),
             (torch.rand((rows, e), device=dev) * 1e-3).to(sdt))
    scalars = StepScalars(dev)
    scalars.fill(ADAM_STEP)
    return opt, state, torch.tensor(ADAM_LR, device=dev).to(tdt), scalars.corrections(opt)


def adam_rows_run(torch, opt, state, sidx, g, count, lr, bc):
    """The kernel twice and the plain version once on clones of `state`:
    (kernel's, second kernel run's, plain version's)."""
    from hugectr_tpu_torch.ops import row_scatter as rs

    a, b, c = ([x.clone() for x in state] for _ in range(3))
    rs.adam_rows(opt, *a, sidx, g, count, lr, *bc)
    rs.adam_rows(opt, *c, sidx, g, count, lr, *bc)
    rs.adam_rows_plain(opt, *b, sidx, g, count, lr, *bc)
    torch.cuda.synchronize()
    return a, c, b


def adam_row_checks(torch, np, dev, results):
    """Phase "adam_rows" (in "sample_kernels"): Adam's drop-mode row update
    (`adam_rows`) against its plain version on the sorted lists the
    samples' Adam sorted groups give it at batch 2,048 (criteo_parquet,
    WDL's two, DeepFM, DCN, DIN's and BST's item tables: the sorted
    power-law keys of the whole table, every key valid, float32 sums), on
    float32 table and state at step 3's bias corrections:
    bitwise, two runs bitwise, every tail's row changed; device ms, CUDA
    events ms, the plain version's and the bound. Then its edges
    (`adam_rows_edges`)."""
    from hugectr_tpu_torch.ops import row_scatter as rs
    from hugectr_tpu_torch.tools import samples as ts
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms

    rng = np.random.default_rng(27)
    lists = (("criteo", 16, ts.CRITEO_SLOTS, 1), ("wdl_deep", 16, ts.WDL_DEEP_SLOTS, 1),
             ("wdl_wide", 1, ts.WDL_WIDE_SLOTS, 1), ("deepfm", 11, ts.CRITEO_SLOTS, 1), ("dcn", 16, ts.DCN_SLOTS, 2),
             ("din_good", 18, [ts.GOOD_VOCAB] * (ts.SEQ + 1), 1), ("bst_good", 16, [ts.GOOD_VOCAB] * ts.SEQ, 1))
    for name, e, slots, nnz in lists:  # case, E, the table's slots, keys a slot
        t0 = time.perf_counter()
        seg, heads = sample_sorted_rows(np, rng, slots, nnz)
        rows, k = sum(slots), len(seg)
        tails = int(heads.sum())
        sidx = torch.as_tensor(seg, device=dev)
        g = torch.as_tensor(rng.standard_normal((k, e), dtype=np.float32), device=dev)
        count = torch.tensor(k, device=dev)
        opt, state, lr, bc = adam_setup(torch, rows, e, torch.float32, torch.float32, dev)
        a, c, b = adam_rows_run(torch, opt, state, sidx, g, count, lr, bc)
        agree = dict(max_abs_err=max(max_abs_diff(torch, x, y) for x, y in zip(a, b)),
                     bitwise=all(torch.equal(x, y) for x, y in zip(a, b)),
                     bitwise_repeat=all(torch.equal(x, y) for x, y in zip(a, c)), rows_changed=rows_changed(a, state))
        call = lambda: rs.adam_rows(opt, *a, sidx, g, count, lr, *bc)  # noqa: E731 (changes a: timed last)
        b_ms, b_by = adam_bound(k, tails, e, torch.float32, torch.float32)
        dms, per_call = device_ms(call, KERNEL_NAMES["adam_rows"])
        rec = dict(
            phase="sample_kernels", kernel="adam_rows", case=f"sample_{name}_E{e}", dtype="float32",
            state_dtype="float32", K=k, count=k, unique_rows=tails, rows=rows, E=e, **agree,
            ms=time_ms(call), device_ms=dms, device_launches_per_call=per_call,
            plain_ms=time_ms(lambda: rs.adam_rows_plain(opt, *b, sidx, g, count, lr, *bc), samples=5, inner=1,
                             warmup=1),
            library_ms=None, library="none: no single PyTorch call computes a row-wise optimizer update",
            bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0,
        )
        results.append(rec)
        emit(rec)
        if not (rec["bitwise"] and rec["bitwise_repeat"] and rec["rows_changed"] == tails):
            raise AssertionError(f"Adam's row update disagrees with its plain version: {rec}")
    adam_rows_edges(torch, np, dev, results)


def adam_rows_edges(torch, np, dev, results):
    """Adam's row update at its edges against its plain version, at DIN's
    item list (K 22,528 into its 693,011-row table) at E 1, 11, 16 and 18:
    sorted power-law ids with a negative id first, one row repeated over
    positions 28-300 (across the 32-id tiles' edges), 64 ids at or past R
    inside the count, then the padding; every seventh tail's summed
    gradient 0 (Adam still decays its m and v and moves its weights);
    counts 0, the ids below R, those and the 64 past R, and K; a float32
    table and state, a bfloat16 table with float32 state, bfloat16 state,
    each with an lr of the table's type. Bitwise its plain version in every
    case, two runs bitwise, the rows changed those the plain version
    changed, none at count 0 and with float32 state every live tail's (in
    bfloat16 a step smaller than half a unit in the last place leaves a
    row as it was: m = 0.9 m + 0.1 g rounds back to m where g is near m,
    v and the weights move by less); device ms at count K beside the
    bound, CUDA events and the plain version's ms."""
    from hugectr_tpu_torch.ops import row_scatter as rs
    from hugectr_tpu_torch.tools import samples as ts
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms

    rng = np.random.default_rng(28)
    rows, k, past, pad = ts.GOOD_VOCAB * (ts.SEQ + 1), SAMPLE_B * (ts.SEQ + 1), 64, 1024
    valid = k - past - pad
    ids = np.sort(power_law(rng, rows, valid))
    ids[0] = -1
    ids[28:301] = ids[28]
    sidx = torch.as_tensor(np.concatenate([ids, rows + np.arange(past), np.full(pad, rows + past)]), device=dev)
    ends = np.flatnonzero(np.concatenate([ids[1:-1] != ids[2:], [True]])) + 1  # every run's end but the -1's
    for e in ADAM_WIDTHS:
        g = torch.as_tensor(rng.standard_normal((k, e), dtype=np.float32), device=dev)
        g[torch.as_tensor(ends[::7], device=dev)] = 0.0
        for tdt, sdt in ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                         (torch.bfloat16, torch.bfloat16)):
            t0 = time.perf_counter()
            opt, state, lr, bc = adam_setup(torch, rows, e, tdt, sdt, dev)
            checks = []
            for n in (0, valid, valid + past, k):
                count = torch.tensor(n, device=dev)
                a, c, b = adam_rows_run(torch, opt, state, sidx, g, count, lr, bc)
                checks.append(dict(count=n, bitwise=all(torch.equal(x, y) for x, y in zip(a, b)),
                                   bitwise_repeat=all(torch.equal(x, y) for x, y in zip(a, c)),
                                   max_abs_err=max(max_abs_diff(torch, x, y) for x, y in zip(a, b)),
                                   rows_changed=rows_changed(a, state), plain_rows_changed=rows_changed(b, state)))
            b_ms, b_by = adam_bound(k, len(ends), e, tdt, sdt)
            call = lambda: rs.adam_rows(opt, *a, sidx, g, count, lr, *bc)  # noqa: E731
            dms, per_call = device_ms(call, KERNEL_NAMES["adam_rows"])
            rec = dict(kernel="adam_rows",
                       case=f"edges_E{e}_{str(tdt).split('.')[1]}_{str(sdt).split('.')[1]}",
                       dtype=str(tdt).split(".")[1], state_dtype=str(sdt).split(".")[1], K=k, E=e, rows=rows,
                       count=k, unique_rows=len(ends), zero_grad_tails=len(ends[::7]), checks=checks,
                       max_abs_err=max(x["max_abs_err"] for x in checks), ms=time_ms(call), device_ms=dms,
                       device_launches_per_call=per_call,
                       plain_ms=time_ms(lambda: rs.adam_rows_plain(opt, *b, sidx, g, count, lr, *bc), samples=3,
                                        inner=1, warmup=1),
                       library_ms=None, library="none: no single PyTorch call computes a row-wise optimizer update",
                       bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms,
                       ok=all(x["bitwise"] and x["bitwise_repeat"] and x["rows_changed"] == x["plain_rows_changed"]
                              and (x["rows_changed"] == 0 if x["count"] == 0 else
                                   sdt == torch.bfloat16 or x["rows_changed"] == len(ends)) for x in checks),
                       seconds=time.perf_counter() - t0)
            results.append(rec)
            emit(rec)
            if not rec["ok"]:
                raise AssertionError(f"Adam's row update disagrees with its plain version at its edges: {rec}")


# Dropout's layers at batch 2,048 (`samples_path`): (graph, width)
DROPOUT_SHAPES = (("wdl", 1024), ("deepfm", 400), ("ncf", 256))


def dropout_mask_checks(torch, np, dev, results):
    """Phase "dropout_mask" (in "sample_kernels"): the keep mask of
    Dropout 0.5 at the samples' layers (`DROPOUT_SHAPES`, batch 2,048)
    against its plain version, bitwise (integer arithmetic), the kept share
    within 5 standard deviations of 0.5, the next step's mask another with
    about half its elements equal, and a rank's block of the global mask
    the mask drawn from its first index (W 2); then at keep 0.8. Device ms,
    CUDA events ms, the plain version's, the bound (the mask's bytes
    written; 24 integer operations an element against the float32 rate)."""
    from hugectr_tpu_torch.ops import dropout as dr
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms

    key = dr.key_of(0x2545F4914F6CDD1D)
    step = torch.tensor(5, device=dev)
    for graph, width in DROPOUT_SHAPES:
        for keep in (0.5, 0.8):
            t0 = time.perf_counter()
            n = SAMPLE_B * width
            got = dr.dropout_mask(key, step, n, 0, keep)
            want = dr.dropout_mask_plain(key, step, n, 0, keep)
            nxt = dr.dropout_mask(key, step + 1, n, 0, keep)
            half = dr.dropout_mask(key, step, n // 2, n // 2, keep)
            torch.cuda.synchronize()
            share = float(got.float().mean())
            both = keep**2 + (1 - keep) ** 2
            agree = float((got == nxt).float().mean())
            call = lambda: dr.dropout_mask(key, step, n, 0, keep)  # noqa: E731
            b_ms, b_by = bound(n + 8, 24 * n)
            dms, per_call = device_ms(call, KERNEL_NAMES["dropout_mask"])
            rec = dict(
                phase="sample_kernels", kernel="dropout_mask", case=f"sample_{graph}_{width}_keep{keep}",
                dtype="bool", B=SAMPLE_B, width=width, keep=keep, elements=n, bitwise=bool(torch.equal(got, want)),
                max_abs_err=float((got != want).sum()), kept_share=share, next_step_agreement=agree,
                rank_block_equal=bool(torch.equal(half, got[n // 2:])), ms=time_ms(call), device_ms=dms,
                device_launches_per_call=per_call,
                plain_ms=time_ms(lambda: dr.dropout_mask_plain(key, step, n, 0, keep), samples=5, inner=1, warmup=1),
                library_ms=None,
                library="none: no PyTorch call draws a mask that is a function of a device step",
                bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0,
            )
            results.append(rec)
            emit(rec)
            sd = math.sqrt(keep * (1 - keep) / n)
            if not (rec["bitwise"] and rec["rank_block_equal"] and abs(share - keep) <= 5 * sd
                    and abs(agree - both) <= 5 * math.sqrt(both * (1 - both) / n)):
                raise AssertionError(f"Dropout's mask disagrees with its plain version or its rate: {rec}")


def sgd_scatter_checks(torch, np, dev, results):
    """SGD's update (MMoE's and shared-bottom's optimizer): the drop-mode
    scatter of -lr g into the table itself (`scatter_add_rows_`) against its
    plain version on MMoE's table (the 32 slots' rows, E 16) and its batch
    (2,048 x 32 power-law keys, 1,024 of them past the rows, so dropped):
    the float32 tolerance of the scaled error (atomic adds, as
    `index_add_`'s), the rows no key lands on bitwise unchanged (row 0 at
    -0.0 kept); one `index_add_` of the valid rows beside it."""
    from hugectr_tpu_torch.ops import row_scatter as rs
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms
    from hugectr_tpu_torch.tools.samples import MMOE_SLOTS

    t0 = time.perf_counter()
    rng = np.random.default_rng(29)
    rows, e, k = sum(MMOE_SLOTS), 16, SAMPLE_B * len(MMOE_SLOTS)
    keys = power_law(rng, rows - 1, k) + 1  # row 0 gets no key
    keys[rng.choice(k, 1024, replace=False)] = rows + 7
    idx = torch.as_tensor(keys, device=dev)
    src = torch.arange(k, device=dev)
    vals = -ADAM_LR * torch.as_tensor(rng.standard_normal((k, e), dtype=np.float32), device=dev)
    table = torch.randn((rows, e), device=dev)
    table[0] = -0.0
    got, want = table.clone(), table.clone()
    rs.scatter_add_rows_(got, idx, src, vals)
    rs.scatter_add_rows_into_plain(want, idx, src, vals)
    scale = table.abs()
    rs.scatter_add_rows_into_plain(scale, idx, src, vals.abs())
    touched = torch.zeros(rows, dtype=torch.bool, device=dev)
    touched[idx[idx < rows]] = True
    valid = idx < rows
    vidx, vv = idx[valid], vals[src[valid]]
    buf = table.clone()
    torch.cuda.synchronize()
    n = int(valid.sum())
    call = lambda: rs.scatter_add_rows_(buf, idx, src, vals)  # noqa: E731
    b_ms, b_by = bound(k * 16 + n * e * 4 + 2 * int(touched.sum()) * e * 4, n * e)
    dms, per_call = device_ms(call, KERNEL_NAMES["row_scatter"])
    rec = dict(
        kernel="row_scatter", case="sgd_mmoe_table", dtype="float32", out_dtype="float32", K=k, valid=n, rows=rows,
        E=e, scaled_err=scaled_err(got, want, scale), max_abs_err=float((got - want).abs().max()),
        tol=TOL["float32"], untouched_bitwise=bool(torch.equal(got[~touched], table[~touched])),
        row0_negative_zero=bool(torch.signbit(got[0]).all()), ms=time_ms(call), device_ms=dms,
        device_launches_per_call=per_call,
        plain_ms=time_ms(lambda: rs.scatter_add_rows_into_plain(buf, idx, src, vals), samples=5, inner=1, warmup=1),
        library_ms=time_ms(lambda: buf.index_add_(0, vidx, vv)),
        library="torch.Tensor.index_add_ of the valid rows (taken out beforehand)",
        bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms, seconds=time.perf_counter() - t0,
    )
    results.append(rec)
    emit(rec)
    if not (rec["scaled_err"] <= TOL["float32"] and rec["untouched_bitwise"] and rec["row0_negative_zero"]):
        raise AssertionError(f"SGD's scatter into the table disagrees with its plain version: {rec}")


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
    dropout 0.5) on synthetic learnable data, as one captured program
    (`step_mode` "graph": the steps after the first and the eval batches
    after the first replay their captures): 6 steps, then a warm-up eval
    and a timed one over 20 batches, launch counters set to 0 just before
    the steps and the timed eval and read just after. One line per graph:
    median ms/step of steps 2-6, train and eval ex/s, peak memory, routes,
    each kernel's launches a step, the step-1 and step-6 losses (a loss
    that does not fall is printed, not failed), the eval (each task's AUC
    for MMoE). Then `graph_ab` ("samples_<graph>_graph_ab": eager against
    replayed from one state, the replays under
    `set_sync_debug_mode("error")`). Non-finite losses fail; so does a step
    mode other than "graph", `adam_rows` other than once per Adam sorted
    group and step (none in eval), `dropout_mask` other than once per
    Dropout layer of rate > 0 and step, a kernel that no graph launches,
    and BST's one-hot group if it is not the one `bst_onehot_group`
    checks."""
    from hugectr_tpu_torch import ops
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.core.types import Optimizer_t
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
        routes = dict(model.ec.group_routes)
        kind = model.opt_params.optimizer
        n_adam = list(routes.values()).count("sorted") * (kind == Optimizer_t.Adam)
        n_drop = sum(d.layer_type == "Dropout" and d.dropout_rate > 0 for d in model.dense_layers)
        rec = dict(
            phase="samples_path", graph=graph, batch=SAMPLE_B, steps=6, optimizer=kind.value,
            step_mode=model.step_mode, captured=sorted(model._graphs),
            tables={g.name: [g.total_storage_rows, g.ev_size] for g in model.ec.plan.groups},
            median_ms_per_step=steady * 1e3, step_ms=[x * 1e3 for x in step_s],
            train_examples_per_s=SAMPLE_B / steady,
            eval_batches=20, eval_seconds=eval_s, eval_examples_per_s=20 * SAMPLE_B / eval_s,
            max_memory_allocated=torch.cuda.max_memory_allocated(), routes=routes,
            adam_sorted_groups=n_adam, dropout_layers=n_drop,
            launches_per_step={k: n / 6 for k, n in train_launches.items()}, eval_launches=eval_launches,
            loss_step1=losses[0], loss_step6=losses[-1], loss_fell=losses[-1] < losses[0], eval=vals,
            build_seconds=build_s, seconds=time.perf_counter() - t0,
        )
        emit(rec)
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite loss on the {graph} path: {losses}")
        if rec["step_mode"] != "graph" or rec["captured"] != ["eval", "train"]:
            raise AssertionError(f"the {graph} path ran {rec['step_mode']}, captured {rec['captured']}")
        if not (train_launches["adam_rows"] == 6 * n_adam and train_launches["dropout_mask"] == 6 * n_drop
                and eval_launches["adam_rows"] == eval_launches["dropout_mask"] == 0):
            raise AssertionError(f"the {graph} path's launches: {train_launches}, eval {eval_launches}")
        if graph == "bst":
            got = sorted((lk.row_off, lk.vocab) for g in onehot if g.ev_size == 16 for lk in onehot_fwd_lookups(g))
            want = sorted([(0, CATE_VOCAB * SEQ)] * SEQ + [(CATE_VOCAB * SEQ, CATE_VOCAB)])
            if got != want or train_launches["onehot_fwd"] != 6 * len(onehot) \
                    or train_launches["onehot_bwd"] != 6 * len(onehot):
                raise AssertionError(f"BST's one-hot group {got}, {train_launches['onehot_fwd']} forward and "
                                     f"{train_launches['onehot_bwd']} backward launches in 6 steps")
        out[graph] = {k: train_launches[k] + eval_launches[k] for k in train_launches}
        graph_ab(torch, model, f"samples_{graph}")
        del model
        torch.cuda.empty_cache()
    missing = [k for k in (*ONE_CARD_KERNELS, "adam_rows", "dropout_mask", "row_scatter")
               if not any(x[k] for x in out.values())]
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
        if not dynamic and min(launches[k] for k in (*ONE_CARD_KERNELS, "ftrl_rows")) <= 0:
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
        launches=launches, step_mode=model.step_mode, build_seconds=build_s, seconds=time.perf_counter() - t0,
    )
    emit(rec)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss on the main path: {losses}")
    missing = [k for k in (*ONE_CARD_KERNELS, *drop_kernels(model.ec.group_routes)) if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if launches["onehot_fwd"] != 6 or launches["onehot_bwd"] != 6:  # one grouped launch each a step
        raise AssertionError(f"onehot_fwd / onehot_bwd launched {launches['onehot_fwd']} / "
                             f"{launches['onehot_bwd']} times in 6 steps, not 6")
    rec["graph_ab"] = graph_ab(torch, model, "main_path")
    return launches, rec


def max_abs_diff(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def graph_ab(torch, model, label: str) -> dict:
    """The default step (a captured step replayed, `Model.step_mode`
    "graph") against the eager one (`use_cuda_graph` False, the same
    fixed-shape code), from the same state, in turns: eager, graph, graph,
    eager (`tools/graph_ab.py::run`: agreement of the loss and of every
    table, state and parameter, ms/step with the replays under
    `torch.cuda.set_sync_debug_mode("error")`, the collectives a step, the
    eval eager against replayed, confirmed traces of each mode). Prints the
    record and raises on any of `graph_ab.failures`; returns the record."""
    from hugectr_tpu_torch.tools import graph_ab as gab

    rec = gab.run(model, label)
    emit(rec)
    fails = gab.failures(rec)
    if fails:
        raise AssertionError(f"{label}: " + "; ".join(fails))
    return rec


def mode_turns(model, run) -> list:
    """ms/step of the eager step (`use_cuda_graph` False) and the default
    captured one in turns (`tools/graph_ab.py::TURNS`) in one process, from
    `run()` (a dict with "sec_per_iter"), the state carried on from turn to
    turn; the model is left on its default step."""
    from hugectr_tpu_torch.tools.graph_ab import TURNS

    turns = []
    try:
        for turn in TURNS:
            model.solver.use_cuda_graph = turn == "graph"
            r = run()
            turns.append(dict(turn=turn, step_mode=model.step_mode, ms_per_step=r["sec_per_iter"] * 1e3))
    finally:
        model.solver.use_cuda_graph = True
    if [x["step_mode"] == "graph" for x in turns] != [t == "graph" for t in TURNS]:
        raise AssertionError(f"the turns did not run the step they name: {turns}")
    return turns


def drop_kernels(routes: dict) -> tuple:
    """The drop-mode kernels a step of these routes launches (rowwise
    AdaGrad, the flagship's optimizer): the dense sweep's scatter, the
    sorted route's row update."""
    kinds = set(routes.values())
    return ("row_scatter",) * ("dense" in kinds) + ("adagrad_rows",) * ("sorted" in kinds)


def caps_line(ec) -> dict:
    """Each rowop group's measured caps and last route: {group: {"unique",
    "valid", "dense_exchange", "route"}} (0 where none was measured)."""
    return {g.name: dict(unique=ec.unique_caps.get(g.name, 0), valid=ec.valid_caps.get(g.name, 0),
                         dense_exchange=ec.dense_exchange_caps.get(g.name, 0), route=ec.group_routes.get(g.name))
            for g in ec.plan.groups if g.compute_kind == "rowop"}


# the groups that bench.py's caps send to the compact forward on one card:
# the hot and cold tiers of the 7 split tables (PERF.md section 4), 14
# ordered-pool launches a step and eval batch; with onehot_scatter_ratio
# 2,000 table 20's hot tier joins the one-hot group and 13 are left
BENCH_COMPACT = frozenset(f"mp_ev128_{t}::{tier}" for t in (0, 9, 10, 19, 20, 21, 22) for tier in ("hot", "cold"))
SCATTER_RATIO_COMPACT = BENCH_COMPACT - {"mp_ev128_20::hot"}


def compact_groups(ec) -> list:
    """The groups one card pools by the compact forward: a valid cap below
    the batch's key list (`EmbeddingCollection.forward`)."""
    b = ec.rm.data_parallel_size
    return [g.name for g in ec.plan.groups if g.compute_kind == "rowop"
            and 0 < ec.valid_caps.get(g.name, 0) < B * g.hotness_total and b == 1]


def bench_path(torch):
    """Phase 5: the flagship as bench.py configures it, at full width
    (`bench_settings()`: batch 16,384, vocab_cap 2M, ev 128, bf16 tables and
    state, mixed precision, hot 131,072 / superhot 1,024 / split vocab
    16,384, the caps measured on the first batch with a headroom of 1.05):
    6 training steps, then one warm-up `eval()` and one timed `eval()` over
    320 batches of 16,384. Launch counters are set to 0 just before the
    steps and read just after, and again around the timed eval. Prints each
    group's caps and route; the compact forward launches the ordered pool
    once a step and eval batch for each group with a valid cap."""
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
    caps = compact_groups(model.ec)
    rec = dict(
        phase="bench_path", settings=kw, tables=26, steps=6, losses=losses, caps=caps_line(model.ec),
        compact_groups=caps, ordered_pool_per_step=train_launches["ordered_pool"] / 6,
        step_ms=[x * 1e3 for x in step_s], median_ms_per_step=steady * 1e3, train_examples_per_s=B / steady,
        eval_batches=model.solver.max_eval_batches, eval_seconds=eval_s, warmup_eval_seconds=warm_s,
        eval_examples_per_s=n_eval / eval_s, eval=vals, auc_binned=binned, auc_exact=exact,
        auc_binned_minus_exact=binned - exact, max_memory_allocated=torch.cuda.max_memory_allocated(),
        onehot_group_lookups=len(onehot.lookups), onehot_group_windowed=sum(lm.windowed for lm in onehot.lookups),
        routes=dict(model.ec.group_routes), train_launches=train_launches, eval_launches=eval_launches,
        table_dtype=str(next(iter(model.tables.values())).dtype), step_mode=model.step_mode,
        build_seconds=build_s, seconds=time.perf_counter() - t0,
    )
    emit(rec)
    if not (len(losses) == 6 and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"non-finite loss on the bench path: {losses}")
    missing = [k for k in (*ONE_CARD_KERNELS, "ordered_pool", *drop_kernels(model.ec.group_routes))
               if train_launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the bench path: {missing}")
    if set(model.ec.valid_caps) != BENCH_COMPACT:
        raise AssertionError(f"valid caps measured for {sorted(model.ec.valid_caps)}, not {sorted(BENCH_COMPACT)}")
    if (train_launches["ordered_pool"] != 6 * 14
            or eval_launches["ordered_pool"] != model.solver.max_eval_batches * 14):
        raise AssertionError(f"the compact forward of 14 groups launched the ordered pool {train_launches} / "
                             f"{eval_launches}")
    if train_launches["onehot_fwd"] != 6 or eval_launches["onehot_fwd"] != model.solver.max_eval_batches:
        raise AssertionError(f"onehot_fwd launched {train_launches['onehot_fwd']} times in 6 steps and "
                             f"{eval_launches['onehot_fwd']} in {model.solver.max_eval_batches} eval batches")
    if train_launches["onehot_bwd"] != 6:  # one launch for the 20 lookups a step
        raise AssertionError(f"onehot_bwd launched {train_launches['onehot_bwd']} times in 6 steps, not 6")
    if len(onehot.lookups) != 20:
        raise AssertionError(f"the one-hot group holds {len(onehot.lookups)} lookups, not 20")
    if not (abs(binned - exact) <= 1e-4 and abs(vals["auc"] - binned) <= 1e-6):
        raise AssertionError(f"binned AUC {binned} (eval: {vals['auc']}) vs exact {exact}")
    if eval_launches["onehot_bwd"] or eval_launches["segscan"]:
        raise AssertionError(f"eval launched backward kernels: {eval_launches}")
    graph_ab(torch, model, "bench_path")
    return {k: train_launches[k] + eval_launches[k] for k in train_launches}


UCAP_DROP_FACTORS = (0.5, 0.05)  # the drop mode's windows: ceil512(K x factor) unique rows
PACKED_F32_CAP = 400_000  # the f32 packed flagship's cap: its 3.4 GB snapshot written and read in a few s


def live_state_differs(torch, a, b) -> list:
    """The names of the arrays of two models' state that differ bitwise,
    compared where they live (the card: no host copy of the tables): every
    storage array (packed groups whole, key stores), the sparse optimizer
    state, the dense parameters and their state, and the step."""
    def bits(t):
        t = t.detach()
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]) \
            if t.is_floating_point() else t

    def arrays(m):
        out = {f"table:{k}": t for k, t in m.tables.items()}
        out.update({f"eopt:{g}.{k}": t for g, st in m.eopt.items() for k, t in st.items()})
        out.update({f"dense:{layer}.{k}": p for layer, ps in m.network.param_tree().items() for k, p in ps.items()})
        out.update({f"dopt:{kind}.{layer}.{k}": t for kind, tree in m.dopt.items()
                    for layer, ps in tree.items() for k, t in ps.items()})
        return out

    x, y = arrays(a), arrays(b)
    out = sorted(set(x) ^ set(y)) + sorted(k for k in set(x) & set(y) if not torch.equal(bits(x[k]), bits(y[k])))
    return out + (["step"] if a._step != b._step else [])


def packed_run(torch, label: str, kw: dict):
    """A model of `build_dlrm_dcnv2` with `kw`: 3 steps (launches counted),
    a snapshot into a temporary directory, a second model from another seed
    that loads it (the caps of the first carried, as a resumed run would
    measure its own), the state arrays that differ bitwise (the packed
    storage whole), then both models trained on the same 3 cached batches."""
    import tempfile

    from hugectr_tpu_torch import ops
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools.flagship import build_dlrm_dcnv2

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    build = lambda seed: build_dlrm_dcnv2(ResourceManager.create(), synthetic_batches=6, seed=seed,  # noqa: E731
                                          **dict(dict(batchsize=B, max_eval_batches=1), **kw))
    a = build(0)
    a.start_data_reading()
    batches = [next(a._train_iter) for _ in range(6)]  # one pass: the cycle is back at batch 0
    ops.reset_counts()
    losses = [a.train() for _ in range(3)]
    launches = ops.launch_counts()
    packed = {g: [list(a.tables[g].shape), a.ec.packed_kind[g], a.ec.group_routes[g]] for g in a.ec.packed_groups}
    with tempfile.TemporaryDirectory(prefix="hctr_packed_") as tmp:
        prefix = os.path.join(tmp, "snap")
        torch.cuda.synchronize()
        t = time.perf_counter()
        a.download_params_to_files(prefix, 3)
        write_s = time.perf_counter() - t
        files = sorted(f for f in os.listdir(f"{prefix}_iter3") if f.startswith("packed_"))
        nbytes = dir_bytes(f"{prefix}_iter3")
        b = build(7)
        for attr in ("unique_caps", "valid_caps", "dense_exchange_caps"):
            setattr(b.ec, attr, dict(getattr(a.ec, attr)))
        b.ec.ucap_measured = a.ec.ucap_measured
        before = live_state_differs(torch, a, b)
        t = time.perf_counter()
        b.load_params_from_files(f"{prefix}_iter3")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    differ = live_state_differs(torch, a, b)
    resumed = [(float(a.train_step(x)), float(b.train_step(x))) for x in batches[3:6]]
    rel = max(abs(la - lb) / max(abs(la), 1e-30) for la, lb in resumed)
    rec = dict(phase="packed_path", run=label, settings={k: v for k, v in kw.items() if k != "metrics_spec"},
               card=card_line(), losses=losses, launches=launches, packed=packed, packed_files=files,
               caps=caps_line(a.ec), bytes_written=nbytes, write_seconds=write_s, load_seconds=load_s,
               arrays_differing_before_load=len(before), arrays_differing_after_load=differ, resumed_losses=resumed, resumed_loss_max_rel_diff=rel,
               max_memory_allocated=torch.cuda.max_memory_allocated(), seconds=time.perf_counter() - t0)
    emit(rec)
    del a, b
    ok = (all(math.isfinite(x) for x in losses) and before and not differ and rel <= 1e-6 and packed
          and files == sorted(f"packed_{g}.npy" for g in packed)
          and all(route == "sorted" for _shape, _kind, route in packed.values()))
    if not ok:
        raise AssertionError(f"packed path ({label}): {rec}")
    return rec


def packed_path(torch):
    """The packed table-and-state layouts (the JAX package's
    HCTR_TPU_ROWWISE_PACK and HCTR_TPU_PACKED_STATE, collection.py:254-286)
    and the capacity-drop update (HCTR_TPU_UCAP_DROP). Three runs of the
    flagship at batch 16,384, ev 128, each 3 steps:
    (1) bench.py's settings (`bench_settings()`: cap 2,000,000, bf16, the
    measured caps) with `rowwise_pack`: the 7 cold tiers and table 11's
    group stored [R, 129], on the sorted route; a snapshot
    (`packed_<group>.npy` beside the usual files) reloaded bitwise into a
    model from another seed, then 3 resumed losses of both within 1e-6
    relative (`packed_run`);
    (2) the f32 flagship with AdaGrad and `packed_state` ([R, 256], every
    rowop group), the same checks; its cap cut to 400,000 so that its
    snapshot (3.4 GB) is written and read in seconds;
    (3) bench.py's settings with `unique_cap_factor=0.5, ucap_drop=True`:
    each sorted group's update keeps the first ceil512(K / 2) of its sorted
    unique rows; the rows dropped a step are printed. K counts the tier's
    out-of-window keys, so no window is that short at these shapes (the
    cold tier of table 20: about 202,000 unique rows of K 1,638,400); a
    factor of 0.05 then makes the windows drop rows, which it must. Returns
    the kernels' launches of the steps of the runs."""
    from hugectr_tpu_torch import ops
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools.flagship import bench_settings, build_dlrm_dcnv2

    total = {}
    rw = packed_run(torch, "bench_rowwise_pack", dict(bench_settings(), rowwise_pack=True))
    cold = [g for g in rw["caps"] if g.endswith("::cold")]
    if not cold or any(g not in rw["packed"] or rw["packed"][g][0][1] != E + 1 for g in cold):
        raise AssertionError(f"the cold tiers are not stored [R, {E + 1}]: {rw['packed']}")
    full = packed_run(torch, "f32_packed_state", dict(vocab_cap=PACKED_F32_CAP, optimizer="adagrad",
                                                      packed_state=True))
    if any(shape[1] != 2 * E or kind != "full" for shape, kind, _route in full["packed"].values()):
        raise AssertionError(f"the f32 packed groups are not [R, {2 * E}]: {full['packed']}")
    for rec in (rw, full):
        for k, v in rec["launches"].items():
            total[k] = total.get(k, 0) + v
    for factor in UCAP_DROP_FACTORS:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        model = build_dlrm_dcnv2(ResourceManager.create(), synthetic_batches=3,
                                 **dict(bench_settings(), unique_cap_factor=factor, ucap_drop=True))
        model.start_data_reading()
        ops.reset_counts()
        losses, dropped = [], []
        for _ in range(3):
            before = model.ec.ucap_stats["ucap_dropped"]
            losses.append(model.train())
            dropped.append(model.ec.ucap_stats["ucap_dropped"] - before)
        lc = ops.launch_counts()
        rec = dict(phase="packed_path", run="bench_ucap_drop", card=card_line(), settings=dict(
            unique_cap_factor=factor, ucap_drop=True), losses=losses, rows_dropped_per_step=dropped,
            routes=dict(model.ec.group_routes), launches=lc, seconds=time.perf_counter() - t0)
        emit(rec)
        model._close_readers()
        del model
        if not (all(math.isfinite(x) for x in losses) and lc["segscan"] > 0 and (factor > 0.1 or min(dropped))):
            raise AssertionError(f"packed path (drop mode): {rec}")
        for k, v in lc.items():
            total[k] = total.get(k, 0) + v
    return total


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
                            synthetic_batches=steps, max_eval_batches=eval_batches, metrics_spec=METRICS,
                            synthetic_learnable=True)
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
        rows=sum(g.total_storage_rows for g in ec.plan.groups), losses=losses, learnable_labels=True,
        loss_falls=losses[-1] < losses[0], loss_change=losses[-1] - losses[0],
        step_ms=[x * 1e3 for x in step_s], median_ms_per_step=steady * 1e3, train_examples_per_s=B / steady,
        eval_batches=eval_batches, eval_seconds=eval_s, warmup_eval_seconds=warm_s,
        eval_examples_per_s=eval_batches * B / eval_s, eval=vals,
        max_memory_allocated=torch.cuda.max_memory_allocated(), routes=dict(ec.group_routes),
        train_launches=train_launches, launches_per_step={k: n / steps for k, n in train_launches.items()},
        eval_launches=eval_launches, step_mode=model.step_mode, captured=sorted(model._graphs),
        build_seconds=build_s, seconds=time.perf_counter() - t0,
    )
    if dynamic:
        rec.update(key_store_rows=int(model.tables["mp_ev128#keys"].numel()), key_store_fill=fill,
                   dropped_keys=dropped)
    return model, rec


def ftrl_path(torch):
    """DLRM with FTRL, static tables, as one captured program (`step_mode`
    "graph": the steps after the first and the eval batches after the
    first replay their captures): 6 steps and eval over 20 batches. Every
    kernel launches in the steps; `onehot_fwd` once per step and per eval
    batch, `onehot_bwd` once per step (one launch for the 13-table one-hot
    group), `segscan` and `ftrl_rows` once per sorted group and step (5).
    Then `graph_ab` ("ftrl_path_graph_ab")."""
    model, rec = ftrl_run(torch, dynamic=False)
    emit(rec)
    tl, el = rec["train_launches"], rec["eval_launches"]
    if not all(math.isfinite(x) for x in rec["losses"]):
        raise AssertionError(f"non-finite loss on the FTRL path: {rec['losses']}")
    if rec["routes"] != FTRL_ROUTES["static"] or rec["step_mode"] != "graph":
        raise AssertionError(f"FTRL path routes {rec['routes']}, step mode {rec['step_mode']}")
    if not (tl["onehot_fwd"] == 6 and tl["onehot_bwd"] == 6 and tl["segscan"] == 30 and tl["ftrl_rows"] == 30
            and tl["adagrad_rows"] == 0):
        raise AssertionError(f"FTRL path launches in 6 steps: {tl}")
    if not (el["onehot_fwd"] == 20 and el["onehot_bwd"] == 0 and el["segscan"] == 0 and el["ftrl_rows"] == 0):
        raise AssertionError(f"FTRL path launches in 20 eval batches: {el}")
    graph_ab(torch, model, "ftrl_path")
    return {k: tl[k] + el[k] for k in tl}


def ftrl_dynamic_path(torch):
    """DLRM with FTRL on exact dynamic tables, as one captured program: 6
    steps and eval over 20 batches, then `graph_ab`
    ("ftrl_dynamic_path_graph_ab"), whose four turns from one state must
    leave the key store bitwise equal (`key_store_repeat_equal`: the
    insert's scatter-min does not depend on the order of its writes, eager
    or replayed). No hand-written kernel is on this path: every table is
    dynamic, so none takes the one-hot engine, and the one group of 106,496
    rows takes the dense sweep (the drop-mode scatter)."""
    model, rec = ftrl_run(torch, dynamic=True)
    ab = graph_ab(torch, model, "ftrl_dynamic_path")
    rec["key_store_repeat_equal"] = "table/mp_ev128#keys" not in ab["eager_spread_max"]
    del model
    emit(rec)
    if not all(math.isfinite(x) for x in rec["losses"]):
        raise AssertionError(f"non-finite loss on the dynamic FTRL path: {rec['losses']}")
    if rec["routes"] != FTRL_ROUTES["dynamic"] or rec["step_mode"] != "graph":
        raise AssertionError(f"dynamic FTRL path routes {rec['routes']}, step mode {rec['step_mode']}")
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
    `onehot_fwd` 1 and `onehot_bwd` 1 a step, `segscan` > 0); each kernel
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
    if not (launches == main_rec["launches"] and launches["onehot_fwd"] == 6 and launches["onehot_bwd"] == 6
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
    if any(r["launches"][k] <= 0 for r in ranks for k in (*ONE_CARD_KERNELS, *drop_kernels(rec["routes"]))):
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
    AdaGrad) with lists of 64 rows (the compressed branch taken) and of 2
    (the overflow branch taken), both branches run in each pass and the
    overflow flag selecting on the device (one all_to_all in the forward and
    one in the backward either way), against one card from the same tables
    and batch: outputs
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
    if not (dx[64]["all_to_all_calls"] == [2, 2] and dx[2]["all_to_all_calls"] == [2, 2]
            and all(d["forward_bitwise"] and d["tables_worst_excess"] <= 0 for d in dx.values())):
        raise AssertionError(f"the dense exchange differs from one card: {dx}")
    if not cap_same:
        raise AssertionError("a capacity factor that drops nothing changed the results")


def hybrid_world(torch) -> int:
    """The ranks of the full-width hybrid phases: a card each, at least 2
    (sharing one card over gloo), at most 8."""
    return min(8, max(2, torch.cuda.device_count()))


def hybrid_run(torch, model: str, dynamic: bool = False, world: int = 0, lay=None, ab: str = "", **extra):
    """A full-width model (`tools/hybrid.py::full_width_config`) trained on
    W = `world` ranks (default `hybrid_world`), on the mesh and with the
    settings of `lay` (`hybrid.layout`): 6 steps and a 20-batch eval over
    NCCL with a card per rank, each rank's step captured after the first
    and replayed (`Model.step_mode` "graph"), then with `ab` (a label) the
    captured step against the eager one on every rank
    (`tools/graph_ab.py`); over gloo, W ranks sharing the card(s), 4 steps
    and 4 eval batches, eager, since every collective is staged through the
    host (its ms/step is then no speed number). Counters are set to 0 on
    every rank just before the steps and read just after, and again around
    the eval. Returns (the phase's record, the ranks' results)."""
    from hugectr_tpu_torch.tools import hybrid

    t0 = time.perf_counter()
    w = world or hybrid_world(torch)
    backend = hybrid.default_backend(w)
    if ab and backend == "nccl":
        extra["graph_ab"] = ab
    cfg = dict(hybrid.full_width_config(model, backend == "gloo", B, dynamic, lay), **extra)
    ranks = hybrid.run(hybrid.train_model, w, {"config": json.dumps(cfg)}, backend=backend, timeout=900.0)
    rec = dict(backend=backend, device_count=torch.cuda.device_count(), staged_through_host=backend == "gloo",
               **hybrid.path_summary(ranks, cfg), seconds=time.perf_counter() - t0)
    return rec, ranks


def hybrid_graph_ab(rec, ranks) -> None:
    """The step mode of a hybrid phase on every rank, and its captured step
    against the eager one. Over NCCL every rank must replay its captured
    step ("graph"), and its `graph_ab` run (`hybrid_run`'s `ab`) must hold
    on every rank (`tools/graph_ab.py::failures`: bitwise losses, the
    storage groups' rule, collectives a step equal in both modes, graph
    device-busy ms at most 1.1 x eager's, replays free of host syncs), with
    every array the ranks hold alike bitwise equal across the ranks after
    each turn. Prints rank 0's record and one line over the ranks. Over
    gloo every rank must run "eager: the gloo backend", printed as the
    reason the phase did not capture."""
    from hugectr_tpu_torch.tools import graph_ab as gab

    phase, modes = rec["phase"], rec["step_modes"]
    if rec["backend"] != "nccl":
        emit(dict(phase=f"{phase}_graph_ab", captured=False, step_modes=modes,
                  reason="gloo stages every collective through the host: the steps stay eager"))
        if any(m != "eager: the gloo backend" for m in modes):
            raise AssertionError(f"{phase}: step modes over gloo {modes}")
        return
    recs = [json.loads(r["graph_ab"]) for r in ranks]
    emit(recs[0])
    fails = {r: gab.failures(x) for r, x in enumerate(recs)}
    turns = len(recs[0]["replica_digests"])
    replicas_equal = all(x["replica_digests"][t] == recs[0]["replica_digests"][t] for x in recs for t in range(turns))

    def per_rank(key):
        return [x["traces"][key] for x in recs]

    emit(dict(
        phase=f"{phase}_graph_ab_ranks", card=card_line(), world=len(recs), step_modes=modes,
        losses=[x["losses"] for x in recs], losses_bitwise=[x["losses_bitwise"] for x in recs],
        breaches=[x["breaches"] for x in recs], replicas_equal_across_ranks=replicas_equal,
        ms_per_step={m: [[t["ms_per_step"] for t in x["train"] if t["turn"] == m] for x in recs]
                     for m in ("eager", "graph")},
        collective_calls_per_step=recs[0]["train"][0]["collective_calls_per_step"],
        collective_bytes_per_step=recs[0]["train"][0]["collective_bytes_per_step"],
        **{f"{k}_{m}": [t[k] for t in per_rank(f"{m}_train")] for m in ("eager", "graph")
           for k in ("device_busy_ms_per_step", "compute_busy_ms_per_step", "device_idle_share", "nccl_ms_per_step",
                     "ms_per_step")},
        device_busy_graph_over_eager=[x["device_busy_graph_over_eager"] for x in recs],
        eval_ms_per_batch={m: [[t["ms_per_batch"] for t in x["eval"] if t["turn"] == m] for x in recs]
                           for m in ("eager", "graph")},
        failures=fails, seconds=max(x["seconds"] for x in recs)))
    if any(m != "graph" for m in modes) or any(fails.values()) or not replicas_equal:
        raise AssertionError(f"{phase}: the captured step over the ranks: modes {modes}, failures {fails}, "
                             f"replicas equal {replicas_equal}")


def mp_groups(rec) -> int:
    """The model-parallel rowop groups of a path's record (plan names "mp_")."""
    return sum(1 for g, route in rec["routes"].items() if g.startswith("mp_") and route != "onehot")


def check_path_launches(rec, per_step: dict, eval_fwd: bool = True):
    """Every rank's launches: `per_step` {kernel: n} a step exactly (None:
    at least once in the steps), `onehot_fwd` once a forward (step or
    eval batch: each of these paths has one one-hot group of at most 48
    lookups), the ordered pool once a model-parallel rowop group and
    forward (the owner-partitioned forward), and no backward kernel in
    the eval."""
    steps, eval_batches = rec["steps"], rec["eval_batches"]
    fwd = 1
    per_step = dict(per_step, onehot_fwd=fwd if eval_fwd else 0, ordered_pool=mp_groups(rec))
    for r, (tl, el) in enumerate(zip(rec["launches"], rec["eval_launches"])):
        ok = all(tl[k] > 0 if n is None else tl[k] == n * steps for k, n in per_step.items())
        ok = ok and el["onehot_bwd"] == 0 and el["segscan"] == 0
        ok = ok and el["ordered_pool"] == mp_groups(rec) * eval_batches and mp_groups(rec) > 0
        ok = ok and el["onehot_fwd"] == (fwd * eval_batches if eval_fwd else 0)
        if not ok:
            raise AssertionError(f"{rec['phase']} launches on rank {r}: train {tl}, eval {el}")


def hybrid_path(torch):
    """The full-width flagship (f32, global batch 16,384, rowwise AdaGrad)
    trained hybrid-parallel (`hybrid_run`), at the default owner-partitioned
    forward. Every rank must launch `onehot_fwd` once a step and once an
    eval batch, the ordered pool once a model-parallel group and forward,
    `onehot_bwd` and `segscan` in the steps; losses finite; every
    replicated array bitwise equal across the ranks (SHA-256)."""
    rec, ranks = hybrid_run(torch, "dlrm_dcnv2", ab="hybrid_path")
    rec = dict(phase="hybrid_path", **rec)
    emit(rec)
    if not rec["finite"]:
        raise AssertionError(f"non-finite loss on the hybrid path: {rec['losses']}")
    check_path_launches(rec, {"onehot_bwd": 1, "segscan": None})
    if not rec["replicas_equal"]:
        raise AssertionError("replicated arrays differ across the ranks of the hybrid path")
    hybrid_graph_ab(rec, ranks)
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
    check_path_launches(rec, {"onehot_bwd": 1, "segscan": None})
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
    rec, ranks = hybrid_run(torch, "dlrm_dcnv2", world=4, lay=lay, ab="hybrid_hier_path", kernel_check=True)
    hier, flat = rec["collective_bytes_per_step"], flat_rec["collective_bytes_per_step"]["reduce_scatter"]
    rec = dict(phase="hybrid_hier_path", mesh="(dcn, ici) = (2, 2)", comm_strategy="hierarchical", **rec,
               flat_reduce_scatter_bytes_per_step=flat, dcn_over_flat=hier.get("reduce_scatter_dcn", 0) / flat)
    rec["kernel_parity"] = check_mesh_path(rec, ranks)
    emit(rec)
    if not (hier.get("reduce_scatter_dcn", 0) * 2 == flat == hier.get("reduce_scatter_ici")
            and "reduce_scatter" not in hier):
        raise AssertionError(f"the two-level exchange's bytes: {hier}, flat {flat}")
    hybrid_graph_ab(rec, ranks)
    return [{k: tl[k] + el[k] for k in tl} for tl, el in zip(rec["launches"], rec["eval_launches"])]


def hybrid_column_path(torch):
    """The f32 flagship on `hybrid_world` ranks on the flat mesh with column
    factor 2 on its sorted-route tables 0, 9, 10, 19, 21, 22: each becomes
    sub-tables t#col0, t#col1 of E 64 on the sorted route, so segscan and
    the ordered pool run at E 64 on every rank, each held against its plain
    version on the rank's inputs. Routes, launches, finite losses, replicas
    bitwise."""
    from hugectr_tpu_torch.tools import hybrid

    rec, ranks = hybrid_run(torch, "dlrm_dcnv2", lay=hybrid.layout(column_factor=2), ab="hybrid_column_path",
                            kernel_check=True)
    rec = dict(phase="hybrid_column_path", column_factors={t: 2 for t in hybrid.SORTED_TABLES}, **rec)
    rec["kernel_parity"] = check_mesh_path(rec, ranks)
    emit(rec)
    split = {g: r for g, r in rec["routes"].items() if "#col" in g}
    widths = {s[2] for p in rec["kernel_parity"] for s in p["segscan"]["shapes"]}
    if not (len(split) == 2 * len(hybrid.SORTED_TABLES) and set(split.values()) == {"sorted"}
            and E // 2 in widths):
        raise AssertionError(f"column-split groups and routes: {rec['routes']}, segscan shapes {widths}")
    hybrid_graph_ab(rec, ranks)
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
    state, mixed precision, the hot/cold/superhot split, the caps every
    rank measures on the gathered first batch, the same on every rank)
    trained hybrid-parallel (`hybrid_run`). Every rank launches `onehot_fwd` once a
    step and once an eval batch, `onehot_bwd` once a step (the 20-lookup
    group: 13 tables, 7 superhot tiers), `segscan` in the steps (the 7 cold tiers' owned
    prefixes), the ordered pool once a model-parallel group and forward;
    then each rank holds each kernel against its plain version on its own
    inputs of the step (`tools/hybrid.py::kernel_parity`, `RANK_TOL`; the
    ordered pool bitwise). Losses finite; every replicated array bitwise equal (SHA-256);
    the binned AUC of the eval's buffers within 1e-4 of the exact one."""
    from hugectr_tpu_torch.tools import hybrid

    rec, ranks = hybrid_run(torch, "bench", ab="hybrid_bench_path", kernel_check=True, auc_both=True)
    parity = [hybrid.jsonable(r["kernel_parity"]) for r in ranks]
    caps = [hybrid.jsonable(r["caps"]) for r in ranks]
    rec = dict(phase="hybrid_bench_path", **rec, auc_binned=ranks[0]["auc_binned"], auc_exact=ranks[0]["auc_exact"],
               kernel_parity=parity, caps=caps[0], caps_alike=all(c == caps[0] for c in caps))
    emit(rec)
    if not (rec["caps_alike"] and caps[0].get("valid")):
        raise AssertionError(f"the ranks measured no caps, or different ones: {caps}")
    if not rec["finite"]:
        raise AssertionError(f"non-finite loss on the hybrid bench path: {rec['losses']}")
    check_path_launches(rec, {"onehot_bwd": 1, "segscan": None})
    if not rec["replicas_equal"]:
        raise AssertionError("replicated arrays differ across the ranks of the hybrid bench path")
    for r, p in enumerate(parity):
        if set(p) != set(RANK_TOL) or any(p[k]["scaled_err"] > tol for k, tol in RANK_TOL.items()):
            raise AssertionError(f"a kernel disagrees with its plain version on rank {r}: {p}")
    if not abs(rec["auc_binned"] - rec["auc_exact"]) <= 1e-4:
        raise AssertionError(f"binned AUC {rec['auc_binned']} vs exact {rec['auc_exact']}")
    hybrid_graph_ab(rec, ranks)
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

    rec, ranks = hybrid_run(torch, "dlrm_ftrl", dynamic=True, ab="hybrid_ftrl_dynamic_path")
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
    check_path_launches(rec, {"onehot_bwd": 0, "segscan": 0}, eval_fwd=False)
    if not (overlap == 0 and rec["key_store_repeat_equal"] and rec["replicas_equal"]
            and min(f["mp_ev128"][-1] for f in rec["store_fill"]) > 0):
        raise AssertionError(f"hybrid dynamic FTRL key stores: {rec}")
    hybrid_graph_ab(rec, ranks)


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


def snapshot_run(torch, dynamic: bool, eval_batches: int = 1):
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
                                         synthetic_batches=6, max_eval_batches=eval_batches, seed=seed)
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
    seconds to write and to load and the peak memory. Then, on the same
    model and snapshot, `serving_path`; returns its launches."""
    rec, a, _batches, tmp = snapshot_run(torch, dynamic=False, eval_batches=SERVE_BATCHES)
    emit(rec)
    check_snapshot_run(rec)
    try:
        return serving_path(torch, a, os.path.join(tmp.name, "snap_iter3"), tmp.name)
    finally:
        tmp.cleanup()
        del a


SERVE_BATCHES = 4


def onnx_initializers(onnx_writer, buf: bytes):
    """(dims, ONNX data type, name, raw bytes) of each initializer of an
    ONNX model file (ModelProto.graph = 7, GraphProto.initializer = 5,
    TensorProto dims = 1, data_type = 2, name = 8, raw_data = 9)."""
    graph = next(v for f, _w, v in onnx_writer.decode_fields(buf) if f == 7)
    out = []
    for f, _w, v in onnx_writer.decode_fields(graph):
        if f == 5:
            t = onnx_writer.decode_fields(v)
            out.append((tuple(x for g, _w2, x in t if g == 1), next(x for g, _w2, x in t if g == 2),
                        next(x for g, _w2, x in t if g == 8).decode(), next(x for g, _w2, x in t if g == 9)))
    return out


def serving_path(torch, model, snap_dir: str, tmp_dir: str):
    """The serving path at full width: the trained static DLRM-FTRL (26
    tables, ev 128, Reshape, Interaction, MLPs 512/256/128 and
    1024/1024/512/256/1) and its snapshot. `graph_to_json`; the trained
    model, set back to the snapshot's state, and its own eval predictions
    on its SERVE_BATCHES cached eval batches;
    the model rebuilt from the graph file and the snapshot as `predict`
    rebuilds it (`construct_from_json`, `load_params_from_files`), timed;
    `predict` over SERVE_BATCHES batches of the same seeded eval source,
    the launch counts set to 0 just before and read just after. The eval
    forward has no atomics, so the predictions must be bitwise the trained
    model's; where they are not, the largest relative difference is
    printed with the reason and held at 1e-6. Then `convert` of the
    snapshot without the tables (`convert_embedding=True` would inline
    3.4 GB of tables, past protobuf's 2 GB): every float initializer
    bitwise one of `dense_model.npz`'s arrays, one for one. Returns the
    launches."""
    import numpy as np

    from hugectr_tpu_torch import ops
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.model.model import Model
    from hugectr_tpu_torch.tools import hugectr2onnx, onnx_writer
    from hugectr_tpu_torch.tools.predict import predict

    t0 = time.perf_counter()
    graph = os.path.join(tmp_dir, "graph.json")
    model.graph_to_json(graph)
    model.load_params_from_files(snap_dir)  # `snapshot_run` trained it on past the snapshot
    source, _feeder, _fed = model._eval_batches()
    want = torch.cat([model._eval_step(b)[1]["label"] for b in source]).cpu()
    torch.cuda.synchronize()
    t = time.perf_counter()
    served = Model.construct_from_json(graph, reader_params=model.reader_params,
                                       resource_manager=ResourceManager.create())
    served.load_params_from_files(snap_dir)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    ops.reset_counts()
    t = time.perf_counter()
    preds = predict(graph, snap_dir, model.reader_params, max_batches=SERVE_BATCHES, model=served)["label"]
    predict_s = time.perf_counter() - t
    launches = ops.launch_counts()
    got = torch.from_numpy(preds)
    bitwise = tuple(got.shape) == tuple(want.shape) and bool(torch.equal(got, want))
    rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max()) if got.shape == want.shape else math.inf
    del served
    t = time.perf_counter()
    onnx_path = os.path.join(tmp_dir, "dense.onnx")
    # a Reshape's shape needs a fixed batch in both packages' converters
    hugectr2onnx.convert(onnx_path, graph, snap_dir, convert_embedding=False, batch_size=B)
    convert_s = time.perf_counter() - t
    with open(onnx_path, "rb") as f:
        buf = f.read()
    inits = onnx_initializers(onnx_writer, buf)
    dense = np.load(os.path.join(snap_dir, "dense_model.npz"))
    want_arrays = sorted((a.shape, a.tobytes()) for k, a in dense.items() if k.startswith("dense/"))
    got_arrays = sorted((dims, raw) for dims, code, _name, raw in inits if code == 1)  # FLOAT
    rec = dict(phase="serving_path", card=card_line(), tables=26, ev=E, batch=B, batches=SERVE_BATCHES,
               rows=int(preds.shape[0]), predict_seconds=predict_s, predict_ex_per_s=preds.shape[0] / predict_s,
               rebuild_and_load_seconds=load_s, launches=launches, plain_calls=ops.plain_counts(),
               bitwise_equal_to_trained_eval=bitwise, max_rel_diff=rel, finite=bool(np.isfinite(preds).all()),
               onnx_bytes=len(buf), onnx_convert_seconds=convert_s, onnx_initializers=len(inits),
               onnx_float_initializers=len(got_arrays), dense_arrays=len(want_arrays),
               onnx_initializers_bitwise=got_arrays == want_arrays, seconds=time.perf_counter() - t0)
    if not bitwise:
        rec["why_not_bitwise"] = ("the rebuilt model's eval forward differs from the trained model's in "
                                  "summation order (a different plan or kernel route)")
    emit(rec)
    if not (rec["finite"] and rec["rows"] == SERVE_BATCHES * B and (bitwise or rel <= 1e-6)
            and rec["onnx_initializers_bitwise"] and len(want_arrays) > 0):
        raise AssertionError(f"serving_path: predictions or ONNX initializers disagree: {rec}")
    if not (launches["onehot_fwd"] == SERVE_BATCHES and launches["onehot_bwd"] == launches["segscan"] == 0):
        raise AssertionError(f"serving_path: the sweep did not launch onehot_fwd once a batch: {launches}")
    return launches


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
    2 eager steps (frozen tables are not captured) in which `onehot_bwd`
    launches once a step for the group's 12 live lookups (the frozen one
    gets no descriptor) and table 20's group hands segscan and `ftrl_rows`
    a device count of 0 (the counted route: the valid keys less the frozen
    slots; both launch and do nothing), the frozen rows and dense weights bitwise unchanged
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
    # the second is the count of a group on the sorted route
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
    sparse_optimizer.segmented_sum_sorted = lambda v, h, dt, count, rowsrc: ks.append(int(count)) or scan(
        v, h, dt, count, rowsrc)
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
    if not (launches["onehot_fwd"] == 2 and launches["onehot_bwd"] == 2 and n_onehot == 13
            and launches["segscan"] == launches["ftrl_rows"] == 2 * len(sorted_groups)
            and unfrozen_launches["onehot_bwd"] == 1):
        raise AssertionError(f"freeze_path launches: {rec}")
    if ks != want_ks or 0 not in want_ks:
        raise AssertionError(f"freeze_path segscan counts: {ks} against {want_ks}")
    if not (frozen_same and dense_same and others_moved and rec["frozen_rows_moved_after_unfreeze"]
            and rec["dense_moved_after_unfreeze"] and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"freeze_path: {rec}")
    if not (parity["onehot_fwd"]["scaled_err"] <= TOL["float32"] and parity["onehot_bwd"]["scaled_err"] <= TOL["float32"]
            and parity["segscan"]["scaled_err"] <= TOL["float32"]
            and parity["onehot_bwd"]["shapes"] == [[B, n_onehot - 1]]):
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
    `embedding_bag(per_sample_weights=)`; the grouped backward of that tier
    (global route) and of a privatised shape (V 108, h 40) beside
    `index_add_` of the w-scaled cotangents (counts: the sums of |w|,
    touched rows exact);
    segscan over the untiered sorted route's per-key rows (K = 16,384 x 20);
    and the ordered pool of rank 0's shapes of the tiered table over the
    hybrid phases' W ranks (bitwise) beside `embedding_bag(per_sample_weights=)`
    over its owned rows. Then a weighted row whose weights cancel (+1, -1 in
    two samples) is touched and its gradient is exact, and a row that one
    sample holds twice with weights +w and -w is not touched (count exactly
    0) on the privatised and the global backward."""
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
        # the weighted backward, one-lookup groups: the superhot tier (global
        # atomics) on the raw keys and a privatised shape (V 108, h 40)
        rng = np.random.default_rng(29)
        k108 = torch.as_tensor(power_law(rng, 108, (B, 40)).astype(np.int32), device=dev)
        w108 = torch.as_tensor(rng.standard_normal((B, 40), dtype=np.float32), device=dev)
        d = d32.to(dt)
        bwd_group_case(torch, oh, dev, results, "weighted_superhot_V1024_h20", [keys], lks, d, g.total_local_rows,
                       E, [w])
        bwd_group_case(torch, oh, dev, results, "weighted_V108_h40", [k108], [oh.GroupLookup(0, 108, 0, False)], d,
                       108, E, [w108])
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
        slot_ids = torch.repeat_interleave(torch.arange(n, device=dev), lens)
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
                   index_add_ms=time_ms(lambda: torch.zeros((n, E), dtype=torch.bfloat16, device=dev).index_add_(
                       0, slot_ids, table[owned] * wo.unsqueeze(1))),
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
    # one sample holds row 7 twice with weights +0.75 and -0.75 (and no other
    # sample holds it): the JAX package's count sum_b |sum_h w| leaves the row
    # untouched, on the privatised route and on the global atomics alike
    routes = set()
    for case, kk, ww, v in (("weighted_in_sample_cancel_V108_h40", k108, w108, 108),
                            ("weighted_in_sample_cancel_V1024_h20", k_rel, w, lk.vocab)):
        kk, ww = kk.clone(), ww.clone()
        kk[kk == 7] = 8
        kk[0, :2] = 7
        ww[0, :2] = torch.tensor([0.75, -0.75], device=dev)
        grad, cnt = oh.onehot_matmul_bwd(kk, d32, v, torch.float32, weights=ww)
        want_g, want_c = oh.onehot_matmul_bwd_plain(kk, d32, v, torch.float32, weights=ww)
        scale_g, _ = oh.onehot_matmul_bwd_plain(kk, d32.abs(), v, torch.float32, weights=ww.abs())
        route = oh.bwd_route(B, int(kk.shape[1]), v, E, dev, weighted=True)
        routes.add(route)
        rec = dict(kernel="onehot_bwd", case=case, route=route, touch_count=float(cnt[7]),
                   grad_row_abs_sum=float(grad[7].abs().sum()), touched_exact=bool(torch.equal(cnt > 0, want_c > 0)),
                   counts_rel_err=float(((cnt - want_c).abs() / want_c.clamp(min=1e-30)).max()),
                   scaled_err=scaled_err(grad, want_g, scale_g), tol=TOL["float32"])
        emit(rec)
        if not (rec["touch_count"] == 0.0 and float(want_c[7]) == 0.0 and rec["grad_row_abs_sum"] == 0.0
                and rec["touched_exact"] and rec["counts_rel_err"] <= TOL["float32"]
                and rec["scaled_err"] <= TOL["float32"]):
            raise AssertionError(f"a row whose weights cancel within one sample is touched: {rec}")
    if routes != {"privatised", "global"}:
        raise AssertionError(f"the in-sample cancel cases did not cover both backward routes: {routes}")


LAYER_B = 2048  # the samples' batch (samples/common.py:26)
# GRU and MatrixMultiply at DIN's history widths: 10 steps of two 18-wide
# embeddings (samples/din.py:13-14)
GRU_SEQ, GRU_V, GRU_H = 10, 36, 36


def layer_cases(np, rng):
    """(name, DenseLayer fields, inputs, indices of the inputs that take a
    gradient) of `layers_parity`, at batch LAYER_B."""
    b = LAYER_B
    x512 = lambda: rng.standard_normal((b, 512), dtype=np.float32)  # noqa: E731
    perm = rng.permutation(b).tolist()
    return [
        ("sigmoid", dict(layer_type="Sigmoid"), [x512() * 2], [0]),
        ("elu", dict(layer_type="ELU", elu_alpha=0.7), [x512() * 2], [0]),
        ("cast", dict(layer_type="Cast"), [x512()], [0]),
        ("masked_softmax", dict(layer_type="MaskedSoftmax", factor=0.125),
         [rng.standard_normal((b, 1, 10, 10), dtype=np.float32) * 3,
          (rng.random((b, 1, 10, 10)) < 0.7).astype(np.float32)], [0]),
        ("select", dict(layer_type="Select", dim=1, index=[0, 3, 9, 3]),
         [rng.standard_normal((b, 10, 36), dtype=np.float32)], [0]),
        ("gather", dict(layer_type="Gather", indices=perm), [rng.standard_normal((b, 36), dtype=np.float32)], [0]),
        ("fused_reshape_concat_general", dict(layer_type="FusedReshapeConcatGeneral"),
         [rng.standard_normal((b, 10, 18), dtype=np.float32) for _ in range(2)], [0, 1]),
        ("batch_norm", dict(layer_type="BatchNorm", factor=0.1), [x512() * 3 + 1], [0]),
        ("fused_inner_product", dict(layer_type="FusedInnerProduct", num_output=256), [x512()], [0]),
        ("matrix_multiply", dict(layer_type="MatrixMultiply"),
         [rng.standard_normal((b, 10, 36), dtype=np.float32), rng.standard_normal((b, 36, 10), dtype=np.float32)],
         [0, 1]),
        ("matrix_multiply_transpose_b", dict(layer_type="MatrixMultiply", transpose_b=True),
         [rng.standard_normal((b, 10, 36), dtype=np.float32), rng.standard_normal((b, 10, 36), dtype=np.float32)],
         [0, 1]),
        ("gru", dict(layer_type="GRU", num_output=GRU_H, SeqLength=GRU_SEQ, vector_size=GRU_V),
         [rng.standard_normal((b, GRU_SEQ * GRU_V), dtype=np.float32)], [0]),
        ("mlp_elu_gelu", dict(layer_type="MLP", num_outputs=[256, 128], activations=["elu", "gelu"]), [x512()], [0]),
    ]


def parity_err(torch, got, want):
    """(max |got - want| / the compared array's max |want| (1 if smaller),
    max |got - want| - (1e-5 scale + 1e-4 |want|) over the elements):
    the scaled error and, for float32, the worst excess over rtol 1e-4 /
    atol 1e-5 of the array's scale."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    scale = max(float(want.abs().max()), 1.0)
    diff = (got - want).abs()
    return float(diff.max()) / scale, float((diff - (1e-5 * scale + 1e-4 * want.abs())).max())


def layers_graph_model(torch, rm, batch: int = LAYER_B):
    """A graph with the eleven layers' stateful and recurrent members:
    GRU over the dense input (DIN's history widths), concatenated with one
    embedding, BatchNorm, a GELU MLP, an InnerProduct logit and BCE with an
    L2 regularizer; SGD (AdaGrad would turn gradients that are rounding
    noise into lr-sized steps), synthetic batches."""
    import hugectr_tpu_torch as h

    L = h.Layer_t
    solver = h.CreateSolver(max_eval_batches=1, batchsize_eval=batch, batchsize=batch, lr=0.05,
                            repeat_dataset=True)
    reader = h.DataReaderParams(data_reader_type=h.DataReaderType_t.Synthetic, synthetic_num_batches=3)
    model = h.Model(solver, reader, h.CreateOptimizer(optimizer_type=h.Optimizer_t.SGD), resource_manager=rm)
    model.add(h.Input(label_dim=1, label_name="label", dense_dim=GRU_SEQ * GRU_V, dense_name="dense",
                      data_reader_sparse_param_array=[h.DataReaderSparseParam("d0", 1, True, 2)]))
    ebc = h.EmbeddingCollectionConfig()
    ebc.embedding_lookup([h.EmbeddingTableConfig(name="t0", max_vocabulary_size=1000, ev_size=16)], ["d0"], "emb",
                         ["sum"])
    ebc.shard(shard_matrix=[["t0"]], shard_strategy=[("mp", ["t0"])])
    model.add(ebc)
    model.add(h.DenseLayer(layer_type=L.GRU, bottom_names=["dense"], top_names=["gru"], num_output=GRU_H,
                           SeqLength=GRU_SEQ, vector_size=GRU_V))
    model.add(h.DenseLayer(layer_type=L.Concat, bottom_names=["gru", "emb"], top_names=["c"]))
    model.add(h.DenseLayer(layer_type=L.BatchNorm, bottom_names=["c"], top_names=["bn"], factor=0.1))
    model.add(h.DenseLayer(layer_type=L.MLP, bottom_names=["bn"], top_names=["m"], num_outputs=[64],
                           act_type=h.Activation_t.Gelu))
    model.add(h.DenseLayer(layer_type=L.InnerProduct, bottom_names=["m"], top_names=["logit"], num_output=1))
    model.add(h.DenseLayer(layer_type=L.BinaryCrossEntropyLoss, bottom_names=["logit", "label"],
                           top_names=["loss"], use_regularizer=True, regularizer_type="l2", lambda_=0.01))
    model.compile()
    return model


def layers_parity(torch):
    """Card against CPU at batch 2,048 (`layer_cases`): each layer built
    once on the CPU and copied to the card, the same seeded inputs in the
    compute dtype, forward and the gradients of sum(out * r) for every
    float input and parameter (BatchNorm's running statistics after the
    training forward too), float32 held at rtol 1e-4 / atol 1e-5 of the
    array's scale and bfloat16 at 1e-2 scaled error; both regularizers'
    values and gradients over the MLP's parameters; then
    `layers_graph_model` 3 steps on the card and on the CPU from the CPU
    model's state: losses rtol 1e-4, dense parameters and the running
    statistics at the float32 tolerance."""
    import copy

    import numpy as np

    from hugectr_tpu_torch.core import config as tcfg
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.layers.base import LAYER_REGISTRY
    from hugectr_tpu_torch.layers.losses import regularizer_term
    from hugectr_tpu_torch.tools.carry import export_state, load_jax_state

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cpu = torch.device("cpu")
    rng = np.random.default_rng(41)
    cases = []
    for name, fields, inputs, grad_idx in layer_cases(np, rng):
        shapes = [x.shape for x in inputs]
        cfg = tcfg.DenseLayer(bottom_names=[f"x{i}" for i in range(len(inputs))], top_names=["y"], **fields)
        base = LAYER_REGISTRY[cfg.layer_type](cfg, shapes, torch.Generator().manual_seed(5), cpu)
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[1]
            outs, grads = [], []
            for d in (cpu, dev):
                layer = copy.deepcopy(base).to(d).train()
                xs = [torch.from_numpy(x).to(d).to(dt if i in grad_idx else torch.float32).requires_grad_(i in grad_idx)
                      for i, x in enumerate(inputs)]
                (y,) = layer(xs, dt)
                r = torch.from_numpy(np.random.default_rng(7).standard_normal(tuple(y.shape), dtype=np.float32)).to(d)
                (y.float() * r).sum().backward()
                outs.append([y] + [getattr(layer, k) for k in getattr(layer, "state_keys", ())])
                grads.append([xs[i].grad for i in grad_idx] + [p.grad for _n, p in sorted(layer.named_parameters())])
            errs = [parity_err(torch, g, w) for g, w in zip(outs[1] + grads[1], outs[0] + grads[0])]
            scaled = max(e[0] for e in errs)
            excess = max(e[1] for e in errs)
            ok = excess <= 0.0 if dt == torch.float32 else scaled <= TOL["bfloat16"]
            cases.append(dict(layer=name, dtype=dname, compared=len(errs), scaled_err=scaled,
                              f32_excess=excess if dt == torch.float32 else None, ok=ok))
    # the regularizers over an MLP's parameters, values and gradients
    base = LAYER_REGISTRY["MLP"](tcfg.DenseLayer(layer_type="MLP", bottom_names=["x"], top_names=["y"],
                                                 num_outputs=[256, 128]), [(LAYER_B, 512)],
                                 torch.Generator().manual_seed(6), cpu)
    for reg in ("l1", "l2"):
        vals, grads = [], []
        for d in (cpu, dev):
            layer = copy.deepcopy(base).to(d)
            ps = [p for _n, p in sorted(layer.named_parameters())]
            v = regularizer_term(reg, 0.01, LAYER_B, ps)
            v.backward()
            vals.append(v)
            grads.append([p.grad for p in ps])
        errs = [parity_err(torch, g, w) for g, w in zip([vals[1]] + grads[1], [vals[0]] + grads[0])]
        cases.append(dict(layer=f"regularizer_{reg}", dtype="float32", compared=len(errs),
                          scaled_err=max(e[0] for e in errs), f32_excess=max(e[1] for e in errs),
                          ok=max(e[1] for e in errs) <= 0.0))
    # 3 steps of the graph, card against CPU from one state
    cm = layers_graph_model(torch, ResourceManager.create(device="cpu"))
    gm = layers_graph_model(torch, ResourceManager.create())
    load_jax_state(gm, export_state(cm))
    cl = [cm.train() for _ in range(3)]
    gl = [gm.train() for _ in range(3)]
    cs, gs = export_state(cm), export_state(gm)
    errs = {}
    for key in ("dense_params", "net_state"):
        for layer, ps in cs[key].items():
            for k, v in ps.items():
                errs[f"{layer}/{k}"] = parity_err(torch, torch.from_numpy(gs[key][layer][k]), torch.from_numpy(v))
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(gl, cl))
    worst_key = max(errs, key=lambda k: errs[k][1])
    graph = dict(losses_card=gl, losses_cpu=cl, loss_max_rel_diff=loss_rel, compared=len(errs),
                 f32_excess=errs[worst_key][1], worst=worst_key, net_state=sorted(cs["net_state"]))
    rec = dict(phase="layers_parity", card=card_line(), batch=LAYER_B, cases=cases, graph=graph,
               seconds=time.perf_counter() - t0)
    emit(rec)
    bad = [c for c in cases if not c["ok"]]
    if bad or loss_rel > 1e-4 or graph["f32_excess"] > 0.0 or not graph["net_state"]:
        raise AssertionError(f"layers_parity: the card disagrees with the CPU: {bad or graph}")


def cache_path(torch):
    """`UvmTable` over a host master of 2,000,000 x 128 float32 rows
    (seeded normal values, keys 0..1,999,999) with a 131,072-entry device
    cache of 8 ways, queried with 20 power-law batches of 16,384 x 20 keys
    (the weighted bench's shape, alpha 1.05): every returned row bitwise
    the master's row, the hit rate of each batch and the host ms of each
    query (it returns host arrays, so the device work is in it). Then one
    `EmbeddingCache` sequence (64 sets of 8 ways, ev 16: replace batches
    with a repeated key and more keys a set than ways, queries, an update
    with a repeat and a miss), the card's state after every call bitwise
    the CPU's."""
    import numpy as np

    from hugectr_tpu_torch.cache.embedding_cache import EmbeddingCache, UvmTable

    t0 = time.perf_counter()
    rows, ev, cap, ways, batches = 2_000_000, 128, 131_072, 8, 20
    rng = np.random.default_rng(53)
    master = rng.standard_normal((rows, ev), dtype=np.float32)
    table = UvmTable(np.arange(rows, dtype=np.int64), master, cache_capacity=cap, ways=ways)
    build_s = time.perf_counter() - t0
    hit_rates, ms, exact = [], [], True
    for _ in range(batches):
        keys = power_law(rng, rows, (B, 20)).reshape(-1).astype(np.int64)
        h0 = table.hits
        t = time.perf_counter()
        out, found = table.query(keys)
        ms.append((time.perf_counter() - t) * 1e3)
        hit_rates.append((table.hits - h0) / keys.size)
        exact = exact and bool(found.all()) and bool(np.array_equal(out, master[keys]))
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    caches = {"cpu": EmbeddingCache(64, 8, 16, device=cpu), "card": EmbeddingCache(64, 8, 16, device=dev)}
    states = {k: c.init() for k, c in caches.items()}
    state_equal = True
    for i in range(6):
        keys = rng.integers(0, 2000, 700)
        keys[5] = keys[9]
        vals = rng.standard_normal((700, 16), dtype=np.float32)
        q = rng.integers(0, 2000, 500)
        upd = np.concatenate([keys[:50], keys[:3], [10**6]])
        uvals = rng.standard_normal((len(upd), 16), dtype=np.float32)
        for k, c in caches.items():
            st = c.replace(states[k], torch.from_numpy(keys), torch.from_numpy(vals))
            _v, _h, st = c.query(st, torch.from_numpy(q))
            states[k] = c.update(st, torch.from_numpy(upd), torch.from_numpy(uvals))
        state_equal = state_equal and all(torch.equal(states["card"][n].cpu(), states["cpu"][n]) for n in states["cpu"])
    rec = dict(phase="cache_path", card=card_line(), host_rows=rows, ev=ev, cache_entries=cap, ways=ways,
               batch_keys=B * 20, batches=batches, build_seconds=build_s, hit_rate=hit_rates,
               query_ms=ms, query_ms_median=statistics.median(ms), rows_bitwise_master=exact,
               hits=table.hits, misses=table.misses, cache_state_bitwise_cpu=state_equal,
               seconds=time.perf_counter() - t0)
    emit(rec)
    if not (exact and state_equal and hit_rates[-1] > hit_rates[0]):
        raise AssertionError(f"cache_path: a row or the cache state disagrees: {rec}")


WEIGHTED_STEPS = 6


def weighted_case(results, name: str, weighted_launches):
    """A kernel's weighted case for the `kernels` line: the bf16 case (the
    weighted path's type) with the most device time, and its launches on
    `weighted_path` (the tiered run's weighted launches of the one-hot
    kernels; segscan's on the untiered run, on the per-key rows)."""
    r = max((x for x in results if x["kernel"] == name and x.get("weighted") and x["dtype"] == "bfloat16"
             and not x["case"].startswith("chunked")), key=lambda x: x["device_ms"])
    out = {k: r[k] for k in ("case", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")}
    if weighted_launches is not None:
        out["launches"] = (weighted_launches["untiered"]["launches"][name] if name == "segscan"
                           else weighted_launches["tiered"]["weighted"][name])
    return out


def weighted_path(torch):
    """The repo's weighted configuration at full width, as
    `hugectr_tpu_torch/benchmarks/weighted_bench.py` runs it (the case of
    benchmarks/weighted_bench.py:30-37: one 2,000,000-row weighted Sum
    table, ev 128, hotness 20, batch 16,384, bf16 tables, rowwise AdaGrad,
    weights uniform in [0, 1) from the seed), untiered and tiered (hot
    131,072 / split vocab 16,384 / superhot 1,024), cut from the bench's 3
    warm-up and 20 timed steps to none and 6. Counters set to 0 just before
    the steps and read just after: untiered, segscan on the per-key rows
    (K = 16,384 x 20) once a step; tiered, the weighted one-hot forward and
    backward once a step each and segscan for the cold tier; no plain
    version. Reports median ms/step of steps 2-6, ex/s, routes, launches a
    step, peak memory and the card. The collection measures its caps on the
    batch as the bench does (auto, headroom 1.05): the tiered run's tiers
    with a valid cap pool by the weighted ordered pool."""
    from hugectr_tpu_torch import ops
    from hugectr_tpu_torch.benchmarks import weighted_bench
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools import weighted as wt

    rm = ResourceManager.create()
    out = {}
    for tiers in (False, True):
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run = weighted_bench.run_case(rm, tiers, steps=WEIGHTED_STEPS, warmup=0, before_timed=ops.reset_counts)
        lc, wc, pc = ops.launch_counts(), ops.weighted_counts(), ops.plain_counts()
        ec = run["ec"]
        with torch.no_grad():
            pooled = ec.forward(run["tables"], {"f": run["keys"]}, {"w": run["w"]})["e"]
        bench = run["record"]
        rec = dict(phase="weighted_path", tiers=tiers, card=card_line(), source=WEIGHTED_SOURCE,
                   table_rows=wt.VOCAB, ev=wt.EV, hotness=wt.HOT, batch=B, dtype="bfloat16",
                   optimizer="rowwise_adagrad", caps=caps_line(ec),
                   reduced=dict(warmup=[weighted_bench.WARMUP, 0], steps=[weighted_bench.STEPS, WEIGHTED_STEPS]),
                   groups=bench["groups"], routes=bench["routes"], step_ms=bench["step_ms"],
                   median_ms_per_step=bench["median_ms_per_step"],
                   examples_per_s=B / (bench["median_ms_per_step"] / 1e3),
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
        del run, ec
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


HOST_TIER = dict(batch=4096, capacity=131072, ev=64, hotness=5)  # benchmarks/host_spill_bench.py:116-121


def host_tier_path(torch):
    """The host-spill tier as `hugectr_tpu_torch/benchmarks/host_spill_bench.py`
    runs it, at benchmarks/host_spill_bench.py:116-121's settings (batch
    4,096, a dynamic table of 131,072 rows, ev 64, hotness 5, bf16,
    AdaGrad), cut from the bench's 40 timed steps a phase and 5 and 40
    warm-up steps to 20, and 20 and 24: without a tier on keys below the
    capacity, then with `HostSpillTier` on a power-law stream over 4x the
    capacity (each step stages the batch's master rows first, spilling the
    least recently used half under the 0.75 watermark): ex/s of each (host
    clock up to a synchronisation), rows staged a step, the master's size.
    Then one `EmbeddingTrainingCache` pass over a 64-row staging table of a
    20,000-row master: stage, map, one step, flush (touched rows changed,
    others bitwise)."""
    import numpy as np

    from hugectr_tpu_torch.benchmarks import host_spill_bench
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.embedding.training_cache import EmbeddingTrainingCache

    t0 = time.perf_counter()
    hs = HOST_TIER
    rm = ResourceManager.create()
    run = host_spill_bench.run(rm, **hs, steps=20, warm_spill=20, ref_warm=20)
    bench, model, tier = run["record"], run["model"], run["tier"]
    g, ti = model.ec._find_table("dyn")
    resident = int((model.tables[f"{g.name}#keys"] != model.ec.EMPTY_KEY).sum())
    model._close_readers()
    del model, run
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
    loss_ref, loss_tier = bench["losses"]
    rec = dict(phase="host_tier_path", card=card_line(), **hs, dtype="bfloat16", source="benchmarks/host_spill_bench.py",
               reduced=dict(steps=[40, 20], warmup_steps=[[5, 40], bench["warmup_steps"]]),
               steps=20, warmup_steps=bench["warmup_steps"], no_tier_examples_per_s=bench["no_tier_examples_per_sec"],
               tier_examples_per_s=bench["tier_examples_per_sec"], tier_over_no_tier=bench["tier_over_no_tier"],
               staged_rows_per_step=bench["staged_rows_per_step"], staged_rows_max=bench["staged_rows_max"],
               spills=bench["spills"], host_size=tier.host_size, device_resident=resident,
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


FULLSCALE_ROWS = 204_184_588  # MLPERF_TABLE_SIZES uncapped: five 40,000,000-row tables
FULLSCALE_ARGV = ["--steps", "6", "--eval-batches", "4"]
FAR_KEYS = 64


def fullscale_tier(model, table: str = "0"):
    """(group, lookup, storage offset) of `table`'s cold tier."""
    for g in model.ec.plan.groups:
        for lm in g.lookups:
            if g.tables[lm.table_index].name == f"{table}::cold":
                return g, lm, int(g.local_offsets[lm.table_index])
    raise AssertionError(f"table {table} has no cold tier")


def fullscale_pick(torch, np, model, row_min: int):
    """Before step 1: stage the step's batch, take FAR_KEYS keys of table
    0's cold tier whose storage rows are at `row_min` or above that the
    step touches and FAR_KEYS such keys that it does not, and copy their
    rows."""
    g, lm, off = fullscale_tier(model)
    first = row_min - off + lm.key_lo  # the first key whose row is at row_min
    model.read_a_batch()
    keys = model._decode_batch(model._staged_train_batch)["data0"]
    k = np.unique(keys.cpu().numpy().astype(np.int64))
    far = k[(k >= first) & (k < lm.key_hi)]
    rng = np.random.default_rng(7)
    if far.size < FAR_KEYS:
        raise AssertionError(f"step 1 touches {far.size} keys of table 0 past row {row_min}, not {FAR_KEYS}")
    touched = np.sort(rng.choice(far, FAR_KEYS, replace=False))
    untouched = np.setdiff1d(rng.integers(first, lm.key_hi, 16 * FAR_KEYS), k)[:FAR_KEYS]
    table = model.tables[g.name]
    dev = table.device

    def rows(ks):
        return torch.as_tensor(ks - lm.key_lo + off, dtype=torch.int64, device=dev)

    return dict(group=g.name, key_lo=lm.key_lo, off=off, rows=rows, touched=touched, untouched=untouched,
                before_t=table[rows(touched)].clone(), before_u=table[rows(untouched)].clone(),
                n_far=int(far.size), n_keys=int(keys.numel()), n_unique=int(k.size))


def fullscale_rows_check(torch, np, model, st):
    """After step 1: the touched rows changed, the untouched ones are
    bitwise as before, and the pooled forward of a batch of these keys
    alone equals the sum of their rows copied to the host."""
    table = model.tables[st["group"]]
    rows = st["rows"]
    after_t, after_u = table[rows(st["touched"])], table[rows(st["untouched"])]
    changed = int((after_t != st["before_t"]).any(dim=1).sum())
    unchanged = bool(torch.equal(after_u, st["before_u"]))
    model.read_a_batch()  # step 2's batch: every other feature's keys
    fk = model._feature_keys(model._decode_batch(model._staged_train_batch))
    pool = np.concatenate([st["touched"], st["untouched"]])
    k0 = fk["sparse_embedding:0"]
    rng = np.random.default_rng(8)
    pick = rng.choice(pool, size=tuple(k0.shape))
    fk = dict(fk, **{"sparse_embedding:0": torch.as_tensor(pick, dtype=k0.dtype, device=k0.device)})
    with torch.no_grad():
        got = model.ec.forward(model.tables, fk)["sparse_embedding:0"].double().cpu()
    host = table[rows(pool)].double().cpu()  # the rows of the 128 keys, on the host
    idx = torch.as_tensor(np.searchsorted(np.sort(pool), pick))
    order = torch.as_tensor(np.argsort(pool))
    vecs = host[order][idx]  # [B, h, E]
    want, scale = vecs.sum(dim=1), vecs.abs().sum(dim=1)
    err = scaled_err(got, want, scale)
    e = table.shape[1]
    return dict(touched_changed=changed, untouched_bitwise=unchanged, forward_scaled_err=err,
                min_row=int(rows(pool).min()), min_element=int(rows(pool).min()) * e,
                storage_elements=int(table.numel()), keys_past=st["n_far"], table0_keys=st["n_keys"],
                table0_unique=st["n_unique"])


def fullscale_child(argv=None, row_min: int = 0, rows_expected: int = FULLSCALE_ROWS, overrides=None) -> int:
    """The `fullscale_path` phase's child process: the tool's entry
    function with `FULLSCALE_ARGV`, then the checks on the model it built;
    prints one JSON line. `row_min` (default: the first row whose elements
    lie past 2^31), `rows_expected` and the tool's `overrides` let a
    rehearsal run it small."""
    import numpy as np
    import torch

    from hugectr_tpu_torch.tools import fullscale_dryrun as fs

    st, past = {}, {}

    def hook(model, i):
        if i == 1:
            st.update(fullscale_pick(torch, np, model, row_min or 2**31 // model.ec.plan.groups[0].ev_size))
        elif i == 2:
            past.update(fullscale_rows_check(torch, np, model, st))

    t0 = time.perf_counter()
    model, rec = fs.run(argv or FULLSCALE_ARGV, overrides=overrides, step_hook=hook,
                        say=lambda *a, **k: print(*a, file=sys.stderr, **k))
    launches = {k: sum(x[k] for x in rec["launches"]) for k in rec["launches"][0]}
    alloc, calc = rec["allocated"], rec["calculator"]
    big = [fullscale_tier(model, t)[0].name for t in ("0", "9", "19", "20", "21")]
    out = dict(phase="fullscale_path", **{k: v for k, v in rec.items() if k != "launches"},
               launches=launches, launches_per_step=rec["launches"], past_2_31=past, big_tier_groups=big,
               ms_per_step=rec["median_ms_per_step"], step_mode=model.step_mode,
               captured=sorted(model._graphs), seconds=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)
    fails = []
    if rec["rows_total"] != rows_expected:
        fails.append(f"rows total {rec['rows_total']}, not {rows_expected}")
    if alloc["tables"] != alloc["plan_tables"] or calc["weights"] != alloc["tables"]:
        fails.append(f"table bytes {alloc['tables']}, plan {alloc['plan_tables']}, calculator {calc['weights']}")
    if calc["state"] != alloc["state"]:
        fails.append(f"state bytes {alloc['state']}, calculator {calc['state']}")
    if not all(math.isfinite(x) for x in rec["losses"]):
        fails.append(f"non-finite losses {rec['losses']}")
    missing = [k for k in ONE_CARD_KERNELS if launches[k] <= 0]
    if missing or any(x["onehot_fwd"] != 1 for x in rec["launches"]):
        fails.append(f"kernels never launched {missing} or onehot_fwd not once a step: {rec['launches']}")
    if any(rec["routes"].get(g) != "sorted" for g in big):
        fails.append(f"the 40M-row cold tiers' routes: {[rec['routes'].get(g) for g in big]}")
    if not (rec["caps"]["valid"] and rec["caps"]["unique"]):
        fails.append(f"no caps measured: {rec['caps']}")
    if not (past.get("touched_changed") == FAR_KEYS and past.get("untouched_bitwise")
            and past.get("forward_scaled_err", math.inf) <= TOL["bfloat16"]):
        fails.append(f"rows past row {row_min or 'the 2^31st element'}: {past}")
    if rec["max_memory_allocated"] is not None and rec["max_memory_allocated"] >= 80e9:
        fails.append(f"peak memory {rec['max_memory_allocated']}")
    if rec["max_memory_allocated"] is not None and (model.step_mode != "graph" or "train" not in model._graphs):
        fails.append(f"step mode {model.step_mode}, captured {sorted(model._graphs)}")
    if fails:
        print("; ".join(fails), file=sys.stderr)
        return 1
    return 0


def fullscale_path(torch):
    """The full-vocabulary flagship (`tools/fullscale_dryrun.py`, bench.py's
    settings at vocab_cap 40,000,000: 204,184,588 rows, 52.3 GB of bf16
    tables) in a child process of its own, so that its memory comes back at
    exit: 6 steps, a 4-batch eval, the child's checks; the caps measured on
    the first batch with the JAX tool's headroom (1.25) and the routes
    printed."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    code = "import sys; sys.path.insert(0, %r); import chip_smoke; sys.exit(chip_smoke.fullscale_child())" % root
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=900)
    sys.stderr.write(r.stderr[-20000:])
    recs = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith('{"phase": "fullscale_path"')]
    rec = dict(recs[-1] if recs else {}, phase="fullscale_path", rc=r.returncode,
               parent_memory_allocated=torch.cuda.memory_allocated(), seconds=time.perf_counter() - t0)
    emit(rec)
    if r.returncode or not recs:
        raise AssertionError(f"fullscale_path: the child exited with {r.returncode}")
    return rec["launches"]


def auc_scale_path(torch):
    """`tools/auc_scale_probe.py` on the card at 5,242,880, 16,777,216 and
    89,137,319 samples: the exact and the binned AUC and each finalize's ms;
    the binned within 1e-4 of the exact at every size."""
    from hugectr_tpu_torch.tools.auc_scale_probe import SIZES, probe

    t0 = time.perf_counter()
    recs = [probe(n) for n in SIZES]
    torch.cuda.empty_cache()
    emit(dict(phase="auc_scale_path", sizes=recs, seconds=time.perf_counter() - t0))
    bad = [r for r in recs if not abs(r["binned_minus_exact"]) <= 1e-4]
    if bad:
        raise AssertionError(f"binned AUC beyond 1e-4 of the exact: {bad}")


def eval_profile_path(torch):
    """`tools/eval_profile.py` at bench.py's operating point over 20 cached
    eval batches: the forward, forward + metric write, finalize and
    `eval()`, each per batch."""
    from hugectr_tpu_torch.tools.eval_profile import profile

    t0 = time.perf_counter()
    rec = profile(eval_batches=20, say=lambda *a, **k: print(*a, file=sys.stderr, **k))
    torch.cuda.empty_cache()
    emit(dict(phase="eval_profile", **rec, seconds=time.perf_counter() - t0))
    if not all(math.isfinite(rec[k]) and rec[k] > 0 for k in ("forward_ms", "forward_write_ms", "finalize_ms",
                                                             "eval_ms_per_batch")):
        raise AssertionError(f"eval_profile: {rec}")


def sample_cli(torch):
    """`python -m hugectr_tpu_torch.samples.dlrm_dcnv2 --max_iter 4
    --display 1 --eval_interval 4` as a user starts it: rc 0, 4 loss lines
    and an eval line with an AUC."""
    import re

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "hugectr_tpu_torch.samples.dlrm_dcnv2", "--max_iter", "4",
                        "--display", "1", "--eval_interval", "4"], cwd=root, capture_output=True, text=True,
                       timeout=600)
    text = r.stdout + r.stderr
    losses = [float(x) for x in re.findall(r"Iter: \d+ .*Loss: ([-+0-9.eEnaif]+)", text)]
    aucs = [float(x) for x in re.findall(r"Evaluation at iter 4: \{'auc': ([0-9.eE+-]+)", text)]
    emit(dict(phase="sample_cli", rc=r.returncode, losses=losses, auc=aucs, seconds=time.perf_counter() - t0))
    if r.returncode or len(losses) != 4 or not all(math.isfinite(x) for x in losses) or len(aucs) != 1:
        sys.stderr.write(text[-8000:])
        raise AssertionError(f"sample_cli: rc {r.returncode}, losses {losses}, auc {aucs}")


# The one-hot forward of a group of more than 48 lookups: the 510-table
# case's group of its 100 one-row-hot 1,000-row tables at the case's batch
# (benchmarks/embedding_collection/README.md: 510 tables at batch 2,048)
CHUNK_B = 2048
CHUNK_SIZES = (49, 96, 100)


def chunked_group_checks(torch, np, oh, dev, results):
    """`onehot_fwd_chunked` at 49, 96 and 100 lookups of the 510-table
    case's one-hot group (1,000 rows, hotness 1, ev 128, batch 2,048; keys
    as int32 column views of one [B, 100] tensor), f32 and bf16, unweighted
    and with weights: ceil(n / 48) launches a call, each writing its
    lookups' columns, against one plain call over the whole group; the
    100-lookup cases' times beside the bound and one embedding_bag. The
    grouped backward at 49 and 100 lookups the same way (`onehot_bwd_chunked`,
    one index_add_ of the group's pairs beside it)."""
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms
    from hugectr_tpu_torch.tools.kernel_sweep import embedding_bag_call, group_bytes

    rng = np.random.default_rng(510)
    v, nmax = 1000, max(CHUNK_SIZES)
    keys_all = torch.as_tensor(power_law(rng, v, (CHUNK_B, nmax)).astype(np.int32), device=dev)
    w_all = torch.as_tensor(rng.random((CHUNK_B, nmax), dtype=np.float32), device=dev)
    table32 = torch.as_tensor(rng.standard_normal((v * nmax, E), dtype=np.float32), device=dev)
    for n in CHUNK_SIZES:
        lookups = [oh.GroupLookup(v * i, v, E * i, i % 7 == 0) for i in range(n)]
        keys = [keys_all[:, i : i + 1] for i in range(n)]
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[1]
            table = table32[: v * n].to(dt)
            for weighted in (False, True):
                t0 = time.perf_counter()
                ws = [w_all[:, i : i + 1] for i in range(n)] if weighted else None
                call = lambda: oh.onehot_fwd_chunked(keys, lookups, table, E * n, ws)  # noqa: E731
                before = oh.LAUNCHES["onehot_fwd"]
                got = call()
                launches = oh.LAUNCHES["onehot_fwd"] - before
                want = oh.onehot_fwd_group_plain(keys, lookups, table, E * n, ws)
                scale = oh.onehot_fwd_group_plain(keys, lookups, table.float().abs(), E * n, ws)
                torch.cuda.synchronize()
                rec = dict(kernel="onehot_fwd", case=f"chunked{n}{'_weighted' if weighted else ''}", dtype=dname,
                           B=CHUNK_B, lookups=n, V=v, h=1, weighted=weighted,
                           scaled_err=scaled_err(got, want, scale),
                           max_abs_err=float((got.float() - want.float()).abs().max()), tol=TOL[dname],
                           launches_per_call=launches, expected_launches=-(-n // oh.MAX_GROUP_LOOKUPS))
                if n == nmax:
                    b_ms, b_by = bound(group_bytes(keys, lookups, table, E * n), CHUNK_B * n * E)
                    dms, per_call = device_ms(call, KERNEL_NAMES["onehot_fwd"])
                    lib = embedding_bag_call(keys, lookups, table)
                    rec.update(ms=time_ms(call), device_ms=dms, device_launches_per_call=per_call,
                               plain_ms=time_ms(lambda: oh.onehot_fwd_group_plain(keys, lookups, table, E * n, ws)),
                               library_ms=None if weighted else time_ms(lib),
                               library="one torch.nn.functional.embedding_bag(mode='sum') over the group storage",
                               bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms)
                rec["seconds"] = time.perf_counter() - t0
                if n == nmax:
                    results.append(rec)
                emit(rec)
                if not (rec["scaled_err"] <= TOL[dname] and launches == rec["expected_launches"]
                        and got.shape == want.shape):
                    raise AssertionError(f"chunked one-hot forward disagrees or launched otherwise: {rec}")
                if n in (49, nmax):  # the backward: ceil(n / 48) launches into one gradient
                    d = torch.as_tensor(rng.standard_normal((CHUNK_B, E * n), dtype=np.float32), device=dev).to(dt)
                    bwd_group_case(torch, oh, dev, results if n == nmax else [],
                                   f"chunked{n}{'_weighted' if weighted else ''}", keys, lookups, d, v * n, E, ws)


# The shapes the scatter ratio gives the one-hot kernels at bench.py's
# settings with HCTR_TPU_ONEHOT_SCATTER_RATIO=2000 (hugectr_tpu/parallel/
# plan.py:503-507): table 20's hot tier, 130,048 rows at hotness 100,
# joins the one-hot group; checked at V 131,072, the engine's cap
RATIO_V = 131072
RATIO_H = 100


def scatter_ratio_checks(torch, np, oh, dev, results):
    """The one-hot forward (gather route) and the grouped backward (global
    atomics) at V 131,072, h 100, batch 16,384, ev 128, f32 and bf16,
    against their plain versions, beside their bounds, `embedding_bag` and
    `index_add_`. Neither plain version builds a [B, V] counts matrix (the
    forward gathers [B, h, E] rows, the backward `index_add_`s [B h, E]
    rows), so the batch is the bench's."""
    import torch.nn.functional as F

    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms

    rng = np.random.default_rng(2000)
    v, h = RATIO_V, RATIO_H
    keys = torch.as_tensor(power_law(rng, v, (B, h)).astype(np.int32), device=dev)
    keys_l = keys.long()
    uniq = int(torch.unique(keys).numel())
    lk = [oh.GroupLookup(0, v, 0, False)]
    for dt in (torch.float32, torch.bfloat16):
        t0 = time.perf_counter()
        dname = str(dt).split(".")[1]
        table = torch.as_tensor(rng.standard_normal((v, E), dtype=np.float32), device=dev).to(dt)
        d = torch.as_tensor(rng.standard_normal((B, E), dtype=np.float32), device=dev).to(dt)
        isz = table.element_size()
        fwd = lambda: oh.onehot_fwd_group([keys], lk, table, E)  # noqa: E731
        got = fwd()
        want = oh.onehot_fwd_group_plain([keys], lk, table, E)
        scale = oh.onehot_fwd_group_plain([keys], lk, table.float().abs(), E)
        torch.cuda.synchronize()
        b_ms, b_by = bound(keys.numel() * 4 + uniq * E * isz + B * E * isz, B * h * E)
        dms, per_call = device_ms(fwd, KERNEL_NAMES["onehot_fwd"])
        rec = dict(kernel="onehot_fwd", case=f"ratio_V{v}_h{h}", dtype=dname, B=B, V=v, h=h, E=E,
                   route=oh.fwd_route(v, h, E, dev), scaled_err=scaled_err(got, want, scale),
                   max_abs_err=float((got.float() - want.float()).abs().max()), tol=TOL[dname],
                   ms=time_ms(fwd), device_ms=dms, device_launches_per_call=per_call,
                   plain_ms=time_ms(lambda: oh.onehot_fwd_group_plain([keys], lk, table, E)),
                   library_ms=time_ms(lambda: F.embedding_bag(keys_l, table, mode="sum")),
                   library="torch.nn.functional.embedding_bag(mode='sum')",
                   bound_ms=b_ms, bound_by=b_by, bound_fraction=b_ms / dms)
        rec["seconds"] = time.perf_counter() - t0
        results.append(rec)
        emit(rec)
        if not rec["scaled_err"] <= TOL[dname]:
            raise AssertionError(f"the one-hot forward at the scatter ratio's shapes disagrees: {rec}")
        rec2 = bwd_group_case(torch, oh, dev, results, f"ratio_V{v}_h{h}", [keys], lk, d, v, E)
        if rec2["routes"] != ["global"]:
            raise AssertionError(f"the scatter ratio's backward left the global atomics: {rec2}")
        del table, d


def peak_partial_sums(torch, idx, vals, rows):
    """[rows, E] float64 on the CPU: for each element, the largest |partial
    sum| that the ordered adds (by row, then by position) pass through."""
    o = torch.sort(idx, stable=True).indices
    sidx, sv = idx[o], vals[o].double()
    head = torch.ones_like(sidx, dtype=torch.bool)
    head[1:] = sidx[1:] != sidx[:-1]
    pos = torch.arange(sidx.numel())
    start = torch.cummax(torch.where(head, pos, 0), 0).values
    cs = sv.cumsum(0)
    part = (cs - cs[start] + sv[start]).abs()
    return torch.zeros((rows, sv.shape[1]), dtype=torch.float64).scatter_reduce_(
        0, sidx.unsqueeze(1).expand_as(part), part, "amax")


def bf16_grad_checks(torch, np, dev):
    """The dense sweep's bf16 gradient buffer (`dense_grad_dtype`,
    JAX: HCTR_TPU_DENSE_GRAD_DTYPE) on the card: one `index_add_` into
    bf16, adding in no fixed order, against the plain version's ordered
    adds (the JAX package's order, run on the CPU), on a shard of 65,536
    rows, ev 128, with the 200-table case's 2,048 x 20 power-law keys of
    one table (sparse_optimizer.py:206-218 sizes its buffer at [64k,
    128]). Each add rounds the running sum by at most 2^-8 of it, so an
    element's n adds carry a rounding of about lim = 2^-8 x sqrt(n) x (the
    largest |partial sum| of the ordered adds). The check: an element
    within 2^-7 x sqrt(n) x sum |g| and within 8 lim; each row of at least
    256 adds within 0.5 of lim in its rms over the columns
    (tests/test_torch_gpu.py states how the limits were sized). Then one AdaGrad update on the card takes the
    dense route with the bf16 buffer."""
    from hugectr_tpu_torch.core.types import Optimizer_t
    from hugectr_tpu_torch.embedding import sparse_optimizer as so
    from hugectr_tpu_torch.optim.params import OptParams

    t0 = time.perf_counter()
    rng = np.random.default_rng(206)
    rows, k = 65536, 2048 * 20
    idx = torch.as_tensor(power_law(rng, rows, k), device=dev)
    src = torch.arange(k, device=dev)
    vals = torch.as_tensor(rng.standard_normal((k, E), dtype=np.float32), device=dev)
    got = so.bf16_row_sums(idx, src, vals, rows)
    want = so.bf16_row_sums(idx.cpu(), src.cpu(), vals.cpu(), rows)
    n = torch.bincount(idx.cpu(), minlength=rows).double().unsqueeze(1)
    absum = torch.zeros((rows, E), dtype=torch.float64).index_add_(0, idx.cpu(), vals.cpu().abs().double())
    lim = 2.0**-8 * n.sqrt() * peak_partial_sums(torch, idx.cpu(), vals.cpu(), rows)
    diff = (got.cpu().double() - want.double()).abs()
    hot = n[:, 0] >= 256
    ratio = float((diff / (n.sqrt() * absum + 1e-30)).max())
    elem = float((diff / lim.clamp_min(1e-30)).max())
    row = float(((diff[hot] ** 2).mean(1).sqrt() / (lim[hot] ** 2).mean(1).sqrt()).max()) if hot.any() else 0.0
    table = torch.zeros((rows, E), dtype=torch.float32, device=dev)
    state = so.init_state(OptParams(Optimizer_t.AdaGrad, initial_accu_value=0.1), rows, E, device=dev)
    route = so.apply_sparse(OptParams(Optimizer_t.AdaGrad, initial_accu_value=0.1), table, state, idx, src, vals,
                            torch.tensor(0.01, device=dev), dense_rows=rows, dense_ratio=0.0,
                            grad_dtype=torch.bfloat16)
    rec = dict(phase="bf16_grad_check", rows=rows, E=E, keys=k, max_dup=int(n.max()), dtype="bfloat16",
               max_diff_over_sqrt_n_abs_sum=ratio, tol=2.0**-7, max_diff_over_lim=elem, lim_tol=8.0,
               rows_of_256_adds=int(hot.sum()), max_row_rms_over_lim=row,
               row_tol=0.5, bitwise_equal=bool(torch.equal(got.cpu(), want)),
               update_route=route, update_finite=bool(torch.isfinite(table).all()),
               seconds=time.perf_counter() - t0)
    emit(rec)
    if not (ratio <= 2.0**-7 and elem <= 8.0 and row <= 0.5 and route == "dense" and rec["update_finite"]
            and got.dtype == torch.bfloat16):
        raise AssertionError(f"bf16 dense-sweep buffer on the card: {rec}")


def scatter_ratio_path(torch):
    """The flagship at bench.py's settings with the scatter ratio 2,000 (the
    JAX docstring's operating point, hugectr_tpu/parallel/plan.py:503-507):
    table 20's hot tier (130,048 rows, h 100) and table 14 (11,938 rows, h
    9) join the one-hot group. 3 steps; counters set to 0 just before them
    and read just after: the grouped forward and the grouped backward once a
    step each (one launch for the group's 22 lookups)."""
    from hugectr_tpu_torch import ops
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools.flagship import bench_settings, build_dlrm_dcnv2

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_dlrm_dcnv2(ResourceManager.create(), synthetic_batches=3, onehot_scatter_ratio=2000,
                             **bench_settings())
    model.start_data_reading()
    onehot = [g for g in model.ec.plan.groups if g.compute_kind == "onehot"]
    names = [t.name for g in onehot for t in g.tables]
    ops.reset_counts()
    losses, step_s = [], []
    for _ in range(3):
        t = time.perf_counter()
        losses.append(model.train())
        step_s.append(time.perf_counter() - t)
    lc = ops.launch_counts()
    n_lookups = sum(len(g.lookups) for g in onehot)
    rec = dict(phase="scatter_ratio_path", card=card_line(), settings=dict(bench_settings(), onehot_scatter_ratio=2000),
               onehot_tables=names, onehot_lookups=n_lookups, routes=dict(model.ec.group_routes),
               caps=caps_line(model.ec), ordered_pool_per_step=lc["ordered_pool"] / 3, losses=losses,
               step_ms=[x * 1e3 for x in step_s], median_ms_per_step=statistics.median(step_s[1:]) * 1e3,
               launches=lc, max_memory_allocated=torch.cuda.max_memory_allocated(), seconds=time.perf_counter() - t0)
    emit(rec)
    if not ("20::hot" in names and "14" in names and all(math.isfinite(x) for x in losses)
            and lc["onehot_fwd"] == 3 and lc["onehot_bwd"] == 3
            and lc["ordered_pool"] == 3 * 13 and set(model.ec.valid_caps) == SCATTER_RATIO_COMPACT):
        raise AssertionError(f"scatter-ratio path: {rec}")
    model._close_readers()
    return lc


# The synthetic cases at the JAX README's operating points
# (benchmarks/embedding_collection/README.md, "Measured"): bf16 tables and
# state, rowwise AdaGrad; the 7-table case untiered and with a 65,536-row
# hot and a 1,024-row superhot tier
# case, batch, cap, tier rows, onehot_fwd launches a forward: the one-hot
# group's 30, 40, 100 and 7 lookups take ceil(n / 48); the untiered 7-table
# case has no table small enough for the one-hot engine
BENCH_CASES = [
    ("200table_100B_hotness20", 2048, 65536, {}, 1),
    ("180table_70B_hotness80", 512, 65536, {}, 1),
    ("510table_110B_hotness5", 2048, 32768, {}, 3),
    ("7table_470B_hotness20", 8192, 1_000_000, {}, 0),
    ("7table_470B_hotness20", 8192, 1_000_000, {"hot_rows": 65536, "superhot_rows": 1024}, 1),
]
BENCH_CASE_STEPS = dict(warmup=2, iters=5)  # the runner's 5 and 20, cut
SKIP_FLAGS = (None, "SKIP_EMBEDDING", "SKIP_EMBEDDING_UPDATE", "SKIP_BOTTOM_MLP", "SKIP_TOP_MLP")


def _layer_calls(model):
    """Forward pre-hooks counting each dense layer's forward calls."""
    calls = {name: 0 for name in model.network.layers}
    hooks = [layer.register_forward_pre_hook(lambda m, a, n=name: calls.__setitem__(n, calls[n] + 1))
             for name, layer in model.network.layers.items()]
    return calls, hooks


def benchmarks_path(torch):
    """The port's benchmark suite (`hugectr_tpu_torch/benchmarks/
    embedding_collection/train.py`) on the card, through its functions.
    First the `dcnv2` case at the runner's defaults (batch 8,192, vocab cap
    1,000,000, ev 128, `adagrad`, 32 cached batches, mixed precision), once
    with no flag and once under each of SKIP_EMBEDDING,
    SKIP_EMBEDDING_UPDATE, SKIP_BOTTOM_MLP and SKIP_TOP_MLP (the step is
    rebuilt for each, as the Model reads the flags when it builds it): 5
    warm-up and 20 timed steps each, ms/step and its difference from the
    run with no flag, the launch counters and each dense layer's forward
    calls over the 25 steps (a skipped stage launches none of its kernels:
    no one-hot or segscan launch without the embedding, no backward one
    without its update, no forward call of a skipped MLP); every stage
    runs the captured step (`step_mode` "graph"). Then, with no flag, the
    eager and the captured step in turns (`mode_turns`: eager, graph,
    graph, eager; 2 warm-up and 10 timed steps each). Then each
    synthetic case once at the README's operating points (`BENCH_CASES`),
    its steps cut to `BENCH_CASE_STEPS`."""
    from hugectr_tpu_torch import ops
    from hugectr_tpu_torch.benchmarks.embedding_collection import train
    from hugectr_tpu_torch.core.mesh import ResourceManager

    t0 = time.perf_counter()
    saved = {k: os.environ.pop(k) for k in list(os.environ) if k.startswith("SKIP_")}
    rm = ResourceManager.create()
    args = train.parser().parse_args(["--case", "dcnv2"])
    torch.cuda.reset_peak_memory_stats()
    model, hot = train.build_case(rm, args)
    build_s = time.perf_counter() - t0
    stages, base = [], None
    try:
        for flag in SKIP_FLAGS:
            for k in [k for k in os.environ if k.startswith("SKIP_")]:
                del os.environ[k]
            if flag:
                os.environ[flag] = "1"
            train.skip_env()
            model._build_steps()
            calls, hooks = _layer_calls(model)
            ops.reset_counts()
            run = train.run_protocol(model, args.warmup, args.iters)
            lc = ops.launch_counts()
            for hk in hooks:
                hk.remove()
            rec = dict(train.record(args, rm, run, hot), phase="benchmarks_path", flag=flag or "none",
                       ms_per_step=run["sec_per_iter"] * 1e3, launches=lc, layer_calls=calls,
                       step_mode=model.step_mode, losses_finite=all(math.isfinite(x) for x in run["losses"]))
            base = base if base is not None else rec["ms_per_step"]
            rec["ms_vs_no_flag"] = rec["ms_per_step"] - base
            emit(rec)
            stages.append(rec)
            n = args.warmup + args.iters
            ok = rec["losses_finite"]
            # each stage runs the captured step, so the ablations compare like with like
            ok = ok and rec["step_mode"] == "graph" and "train" in model._graphs
            if flag is None:
                ok = ok and all(lc[k] > 0 for k in ONE_CARD_KERNELS) and lc["onehot_fwd"] == lc["onehot_bwd"] == n
            elif flag == "SKIP_EMBEDDING":
                ok = ok and not any(lc[k] for k in ONE_CARD_KERNELS)
            elif flag == "SKIP_EMBEDDING_UPDATE":
                ok = ok and lc["onehot_fwd"] > 0 and lc["onehot_bwd"] == lc["segscan"] == 0
            elif flag == "SKIP_BOTTOM_MLP":
                ok = ok and calls["l0_MLP"] == 0 and all(lc[k] > 0 for k in ONE_CARD_KERNELS)
            else:
                top = [name for name in calls if name.endswith("_MLP") and name != "l0_MLP"]
                ok = ok and len(top) == 1 and calls[top[0]] == 0
            if not ok:
                raise AssertionError(f"benchmarks path under {flag}: {rec}")
        for k in [k for k in os.environ if k.startswith("SKIP_")]:
            del os.environ[k]
        train.skip_env()
        model._build_steps()
        modes = mode_turns(model, lambda: train.run_protocol(model, 2, 10))
        emit(dict(phase="benchmarks_path_modes", case="dcnv2", turns=modes))
        model._close_readers()
        del model
    finally:
        for k in [k for k in os.environ if k.startswith("SKIP_")]:
            del os.environ[k]
        os.environ.update(saved)
    cases = []
    for case, batch, cap, tiers, want_fwd in BENCH_CASES:
        t = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        argv = ["--case", case, "--batchsize", str(batch), "--vocab_cap", str(cap), "--optimizer", "rowwise_adagrad",
                "--emb_dtype", "bfloat16", "--state_dtype", "bfloat16", "--warmup", str(BENCH_CASE_STEPS["warmup"]),
                "--iters", str(BENCH_CASE_STEPS["iters"])]
        for k, val in tiers.items():
            argv += [f"--{k}", str(val)]
        cargs = train.parser().parse_args(argv)
        m, hot = train.build_case(rm, cargs)
        groups = [(g.name, g.compute_kind, len(g.lookups)) for g in m.ec.plan.groups]
        ops.reset_counts()
        run = train.run_protocol(m, cargs.warmup, cargs.iters)
        lc = ops.launch_counts()
        rec = dict(train.record(cargs, rm, run, hot), phase="benchmarks_path", tiers=tiers, step_mode=m.step_mode,
                   reduced=dict(warmup=[5, cargs.warmup], iters=[20, cargs.iters]), groups=groups,
                   routes=dict(m.ec.group_routes), onehot_fwd_calls=m.ec.onehot_fwd_calls(), launches=lc,
                   losses=run["losses"], build_seconds=time.perf_counter() - t - run["seconds"],
                   seconds=time.perf_counter() - t)
        emit(rec)
        cases.append(rec)
        n = cargs.warmup + cargs.iters
        if not (all(math.isfinite(x) for x in run["losses"]) and rec["onehot_fwd_calls"] == want_fwd
                and lc["onehot_fwd"] == lc["onehot_bwd"] == n * want_fwd):
            raise AssertionError(f"benchmark case {case}: {rec}")
        if case.startswith("510") and max(k for _, kind, k in groups if kind == "onehot") <= 48:
            raise AssertionError(f"the 510-table case has no one-hot group of more than 48 lookups: {groups}")
        m._close_readers()
        del m
    emit(dict(phase="benchmarks_path_summary", card=card_line(), build_seconds=build_s,
              stage_ms={r["flag"]: r["ms_per_step"] for r in stages},
              dcnv2_modes_ms={f"{i}_{x['turn']}": x["ms_per_step"] for i, x in enumerate(modes)},
              stage_ms_vs_no_flag={r["flag"]: r["ms_vs_no_flag"] for r in stages},
              cases=[dict(case=r["case"], tiers=r["tiers"], batch=r["batchsize"], vocab_cap=r["vocab_cap"],
                          examples_per_sec=r["examples_per_sec"], sec_per_iter=r["sec_per_iter"],
                          max_memory_allocated=r.get("max_memory_allocated")) for r in cases],
              seconds=time.perf_counter() - t0))
    return stages[0]["launches"]


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
    layers_parity(torch)
    launches, main_rec = main_path(torch)
    torch.cuda.empty_cache()
    file_launches = file_path(torch, main_rec)
    torch.cuda.empty_cache()
    bench_launches = bench_path(torch)
    torch.cuda.empty_cache()
    packed_launches = packed_path(torch)
    torch.cuda.empty_cache()
    ratio_launches = scatter_ratio_path(torch)
    torch.cuda.empty_cache()
    benchmarks_launches = benchmarks_path(torch)
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
    cache_path(torch)
    torch.cuda.empty_cache()
    file_i64_path(torch)
    torch.cuda.empty_cache()
    serving_launches = snapshot_path(torch)
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
    fullscale_launches = fullscale_path(torch)
    auc_scale_path(torch)
    eval_profile_path(torch)
    sample_cli(torch)

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
    bench_cases = {"onehot_fwd": "group20", "onehot_bwd": "group20", "segscan": "cold_tier_20"}
    # the scatter ratio's shapes (V 131,072, h 100) in f32, and the 510-table case's 100-lookup group
    ratio = {x["kernel"]: x for x in results if x["case"].startswith("ratio_") and x["dtype"] == "float32"}
    chunked = next(x for x in results if x["case"] == "chunked100" and x["dtype"] == "float32")
    rank_sfx = f"_w{hybrid_world(torch)}"
    by_case = {x["case"]: x for x in results if x["kernel"] in ("segscan", "row_scatter", "adagrad_rows", "ftrl_rows")}
    for name, (src, replaces) in sources.items():
        # the float32 flagship case that costs the step most device time;
        # for the one-hot kernels the step's one launch, the 13-table group
        # (the scatter ratio's and the chunked group's cases stand apart);
        # for segscan the counted form the step launches, at table 21's list
        r = by_case["counted_sorted_21"] if name == "segscan" else max(
            (x for x in results if x["kernel"] == name and x["dtype"] == "float32" and not x.get("weighted")
             and (name not in ("onehot_fwd", "onehot_bwd") or x["case"] == "group13")
             and not x["case"].startswith(("ratio_", "chunked"))),
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
            serving_path_launches=serving_launches[name], fullscale_path_launches=fullscale_launches[name],
            scatter_ratio_path_launches=ratio_launches[name], benchmarks_path_launches=benchmarks_launches[name],
            packed_path_launches=packed_launches[name],
            **({"ratio_case": {k: ratio[name][k] for k in keys}} if name in ratio else {}),
            **({"chunked_case": {k: chunked[k] for k in keys}} if name == "onehot_fwd" else {}),
            **({"counted_case": {k: by_case["counted_cold_tier_20"][k] for k in (*keys, "count", "K", "prefix_ms")}}
               if name == "segscan" else {}),
        ))
    # the drop-mode scatters of the fixed-shape update (csrc/row_scatter.cu),
    # at the float32 flagship's shapes (the dense sweep's scatter at table
    # 20, the sorted route's RowWiseAdaGrad update at table 21) beside the
    # bench path's (table 20's tiers: the hot tier's scatter, the cold
    # tier's RowWiseAdaGrad on bf16) and, for the row update, AdaGrad on
    # float32 (the suite's dcnv2 case) on the cold tier's list
    for name, case, bcase, extra, replaces in (
            ("row_scatter", "dense_20_f32", "dense_hot_20", {"table11_case": "dense_11_f32"},
             "hugectr_tpu/embedding/sparse_optimizer.py:486 (the dense sweep's scatter-add in mode='drop'; "
             "no Pallas kernel)"),
            ("adagrad_rows", "sorted_21_rowwise_adagrad", "cold_tier_20_rowwise_adagrad",
             {"dcnv2_case": "cold_tier_20_adagrad"},
             "hugectr_tpu/embedding/sparse_optimizer.py:752-800 (_apply_rows' gathers and mode='drop' row "
             "scatters; no Pallas kernel)")):
        kernels.append(dict(
            name=name, route="cuda", source="hugectr_tpu_torch/csrc/row_scatter.cu", replaces=replaces,
            launches=launches[name], **{k: by_case[case][k] for k in keys},
            bench_case={k: by_case[bcase][k] for k in keys},
            **{key: {k: by_case[c][k] for k in keys} for key, c in extra.items()},
            bench_path_launches=bench_launches[name], benchmarks_path_launches=benchmarks_launches[name],
            fullscale_path_launches=fullscale_launches[name], ftrl_path_launches=ftrl_launches[name],
        ))
    # FTRL's row update: a kernel of the DLRM-FTRL path (5 launches a step),
    # its launches there (6 steps and 20 eval batches), at its table 21,
    # beside its edges' bf16 case with the most device time
    fb = max((x for x in results if x["kernel"] == "ftrl_rows" and x["dtype"] == "bfloat16"),
             key=lambda x: x["device_ms"])
    kernels.append(dict(
        name="ftrl_rows", route="cuda", source="hugectr_tpu_torch/csrc/row_scatter.cu",
        replaces="hugectr_tpu/embedding/sparse_optimizer.py:873-891 (_apply_rows' FTRL gathers and mode='drop' row "
                 "sets; no Pallas kernel)",
        launches=ftrl_launches["ftrl_rows"], **{k: by_case["ftrl_21"][k] for k in keys},
        bf16_case={**{k: fb[k] for k in keys}, "state_dtype": fb["state_dtype"]},
        ftrl_path_launches=ftrl_launches["ftrl_rows"], main_path_launches=launches["ftrl_rows"],
        freeze_path_launches=freeze_launches["ftrl_rows"], serving_path_launches=serving_launches["ftrl_rows"],
    ))
    # SGD's scatter into the table (the row_scatter kernel on the samples'
    # path: MMoE's and shared-bottom's update) and the samples' launches
    row = next(x for x in kernels if x["name"] == "row_scatter")
    sgd = next(x for x in sample_results if x["case"] == "sgd_mmoe_table")
    row.update(sgd_case={k: sgd[k] for k in keys},
               samples_path_launches={g: x["row_scatter"] for g, x in samples_launches.items()})
    # Adam's row update and Dropout's mask: kernels of the samples' path
    # (`launches`: the eleven graphs' 6 steps and 20 eval batches), each at
    # its float32 sample case with the most device time, beside Adam's
    # bf16 edge case with the most device time
    for name, replaces in (
            ("adam_rows", "hugectr_tpu/embedding/sparse_optimizer.py:855-870 (_apply_rows' Adam gathers and "
                          "mode='drop' row scatters; no Pallas kernel)"),
            ("dropout_mask", "hugectr_tpu/layers/core_layers.py:88-97 (Dropout's jax.random.bernoulli of the "
                             "step's folded key, hugectr_tpu/model/model.py:801; no Pallas kernel)")):
        cases = [x for x in sample_results if x["kernel"] == name]
        r = max((x for x in cases if x["dtype"] in ("float32", "bool") and x["case"].startswith("sample_")),
                key=lambda x: x["device_ms"])
        extra = {}
        if name == "adam_rows":
            rb = max((x for x in cases if x["dtype"] == "bfloat16"), key=lambda x: x["device_ms"])
            extra = dict(bf16_case={**{k: rb[k] for k in keys}, "state_dtype": rb["state_dtype"]})
        source = "row_scatter" if name == "adam_rows" else "dropout"
        kernels.append(dict(
            name=name, route="cuda", source=f"hugectr_tpu_torch/csrc/{source}.cu", replaces=replaces, launches=sum(x[name] for x in samples_launches.values()), **{k: r[k] for k in keys},
            samples_path_launches={g: x[name] for g, x in samples_launches.items()}, **extra,
        ))
    # the ordered pool: a kernel of the paths over W ranks; its launches are
    # rank 0's on the hybrid path (steps and eval), beside the bench path's
    # and its bf16 case with the most device time (the unweighted cases of
    # `ordered_pool_checks`; the E 64 and the
    # weighted cases stand in `column_case` and `weighted_case`)
    pool = [x for x in results if x["kernel"] == "ordered_pool" and "index_add_ms" in x
            and not x["case"].startswith(("column_", "weighted_", "compact"))]
    compact = {x["case"]: x for x in results if x["kernel"] == "ordered_pool" and x["case"].startswith("compact")}
    r = max((x for x in pool if x["dtype"] == "float32"), key=lambda x: x["device_ms"])
    rb = max((x for x in pool if x["dtype"] == "bfloat16"), key=lambda x: x["device_ms"])
    kernels.append(dict(
        name="ordered_pool", route="cuda", source="hugectr_tpu_torch/csrc/ordered_pool.cu",
        replaces="hugectr_tpu/embedding/collection.py:882-900, :1534-1545 (the scatter-adds of _mp_fwd_partitioned "
                 "and _dp_fwd_compact; no Pallas kernel)",
        launches=hybrid_launches[0]["ordered_pool"], **{k: r[k] for k in keys},
        bench_path_launches=bench_launches["ordered_pool"], packed_path_launches=packed_launches["ordered_pool"],
        scatter_ratio_path_launches=ratio_launches["ordered_pool"],
        compact_case={k: compact["compact_mp_ev128_20::cold_w1"][k] for k in keys},
        compact_hot_case={k: compact["compact_mp_ev128_20::hot_w1"][k] for k in keys},
        compact_packed_case={k: compact["compact_packed_mp_ev128_20::cold_w1"][k] for k in keys},
        hybrid_path_launches=[x["ordered_pool"] for x in hybrid_launches],
        hybrid_hier_path_launches=[x["ordered_pool"] for x in hier_launches],
        hybrid_column_path_launches=[x["ordered_pool"] for x in column_launches],
        hybrid_bench_path_launches=[x["ordered_pool"] for x in hybrid_bench_launches],
        bench_case={k: rb[k] for k in keys}, index_add_ms=r["index_add_ms"], bench_index_add_ms=rb["index_add_ms"],
        column_case={k: column["ordered_pool"][k] for k in keys},
        weighted_case=dict(weighted_case(results, "ordered_pool", None),
                           launches=hybrid_weighted[0]["ordered_pool"],
                           hybrid_weighted_path_launches=[x["ordered_pool"] for x in hybrid_weighted]),
        serving_path_launches=serving_launches["ordered_pool"],
        fullscale_path_launches=fullscale_launches["ordered_pool"],
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
