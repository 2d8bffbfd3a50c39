"""The embedding-collection benchmark runner (counterpart of
benchmarks/embedding_collection/train.py; the reference suite's
benchmarks/embedding_collection/{benchmark.sh,hugectr/train.py}).

Builds the DLRM-DCNv2 flagship (`--case dcnv2`) or one of the synthetic
table cases (`configs.CASES`) on power-law synthetic batches, takes
`--warmup` steps with `train()`, then `--iters` with `train_async()`, a
synchronisation, and prints one JSON line: the JAX runner's keys (case,
examples_per_sec, sec_per_iter, batchsize, vocab_cap, ev_size,
hotness_total, devices, skips) and the card's name and power limit
(`nvidia-smi`), the peak device memory and the device.

The component-skip ablations are the Model's (`SKIP_EMBEDDING`,
`SKIP_EMBEDDING_UPDATE`, `SKIP_DENSE_LAYERS`); `SKIP_BOTTOM_MLP` and
`SKIP_TOP_MLP` are mapped here onto `SKIP_DENSE_LAYERS` as "mlp1" and
"mlp2,m2" (train.py:25-36). `SKIP_H2D`, which the JAX README names, is
read by no JAX code and has no counterpart.

As in the JAX runner, the default `--vocab_cap` 1,000,000 caps the
`dcnv2` case too; only `--vocab_cap 0` builds it at 2,000,000 rows a
table (train.py:75). Its optimizer is `HCTR_BENCH_OPT` when set, else
`--optimizer` (flagship.py:76-84). The flags `--emb_dtype`,
`--state_dtype`, `--hot_rows` and `--superhot_rows` are the settings the
JAX README's measured table pins through its environment
(HCTR_TPU_EMB_DTYPE, _EMB_STATE_DTYPE, _HOT_ROWS, _SUPERHOT_ROWS), here
`Solver` fields, and so is `--ucap` (its HCTR_TPU_UCAP_FACTOR=auto, the
README's command, benchmarks/embedding_collection/README.md:21-24: the caps
measured on the first batch with the default headroom of 1.25; `0` turns
them off).

Usage (on the card; `--device cpu` runs it on the CPU; over W ranks start
it with torchrun):

    python -m hugectr_tpu_torch.benchmarks.embedding_collection.train \\
        --case dcnv2 --batchsize 8192 --vocab_cap 2000000 --iters 20
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

import hugectr_tpu_torch as hugectr
from hugectr_tpu_torch.benchmarks.embedding_collection.configs import CASES, expand
from hugectr_tpu_torch.core import mesh
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import DataReaderType_t

CASE_NAMES = ("dcnv2", *CASES)
# the reference suite's flags -> the dense layers of these graphs
MLP_SKIPS = (("SKIP_BOTTOM_MLP", "mlp1"), ("SKIP_TOP_MLP", "mlp2,m2"))


def skip_env(environ=os.environ) -> None:
    """Map SKIP_BOTTOM_MLP / SKIP_TOP_MLP onto SKIP_DENSE_LAYERS, after
    any layers it already names (train.py:25-36)."""
    skips = [s for flag, s in MLP_SKIPS if environ.get(flag)]
    if skips:
        prev = environ.get("SKIP_DENSE_LAYERS", "")
        environ["SKIP_DENSE_LAYERS"] = ",".join([x for x in [prev] if x] + skips)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default="dcnv2", choices=CASE_NAMES)
    ap.add_argument("--batchsize", type=int, default=8192)
    ap.add_argument("--vocab_cap", type=int, default=1_000_000,
                    help="per-table vocabulary cap (0 = full scale)")
    ap.add_argument("--ev_size", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--alpha", type=float, default=1.1)
    ap.add_argument("--optimizer", default="adagrad")
    ap.add_argument("--emb_dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--state_dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--hot_rows", type=int, default=0)
    ap.add_argument("--superhot_rows", type=int, default=0)
    ap.add_argument("--ucap", default="auto", help="the unique-cap factor: auto (the README's), 0, or in (0, 1)")
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    return ap


def engine_kwargs(args) -> Dict[str, object]:
    """The `Solver` fields of the pinned settings."""
    return dict(embedding_vec_dtype=args.emb_dtype, embedding_state_dtype=args.state_dtype,
                hot_rows=args.hot_rows, superhot_rows=args.superhot_rows, unique_cap_factor=args.ucap)


def build_synthetic(rm: ResourceManager, case: str, batchsize: int, vocab_cap: int, ev_size: int, alpha: float,
                    optimizer: str, **solver_kwargs):
    """A synthetic case's model (train.py:86-150): one fixed-length sparse
    input of each table's hotness, every table model-parallel in one
    collection ("emb", sum), bottom MLP 512/256/ev ("mlp1"), Concat, top
    MLP 1024/512/256/1 ("m2"), BCE; 16 cached synthetic batches."""
    sizes, hots = expand(case, vocab_cap)
    solver = hugectr.CreateSolver(max_eval_batches=4, batchsize_eval=batchsize, batchsize=batchsize, lr=0.005,
                                  use_mixed_precision=True, repeat_dataset=True, **solver_kwargs)
    reader = hugectr.DataReaderParams(data_reader_type=DataReaderType_t.Synthetic, synthetic_num_batches=16,
                                      synthetic_alpha=alpha)
    opt = hugectr.CreateOptimizer(optimizer_type=hugectr.Optimizer_t(optimizer), initial_accu_value=0.0)
    model = hugectr.Model(solver, reader, opt, resource_manager=rm)
    model.add(hugectr.Input(
        label_dim=1, label_name="label", dense_dim=13, dense_name="dense",
        data_reader_sparse_param_array=[hugectr.DataReaderSparseParam(f"data{i}", hots[i], True, 1)
                                        for i in range(len(sizes))],
    ))
    tables = [hugectr.EmbeddingTableConfig(name=str(i), max_vocabulary_size=sizes[i], ev_size=ev_size)
              for i in range(len(sizes))]
    names = [str(i) for i in range(len(sizes))]
    ebc = hugectr.EmbeddingCollectionConfig()
    ebc.embedding_lookup(table_config=tables, bottom_name=[f"data{i}" for i in range(len(sizes))], top_name="emb",
                         combiner=["sum"] * len(sizes))
    ebc.shard(shard_matrix=[names] * rm.num_devices, shard_strategy=[("mp", names)])
    model.add(ebc)
    L, DL = hugectr.Layer_t, hugectr.DenseLayer
    model.add(DL(layer_type=L.MLP, bottom_names=["dense"], top_names=["mlp1"], num_outputs=[512, 256, ev_size]))
    model.add(DL(layer_type=L.Concat, bottom_names=["emb", "mlp1"], top_names=["c"]))
    model.add(DL(layer_type=L.MLP, bottom_names=["c"], top_names=["m2"], num_outputs=[1024, 512, 256, 1],
                 activations=[hugectr.Activation_t.Relu] * 3 + [hugectr.Activation_t.Non]))
    model.add(DL(layer_type=L.BinaryCrossEntropyLoss, bottom_names=["m2", "label"], top_names=["loss"]))
    model.compile()
    return model


def build_case(rm: ResourceManager, args) -> Tuple[object, int]:
    """(model, total hotness) of `args.case` (train.py:72-150)."""
    if args.case == "dcnv2":
        from hugectr_tpu_torch.tools.flagship import MLPERF_MULTI_HOT_SIZES, build_dlrm_dcnv2

        model = build_dlrm_dcnv2(
            rm, batchsize=args.batchsize, vocab_cap=args.vocab_cap or 2_000_000, synthetic_batches=32,
            use_mixed_precision=True, ev_size=args.ev_size,
            optimizer=os.environ.get("HCTR_BENCH_OPT", args.optimizer), **engine_kwargs(args),
        )
        return model, sum(MLPERF_MULTI_HOT_SIZES)
    model = build_synthetic(rm, args.case, args.batchsize, args.vocab_cap, args.ev_size, args.alpha,
                            args.optimizer, **engine_kwargs(args))
    return model, sum(expand(args.case, args.vocab_cap)[1])


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_protocol(model, warmup: int, iters: int) -> Dict[str, object]:
    """`warmup` `train()` steps, then `iters` `train_async()` steps timed on
    the host clock up to a synchronisation (train.py:152-162). Returns the
    seconds per step and the losses."""
    warm = [model.train() for _ in range(warmup)]
    synchronize(model.device)
    t0 = time.perf_counter()
    losses = [model.train_async() for _ in range(iters)]
    synchronize(model.device)
    dt = time.perf_counter() - t0
    return dict(seconds=dt, sec_per_iter=dt / max(iters, 1), warmup_losses=warm,
                losses=[float(x) for x in losses])


def card_info(device: torch.device) -> Dict[str, object]:
    """The card's name and power limit as nvidia-smi prints them, and the
    peak device memory; on the CPU, the device only."""
    if device.type != "cuda":
        return dict(device="cpu")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    return dict(device=torch.cuda.get_device_name(device), card=card[0] if card else "",
                max_memory_allocated=torch.cuda.max_memory_allocated(device))


def record(args, rm: ResourceManager, run: Dict[str, object], hotness_total: int) -> Dict[str, object]:
    """The JSON line (train.py:164-184) with the card's facts."""
    return {
        "case": args.case,
        "examples_per_sec": round(args.iters * args.batchsize / run["seconds"], 1),
        "sec_per_iter": round(run["sec_per_iter"], 5),
        "batchsize": args.batchsize,
        "vocab_cap": args.vocab_cap,
        "ev_size": args.ev_size,
        "hotness_total": hotness_total,
        "devices": rm.num_devices,
        "skips": sorted(k for k in os.environ if k.startswith("SKIP_")),
        **card_info(rm.device),
    }


def main(argv: Optional[List[str]] = None) -> int:
    args = parser().parse_args(argv)
    skip_env()
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        mesh.init_distributed()
    rm = ResourceManager.create(device=args.device)
    if rm.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(rm.device)
    model, hotness_total = build_case(rm, args)
    run = run_protocol(model, args.warmup, args.iters)
    model._close_readers()
    if rm.is_master_process():
        print(json.dumps(record(args, rm, run, hotness_total)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
