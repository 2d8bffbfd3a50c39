"""Trace a full-width training step on the card and break its time down.

Usage (on a machine with a card, from the repo root):

    python -m hugectr_tpu_torch.tools.trace_step [--model dlrm_dcnv2 | dlrm_ftrl] [--dynamic]
        [--batch 16384] [--steps 3] [--bench] [--eval] [--world W] [--out DIR]

Builds the full-width DLRM-DCNv2 (`build_dlrm_dcnv2`, 26 tables, ev 128,
vocab_cap 2M, rowwise AdaGrad, float32; with `--bench`, as bench.py
configures it: `bench_settings()`, bf16 tables and state, mixed precision,
the hot/cold/superhot split) or, with `--model dlrm_ftrl`, DLRM with FTRL
(`build_dlrm_ftrl`, 26 tables capped at 400,000 rows, hotness 1; with
`--dynamic`, exact dynamic tables of 4,096 rows each), runs 2 warm-up steps, then traces `--steps`
training steps (with `--eval`: eval batches, the forward of `Model.eval`)
with `torch.profiler`. Prints one JSON line: ms per step (host clock around
synchronised steps), device busy ms per step (sum of kernel and copy
times), the device idle share, device events (kernels, copies, memsets)
in all and per step, and device ms per step by category and by kernel
name (top 25). With `--out`, also writes the Chrome trace there.

With `--world W` the model trains hybrid-parallel on W spawned ranks
(`tools/hybrid.py`; NCCL where there is a card per rank, else gloo with the
ranks sharing the cards and the collectives staged through the host);
`--batch` stays the global batch, every rank runs the steps and rank 0 is
traced. NCCL's kernels count as the category "collective".
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import time

import torch

from .devtime import KERNEL_NAMES

CATEGORIES = (
    ("collective", ("nccl",)),
    ("onehot_fwd", KERNEL_NAMES["onehot_fwd"]),
    ("onehot_bwd", KERNEL_NAMES["onehot_bwd"]),
    ("segscan", KERNEL_NAMES["segscan"]),
    ("gemm", ("gemm", "sm90", "sm80", "cutlass", "cublas", "splitk", "xmma", "nvjet")),
    ("sort", ("sort", "radix")),
    ("index", ("index", "scatter", "gather", "embedding")),
    ("reduce", ("reduce",)),
    ("copy", ("memcpy", "memset", "copy")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "elementwise/other"


def trace(rm, inputs) -> dict:
    """Build, warm up and trace on this rank (`inputs["args"]`: the command
    line as JSON); rank 0 profiles and returns the summary as JSON, the
    other ranks run the same steps."""
    import contextlib
    from types import SimpleNamespace

    from hugectr_tpu_torch.core import mesh
    from hugectr_tpu_torch.tools.flagship import bench_settings, build_dlrm_dcnv2, build_dlrm_ftrl

    args = SimpleNamespace(**json.loads(inputs["args"]))
    n = dict(batchsize=args.batch, synthetic_batches=args.steps + 2, max_eval_batches=args.steps + 2)
    if args.model == "dlrm_ftrl":
        model = build_dlrm_ftrl(rm, dynamic=args.dynamic, **n)
    else:
        kw = bench_settings() if args.bench else dict(vocab_cap=2_000_000)
        model = build_dlrm_dcnv2(rm, **dict(kw, **n))
    for _ in range(2):
        model.train()
    if args.eval:
        batches = list(model._eval_batches())

        def step(i):
            loss, preds, labels = model._eval_step(batches[i % len(batches)])
            model.metrics.update(preds, labels, loss=loss)
        model.metrics.reset()
        step(0)
    else:
        def step(i):
            model.train()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts) if rm.is_master_process() else None
    with prof or contextlib.nullcontext():
        t0 = time.perf_counter()
        for i in range(args.steps):
            step(i + 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    if prof is None:
        return {}
    # device-side rows only (kernels, copies, memsets): the CPU-side rows
    # carry the same device time again as the kernels they launched
    kernels = collections.Counter()
    n_events = 0
    for evt in prof.key_averages():
        # NCCL's device-side annotations ("nccl:all_reduce", ...) span its
        # kernels, which are counted already
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.key.startswith("nccl:"):
            kernels[evt.key] += evt.self_device_time_total / 1e3 / args.steps
            n_events += evt.count
    busy = sum(kernels.values())
    cats = collections.Counter()
    for name, ms in kernels.items():
        cats[category(name)] += ms
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    out = dict(
        card=card, device_count=torch.cuda.device_count(), world=rm.num_devices, backend=mesh.backend() or "",
        model=args.model, dynamic=args.dynamic, batch=args.batch, bench=args.bench,
        traced="eval" if args.eval else "train",
        steps=args.steps, ms_per_step=wall_ms,
        device_events=n_events, device_events_per_step=n_events / args.steps,
        device_busy_ms_per_step=busy,
        device_idle_share=max(0.0, 1.0 - busy / wall_ms),
        by_category_ms=dict(cats.most_common()),
        top_kernels_ms=dict(kernels.most_common(25)),
        routes=dict(model.ec.group_routes),
    )
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "trace_step.json"))
    return {"summary": json.dumps(out)}  # kernel names may hold any character


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="")
    ap.add_argument("--bench", action="store_true", help="the flagship as bench.py configures it")
    ap.add_argument("--eval", action="store_true", help="trace eval batches instead of training steps")
    ap.add_argument("--model", choices=("dlrm_dcnv2", "dlrm_ftrl"), default="dlrm_dcnv2")
    ap.add_argument("--dynamic", action="store_true", help="dlrm_ftrl with exact dynamic tables")
    ap.add_argument("--world", type=int, default=1, help="ranks (one process each); rank 0 is traced")
    args = ap.parse_args()
    if (args.bench and args.model != "dlrm_dcnv2") or (args.dynamic and args.model != "dlrm_ftrl"):
        ap.error("--bench is a dlrm_dcnv2 setting, --dynamic a dlrm_ftrl one")

    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools import hybrid

    inputs = {"args": json.dumps(vars(args))}
    if args.world > 1:
        res = hybrid.run(trace, args.world, inputs, timeout=1800.0)[0]
    else:
        res = trace(ResourceManager.create(), inputs)
    out = json.loads(res["summary"])
    print(json.dumps(out), flush=True)
    if args.out:
        with open(os.path.join(args.out, "trace_step_summary.json"), "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
