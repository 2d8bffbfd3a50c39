"""Trace a full-width training step on the card and break its time down.

Usage (on a machine with a card, from the repo root):

    python -m hugectr_tpu_torch.tools.trace_step [--model dlrm_dcnv2 | dlrm_ftrl | GRAPH] [--dynamic]
        [--batch 16384] [--steps 3] [--bench] [--ucap auto | FACTOR] [--eval] [--graph 1 | 0 | 1,0] [--world W]
        [--out DIR]

Builds the full-width DLRM-DCNv2 (`build_dlrm_dcnv2`, 26 tables, ev 128,
vocab_cap 2M, rowwise AdaGrad, float32; with `--bench`, as bench.py
configures it: `bench_settings()`, bf16 tables and state, mixed precision,
the hot/cold/superhot split, the caps measured on the first batch with a
headroom of 1.05 as tools/trace_step.py:16-17 sets them; `--ucap` sets the
DLRM-DCNv2's `unique_cap_factor` instead, as HCTR_TPU_UCAP_FACTOR does
there: 0 turns the caps off) or, with `--model dlrm_ftrl`, DLRM with FTRL
(`build_dlrm_ftrl`, 26 tables capped at 400,000 rows, hotness 1; with
`--dynamic`, exact dynamic tables of 4,096 rows each) or a sample's graph
(`GRAPH`: a name of `tools/samples.py::GRAPHS`, e.g. `bst` or `neumf`, at
its own sizes; `--batch 2048` is the samples' batch; its step and eval
capture as the flagships' do), runs 2 warm-up steps,
times `--steps` training steps one by one (each synchronised, no profiler),
then traces `--steps` more (with `--eval`: eval batches, the forward of
`Model.eval`) with `torch.profiler`. The steps are the model's default
ones (`--graph 1`): where `Model.step_mode` is "graph", the captured step
replayed (and the captured eval forward); `--graph 0` sets
`use_cuda_graph` False, the eager step on the same code; `--graph 1,0`
traces both on one built model, the captured step first. A step is
`train_async`, so the traced steps wait for the card once, at their end.
Prints one JSON line a mode: the step mode, the untraced
steps' host ms and their median, ms per traced step (host clock around the
traced steps), device busy ms per step (sum of kernel and copy
times), the device idle share, the busy ms outside NCCL's kernels (whose time
includes their wait for the slowest rank), device events (kernels, copies, memsets)
in all and per step, device ms per step by category and by kernel name
(top 25), the host's operators and waits for the card per step (the 25
commonest operators apart), the kernels' launches per traced step, and the
groups with a valid cap. With `--out`, also writes the Chrome trace there.
`profile_steps(model, steps, eval_batches)` does the same for a model
already built (chip_smoke.py's graph-against-eager turns).

With `--world W` the model trains hybrid-parallel on W spawned ranks
(`tools/hybrid.py`; NCCL where there is a card per rank, else gloo with the
ranks sharing the cards and the collectives staged through the host);
`--batch` stays the global batch, every rank runs the steps and rank 0 is
traced. Over NCCL each rank replays its captured step, collectives inside
(`--graph 0`: the eager step); over gloo the steps stay eager. NCCL's
kernels count as the category "collective", and the line gives their
device ms a step (`nccl_ms_per_step`).
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import time

import torch

from .devtime import KERNEL_NAMES
from .samples import GRAPHS

SAMPLE_GRAPHS = {variant or name: (name, variant) for name, variant in GRAPHS}

CATEGORIES = (
    ("collective", ("nccl",)),
    ("onehot_fwd", KERNEL_NAMES["onehot_fwd"]),
    ("onehot_bwd", KERNEL_NAMES["onehot_bwd"]),
    ("segscan", KERNEL_NAMES["segscan"]),
    ("ordered_pool", KERNEL_NAMES["ordered_pool"]),
    ("row_scatter", KERNEL_NAMES["row_scatter"]),
    ("adagrad_rows", KERNEL_NAMES["adagrad_rows"]),
    ("ftrl_rows", KERNEL_NAMES["ftrl_rows"]),
    ("adam_rows", KERNEL_NAMES["adam_rows"]),
    ("dropout_mask", KERNEL_NAMES["dropout_mask"]),
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
    from types import SimpleNamespace

    from hugectr_tpu_torch.tools.flagship import bench_settings, build_dlrm_dcnv2, build_dlrm_ftrl
    from hugectr_tpu_torch.tools.samples import build_sample

    args = SimpleNamespace(**json.loads(inputs["args"]))
    n = dict(batchsize=args.batch, synthetic_batches=2 * args.steps + 2, max_eval_batches=2 * args.steps + 2)
    if args.model == "dlrm_ftrl":
        model = build_dlrm_ftrl(rm, dynamic=args.dynamic, **n)
    elif args.model in SAMPLE_GRAPHS:
        name, variant = SAMPLE_GRAPHS[args.model]
        model = build_sample(name, rm, variant=variant, **n)
    else:
        kw = bench_settings() if args.bench else dict(vocab_cap=2_000_000)
        if args.ucap is not None:
            kw["unique_cap_factor"] = args.ucap if args.ucap == "auto" else float(args.ucap)
        model = build_dlrm_dcnv2(rm, **dict(kw, **n))
    modes = [bool(int(m)) for m in str(args.graph).split(",")]
    model.solver.use_cuda_graph = modes[0]
    for _ in range(2):
        model.train()
    outs = []
    for graph in modes:
        model.solver.use_cuda_graph = graph
        out = profile_steps(model, args.steps, args.eval, rm.is_master_process(), args.out)
        if out is not None:
            outs.append(dict(out, model=args.model, dynamic=args.dynamic, bench=args.bench))
    return {"summary": json.dumps(outs)} if outs else {}  # kernel names may hold any character


def profile_steps(model, steps: int, eval_batches: bool = False, profile: bool = True, out_dir: str = ""):
    """Time `steps` steps of a built, warmed-up model (or, with
    `eval_batches`, eval batches into its accumulators) one by one, then
    trace `steps` more; returns the summary (None where `profile` is
    False: the other ranks run the same steps)."""
    import contextlib

    from hugectr_tpu_torch import ops
    from hugectr_tpu_torch.core import mesh

    rm = model.rm
    if eval_batches:
        source, _feeder, _fed = model._eval_batches()
        batches = list(source)

        def step(i):
            model._eval_update(batches[i % len(batches)])
        model._reset_metrics()
        step(0)
        step(1)  # the eager warm-up batch, then the capture where the forward captures
    else:
        def step(i):
            model.train_async()
    step_ms = []
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(i + 2)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts) if profile else None
    ops.reset_counts()
    with prof or contextlib.nullcontext():
        t0 = time.perf_counter()
        for i in range(steps):
            step(steps + i + 2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = ops.launch_counts()
    if prof is None:
        return None
    # device-side rows only (kernels, copies, memsets): the CPU-side rows
    # carry the same device time again as the kernels they launched
    kernels = collections.Counter()
    n_events = 0
    # the host's side: operators dispatched (aten::*, nested ones included)
    # and the runtime's waits for the card (cuda*Synchronize)
    host_ops, host_syncs = collections.Counter(), 0
    for evt in prof.key_averages():
        # NCCL's device-side annotations ("nccl:all_reduce", ...) span its
        # kernels, which are counted already
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.key.startswith("nccl:"):
            kernels[evt.key] += evt.self_device_time_total / 1e3 / steps
            n_events += evt.count
        elif evt.key.startswith("aten::"):
            host_ops[evt.key] += evt.count / steps
        elif evt.key.startswith("cuda") and "Synchronize" in evt.key:
            host_syncs += evt.count
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
        batch=model.solver.batchsize, step_mode=model.step_mode,
        unique_cap_factor=getattr(model.solver, "unique_cap_factor", 0.0),
        traced="eval" if eval_batches else "train",
        steps=steps, step_ms=step_ms, median_ms_per_step=statistics.median(step_ms), ms_per_step=wall_ms,
        device_events=n_events, device_events_per_step=n_events / steps,
        device_busy_ms_per_step=busy,
        device_idle_share=max(0.0, 1.0 - busy / wall_ms),
        host_ops_per_step=sum(host_ops.values()), host_syncs_per_step=host_syncs / steps,
        top_host_ops=dict(host_ops.most_common(25)),
        by_category_ms=dict(cats.most_common()), nccl_ms_per_step=cats.get("collective", 0.0),
        compute_busy_ms_per_step=busy - cats.get("collective", 0.0),
        top_kernels_ms=dict(kernels.most_common(25)),
        launches_per_step={k: v / steps for k, v in launches.items()},
        valid_caps=dict(model.ec.valid_caps),
        routes=dict(model.ec.group_routes),
    )
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace_step.json"))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="")
    ap.add_argument("--bench", action="store_true", help="the flagship as bench.py configures it")
    ap.add_argument("--ucap", default=None,
                    help="the DLRM-DCNv2's unique_cap_factor: auto or a number, 0 for the caps off")
    ap.add_argument("--eval", action="store_true", help="trace eval batches instead of training steps")
    ap.add_argument("--graph", choices=("1", "0", "1,0"), default="1",
                    help="1: the default step (captured where Model.step_mode is graph); 0: the eager step; "
                         "1,0: both, in that order")
    ap.add_argument("--model", choices=("dlrm_dcnv2", "dlrm_ftrl", *SAMPLE_GRAPHS), default="dlrm_dcnv2")
    ap.add_argument("--dynamic", action="store_true", help="dlrm_ftrl with exact dynamic tables")
    ap.add_argument("--world", type=int, default=1, help="ranks (one process each); rank 0 is traced")
    args = ap.parse_args()
    if ((args.bench or args.ucap is not None) and args.model != "dlrm_dcnv2") or (
            args.dynamic and args.model != "dlrm_ftrl"):
        ap.error("--bench and --ucap are dlrm_dcnv2 settings, --dynamic a dlrm_ftrl one")
    if args.ucap not in (None, "auto"):
        try:
            float(args.ucap)
        except ValueError:
            ap.error(f"--ucap takes auto or a number, not {args.ucap!r}")

    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools import hybrid

    inputs = {"args": json.dumps(vars(args))}
    if args.world > 1:
        res = hybrid.run(trace, args.world, inputs, timeout=1800.0)[0]
    else:
        res = trace(ResourceManager.create(), inputs)
    outs = json.loads(res["summary"])
    for out in outs:
        print(json.dumps(out), flush=True)
    if args.out:
        with open(os.path.join(args.out, "trace_step_summary.json"), "w") as f:
            json.dump(outs[0] if len(outs) == 1 else outs, f, indent=1)


if __name__ == "__main__":
    main()
