"""The full-vocabulary MLPerf DLRM-DCNv2 on one card (counterpart of
tools/fullscale_dryrun.py).

The JAX tool builds `build_dlrm_dcnv2(vocab_cap=40_000_000)` with bench.py's
settings on 8 virtual CPU devices at batch 64. Here the same model runs with
`bench_settings()` (bf16 tables and row-wise AdaGrad state, mixed precision,
hot 131,072 / superhot 1,024 / split vocab 16,384, the caps measured on the
first batch) with the JAX tool's headroom of the caps (1.25: it sets
HCTR_TPU_UCAP_FACTOR=auto and leaves HCTR_TPU_UCAP_HEADROOM at its default,
tools/fullscale_dryrun.py:6-9) at bench.py's batch of
16,384 over the process group's ranks (one on a one-card machine). The
tables are uncapped: five of MLPerf's 26 have 40,000,000 rows (0, 9, 19, 20
and 21), 204,184,588 rows in all, 52,271,254,528 bytes of bf16 tables at ev
128. (The JAX tool's docstring says 4 tables and 87.8 M rows; its own print
computes 204,184,588.)

It prints the build and init seconds with the rows total, the bytes of the
tables and of the optimizer state that were allocated beside the plan's and
beside the workspace calculator's prediction for the same tables, each
step's loss and seconds with the kernel launches of the step, the route
map, the measured caps, an eval's examples per second, and the peak device memory; last a JSON
line of all of it. A non-finite loss raises, so the exit code is not 0.

    python -m hugectr_tpu_torch.tools.fullscale_dryrun [--steps 2] [--eval-batches 0]
        [--vocab-cap 40000000] [--batch 16384] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import time

FULL_VOCAB = 40_000_000


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("fullscale_dryrun")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--eval-batches", type=int, default=0, help="a warm-up eval, then a timed one (0: none)")
    p.add_argument("--vocab-cap", type=int, default=FULL_VOCAB)
    p.add_argument("--batch", type=int, default=16384)
    p.add_argument("--device", default=None, help="cuda (the default: the card) or cpu")
    return p.parse_args(argv)


def rows_total(vocab_cap: int) -> int:
    from .flagship import MLPERF_TABLE_SIZES

    return sum(min(v, vocab_cap) for v in MLPERF_TABLE_SIZES)


def settings(args, **overrides) -> dict:
    """`build_dlrm_dcnv2`'s keyword arguments: `bench_settings()` at the
    flags' batch and cap with the JAX tool's headroom, then `overrides`."""
    from .flagship import bench_settings

    kw = dict(bench_settings(), ucap_headroom=1.25, batchsize=args.batch, vocab_cap=args.vocab_cap,
              max_eval_batches=max(args.eval_batches, 1), synthetic_batches=max(args.steps, args.eval_batches, 2))
    kw.update(overrides)
    return kw


def allocated_bytes(model) -> dict:
    """The bytes of the tables (key stores apart) and of the sparse
    optimizer state, and the tables' bytes by the plan."""
    tables = sum(t.numel() * t.element_size() for n, t in model.tables.items() if not n.endswith("#keys"))
    state = sum(t.numel() * t.element_size() for st in model.eopt.values() for t in st.values())
    elem = next(iter(model.tables.values())).element_size()
    plan = sum(int(g.total_local_rows) * g.ev_size * elem for g in model.ec.plan.groups)
    return dict(tables=tables, state=state, plan_tables=plan)


def prediction(kw: dict, world: int) -> dict:
    """The workspace calculator's bytes for the same tables."""
    from .embedding_workspace_calculator import estimate
    from .flagship import MLPERF_MULTI_HOT_SIZES, MLPERF_TABLE_SIZES

    vocabs = [min(v, kw["vocab_cap"]) for v in MLPERF_TABLE_SIZES]
    width = 2 if kw.get("embedding_vec_dtype") == "bfloat16" else 4
    return estimate(vocabs, [kw["ev_size"]] * len(vocabs), MLPERF_MULTI_HOT_SIZES, kw["optimizer"], world,
                    kw["batchsize"], width)


def run(argv=None, overrides=None, step_hook=None, say=print):
    """Build the model, take the steps, evaluate; returns (model, record).
    `overrides` replace `settings()`' values (the tests' small shapes);
    `step_hook(model, i)` runs before step i = 1..steps and once after the
    last (i = steps + 1), outside the timed steps."""
    import torch

    from .. import ops
    from ..core.mesh import ResourceManager
    from .flagship import build_dlrm_dcnv2

    args = parse_args(argv)
    kw = settings(args, **(overrides or {}))
    rm = ResourceManager.create(device=args.device)
    cuda = rm.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(rm.device)

    if cuda:
        torch.cuda.reset_peak_memory_stats(rm.device)
    t0 = time.perf_counter()
    model = build_dlrm_dcnv2(rm, **kw)
    model.start_data_reading()
    sync()
    build_s = time.perf_counter() - t0
    rows = rows_total(kw["vocab_cap"])
    say(f"build+init {build_s:.1f}s; rows total {rows:,}", flush=True)
    got = allocated_bytes(model)
    pred = prediction(kw, rm.num_devices)
    say(f"allocated: tables {got['tables']:,} bytes (plan {got['plan_tables']:,}), optimizer state "
        f"{got['state']:,} bytes", flush=True)
    say(f"calculator: weights {pred['weights']:,} bytes, state {pred['state']:,} bytes, working set "
        f"{pred['working_set']:,} bytes, total {pred['total']:,} bytes", flush=True)

    losses, step_s, launches = [], [], []
    for i in range(1, args.steps + 1):
        if step_hook is not None:
            step_hook(model, i)
        ops.reset_counts()
        sync()
        t = time.perf_counter()
        loss = model.train()
        sync()
        step_s.append(time.perf_counter() - t)
        launches.append(ops.launch_counts() if cuda else ops.plain_counts())
        losses.append(loss)
        say(f"step {i} {step_s[-1]:.3f}s loss {loss} {'launches' if cuda else 'plain calls'} "
            f"{json.dumps(launches[-1], sort_keys=True)}", flush=True)
        if not math.isfinite(loss):
            raise FloatingPointError(f"non-finite loss at step {i}: {loss}")
    if step_hook is not None:
        step_hook(model, args.steps + 1)
    say(f"routes {json.dumps(dict(model.ec.group_routes), sort_keys=True)}", flush=True)
    caps = model.ec.measured_caps()
    say(f"caps {json.dumps(caps, sort_keys=True)}", flush=True)

    ev = {}
    if args.eval_batches:
        model.eval()  # warm-up: makes the eval batches and puts them on the device
        sync()
        t = time.perf_counter()
        vals = model.eval()
        sync()
        dt = time.perf_counter() - t
        n = args.eval_batches * model.solver.batchsize_eval
        ev = dict(eval_batches=args.eval_batches, eval_seconds=dt, eval_examples_per_s=n / dt, eval=vals)
        say(f"eval {args.eval_batches} batches {dt:.3f}s {n / dt:,.0f} ex/s {json.dumps(vals)}", flush=True)
    peak = torch.cuda.max_memory_allocated(rm.device) if cuda else None
    say(f"max_memory_allocated {peak:,} bytes" if peak is not None else "max_memory_allocated not measured (cpu)",
        flush=True)
    rec = dict(
        device=torch.cuda.get_device_name(rm.device) if cuda else "cpu", world=rm.num_devices, batch=args.batch,
        vocab_cap=kw["vocab_cap"], rows_total=rows, build_seconds=build_s, losses=losses,
        step_seconds=step_s, median_ms_per_step=statistics.median(step_s[1:] or step_s) * 1e3,
        launches=launches, routes=dict(model.ec.group_routes), caps=caps, allocated=got,
        calculator={k: pred[k] for k in ("weights", "state", "working_set", "total")},
        max_memory_allocated=peak, **ev,
    )
    say(json.dumps(rec), flush=True)
    return model, rec


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
