"""The ordered pool of two checkouts on one card, in turns.

Usage (on a machine with a card, from the repo root):

    python -m hugectr_tpu_torch.tools.pool_ab --base DIR [--order ABBA] [--trace N] [--steps 6]
        [--out FILE]

DIR is another checkout of the repo, for example a `git archive` of the
parent commit unpacked into `build/parent`. For each turn of `--order`
(A: DIR, B: this checkout) a child process puts that checkout first on
its path, builds its kernels from its own `csrc/`, and runs this
checkout's `chip_smoke.ordered_pool_cases`: the main paths' cases of the
ordered pool, each bitwise against its plain version, with device ms by
the profiler beside the bound, `embedding_bag` and `index_add_`; its own
case, the compact cold tier's keys on [R, 136] rows (`wide_row_case`:
16-byte aligned rows longer than 256 bytes, beside the smoke's [R, 128]
and [R, 129] ones); then the ordered pool's cases of
`column_kernel_checks` (E 64) and `weighted_kernel_checks` (weighted bf16
tiers). In the first N turns (`--trace N`) the child then runs this checkout's
`tools/trace_step.py --bench` and `--bench --eval` on that checkout's
package, which give the ordered pool's device ms a training step and an
eval batch (category "ordered_pool"). Single readings spread 3-5x between
calls, so compare the two sides only inside one call.

Prints the card's name and power limit, one JSON line a turn, and last a
summary line: each case's device ms on each side, turn by turn (with
`--out`, the same lines to that file, each as its turn ends).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]

CHILD = r"""
import importlib.util, sys
tree, here = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("pool_ab_here", here + "/hugectr_tpu_torch/tools/pool_ab.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod.child(here, int(sys.argv[3]), sys.argv[4])
"""


def load(name: str, path: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def child(here: str, trace: int, steps: str) -> None:
    """One turn, in a process whose path starts with the checkout under
    test: the cases (this checkout's chip_smoke on that checkout's
    package), then the traces; prints one line "POOL_AB {json}"."""
    import numpy as np
    import torch

    from hugectr_tpu_torch.ops import _lib
    from hugectr_tpu_torch.ops import ordered_pool as op

    if not hasattr(op, "pool_plan"):  # a checkout from before the kernel's plan
        op.pool_plan = lambda *args: None
    _lib.library()
    cs = load("chip_smoke_cases", here + "/chip_smoke.py")
    dev = torch.device("cuda")
    res = []
    cs.ordered_pool_cases(torch, np, dev, res)
    wide_row_case(cs, torch, np, dev, res)
    more = []
    cs.column_kernel_checks(torch, np, dev, more)
    cs.weighted_kernel_checks(torch, np, dev, more)
    res += [r for r in more if r["kernel"] == "ordered_pool"]
    out = {"cases": res, "traces": {}}
    if trace:
        import contextlib
        import io

        ts = load("hugectr_tpu_torch.tools.trace_step", here + "/hugectr_tpu_torch/tools/trace_step.py")
        for mode in ("train", "eval"):
            sys.argv = ["trace_step", "--bench", "--steps", steps] + (["--eval"] if mode == "eval" else [])
            torch.cuda.empty_cache()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                ts.main()
            out["traces"][mode] = json.loads(buf.getvalue().strip().splitlines()[-1])
    print("POOL_AB " + json.dumps(out), flush=True)


def wide_row_case(cs, torch, np, dev, results, ld: int = 136) -> None:
    """The compact cold tier of table 20 (bench.py's caps, one card, bf16)
    on the first 128 columns of [R, ld] rows: rows that start on 16 bytes
    but are longer than 256 bytes, beside chip_smoke's [R, 128] and
    `rowwise_pack`'s [R, 129]; bitwise its plain version, device ms by the
    profiler beside the bound."""
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.core.types import Optimizer_t
    from hugectr_tpu_torch.embedding.collection import EmbeddingCollection
    from hugectr_tpu_torch.ops import ordered_pool as op
    from hugectr_tpu_torch.optim.params import OptParams
    from hugectr_tpu_torch.tools.devtime import KERNEL_NAMES, device_ms
    from hugectr_tpu_torch.tools.flagship import BENCH_PLAN, flagship_plan, raw_vocab

    rng = np.random.default_rng(136)
    gen = torch.Generator(device=dev).manual_seed(136)
    plan = flagship_plan(ev_size=cs.E, num_shards=1, **BENCH_PLAN)
    ec = EmbeddingCollection(plan, ResourceManager(dev, 0, 1), OptParams(Optimizer_t.RowWiseAdaGrad),
                             dtype=torch.bfloat16)
    g = next(x for x in plan.groups if x.name == "mp_ev128_20::cold")
    raw = {}
    for lm in g.lookups:
        raw.setdefault(lm.bottom_name, torch.as_tensor(
            cs.power_law(rng, raw_vocab(plan, lm), (cs.B, lm.hotness)).astype(np.int32), device=dev))
    srows, offsets, _w = ec._pool_segments(g.name, ec._group_keys(g, raw), g.total_local_rows, cut=False)
    n, r = offsets.numel() - 1, g.total_local_rows
    table = torch.empty((r, ld), device=dev).normal_(generator=gen).to(torch.bfloat16)[:, :cs.E]
    call = lambda: op.ordered_pool(table, srows, offsets)  # noqa: E731
    got = call()
    owned = srows[srows < r]
    lens = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, torch.repeat_interleave(torch.arange(n, device=dev), offsets.diff()), (srows < r).long())
    ids_read = int(torch.minimum(lens + 1, offsets.diff()).sum())
    uniq = int(torch.unique(owned).numel())
    b_ms, _by = cs.bound(uniq * cs.E * 2 + ids_read * 8 + 8 * (n + 1) + n * cs.E * 2, int(owned.numel()) * cs.E)
    dms, _per_call = device_ms(call, KERNEL_NAMES["ordered_pool"])
    rec = dict(kernel="ordered_pool", case=f"compact_stride{ld}_{g.name}_w1", row_stride=ld,
               owned=int(owned.numel()), unique_rows=uniq, device_ms=dms, bound_ms=b_ms, bound_fraction=b_ms / dms,
               plan=op.pool_plan(cs.E, 2, ld, table.data_ptr(), got.data_ptr(), srows.numel() / n),
               bitwise=bool(torch.equal(cs.bits(torch, got), cs.bits(torch, op.ordered_pool_plain(table, srows, offsets)))),
               bitwise_repeat=bool(torch.equal(cs.bits(torch, call()), cs.bits(torch, got))))
    results.append(rec)
    if not (rec["bitwise"] and rec["bitwise_repeat"]):
        raise AssertionError(f"ordered_pool differs from its plain version: {rec}")


def turn(tree: Path, trace: bool, steps: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", CHILD, str(tree), str(HERE), str(int(trace)), str(steps)],
                          cwd=tree, env=env, capture_output=True, text=True, timeout=1800)
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("POOL_AB ")), None)
    if proc.returncode or line is None:
        raise RuntimeError(f"turn in {tree} failed (rc {proc.returncode}):\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    out = json.loads(line[len("POOL_AB "):])
    for mode, s in out["traces"].items():
        out["traces"][mode] = {k: s[k] for k in ("ms_per_step", "median_ms_per_step", "device_busy_ms_per_step",
                                                 "device_idle_share", "launches_per_step", "by_category_ms")}
        out["traces"][mode]["ordered_pool_ms"] = s["by_category_ms"].get("ordered_pool", 0.0)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, help="the other checkout (side A)")
    ap.add_argument("--order", default="ABBA", help="turns, A the other checkout, B this one")
    ap.add_argument("--trace", type=int, default=0, help="trace bench steps and eval batches in the first N turns")
    ap.add_argument("--steps", type=int, default=6, help="traced steps and eval batches a turn")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if set(args.order) - {"A", "B"}:
        ap.error("--order takes A and B only")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    trees = {"A": Path(args.base).resolve(), "B": HERE}
    turns = []
    if args.out:
        open(args.out, "w").close()
    for i, side in enumerate(args.order):
        out = turn(trees[side], i < args.trace, args.steps)
        rec = dict(turn=i, side=side, tree=str(trees[side]), card=card,
                   cases={c["case"]: {k: c.get(k) for k in ("device_ms", "bound_ms", "bound_fraction", "ms",
                                                           "plain_ms", "library_ms", "library_device_ms",
                                                           "index_add_ms", "index_add_device_ms", "plan",
                                                           "bitwise", "bitwise_repeat", "owned", "unique_rows")}
                          for c in out["cases"]},
                   traces=out["traces"])
        turns.append(rec)
        emit(rec, args.out)
    emit({"card": card, "order": args.order,
          "device_ms": {case: {side: [t["cases"][case]["device_ms"] for t in turns if t["side"] == side]
                               for side in "AB"} for case in turns[0]["cases"]},
          "trace_ordered_pool_ms": [{"side": t["side"], **{m: t["traces"][m]["ordered_pool_ms"] for m in t["traces"]}}
                                    for t in turns if t["traces"]]}, args.out)


def emit(rec: dict, path: str) -> None:
    """Print one JSON line, and add it to `path` (one line a turn, written
    as each turn ends)."""
    line = json.dumps(rec)
    print(line, flush=True)
    if path:
        with open(path, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
