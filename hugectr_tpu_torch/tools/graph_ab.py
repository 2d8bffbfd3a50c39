"""The captured step against the eager one, from one state, in turns: on one
card, or on each of W NCCL ranks (`run`, `failures`).

`run(model, label)` takes a built model that has trained (its caps
measured, its kernels built) and returns one record; `failures(rec)` lists
the breaches that fail it. `chip_smoke.py`'s `graph_ab` runs it on one card
after `main_path`, `bench_path`, the FTRL paths and each sample graph;
`tools/hybrid.py::train_model` with `graph_ab` in its config runs it on
every rank of a full-width hybrid path, each rank in turn with the others
(every collective of the eager step and of the replays meets its peers), so
the turns, the traces and the evals are collective too:

* agreement: each turn's one step from the saved state on one batch,
  turns eager, graph, graph, eager (`TURNS`). The loss is bitwise the same
  in all four (the forward of one state). Each table and state array is
  held against the first eager turn's: in a storage group (a table and its
  state; the dense network) whose arrays agree bitwise between the two
  eager turns and between the two graph turns, the graph turns must equal
  the eager ones bitwise; elsewhere (the dense sweep's and the one-hot
  backward's atomic adds) within 4 x the larger of the two eager turns'
  and the two graph turns' spreads, both measured and printed, and of one
  step of the array's type at its largest value (`ulp`): each mode repeats
  its own order of atomic adds from turn to turn, so both spreads can read
  0 while the two orders differ in the last bit. Over ranks, each turn
  also gives the SHA-256 of every array that ranks hold alike
  (`hybrid.replicated_arrays`, `hybrid.shard_replicas`), to be held equal
  across the ranks;
* ms/step and ex/s of STEPS `train_async` steps a turn (host clock to a
  synchronisation), the graph turns' replays under
  `torch.cuda.set_sync_debug_mode("error")`: no host sync inside them;
  the collectives' calls and bytes a step of each turn (`core/mesh.py`'s
  counters, which a replay adds as its capture did), equal in both modes;
* eval: eager and replayed (`Model.eval`), predictions bitwise equal and
  AUCs equal, then ms a batch and ex/s in turns;
* from `tools/trace_step.py::profile_steps` in each mode, train and eval:
  device-busy ms, idle share, host operators and waits, NCCL's device ms
  per step, each from a trace that an earlier one of the same mode
  confirms (`whole_trace`); the graph's device-busy ms outside NCCL's
  kernels at most BUSY_LIMIT x eager's (an NCCL kernel's time holds its
  wait for the slowest rank, longer where the host paces the step).

The state is restored to the saved one at the end.
"""
from __future__ import annotations

import hashlib
import math
import time

import numpy as np
import torch

from ..core import mesh

STEPS = 5  # timed train steps in each turn
TURNS = ("eager", "graph", "graph", "eager")
TRACE_TAKES = 6  # traces of one mode at most, until two of them agree
# the relative spread two traces of one mode may have in events and in
# device-busy ms: their events have agreed exactly, their busy ms within 2.9%
# (a 3-batch eval trace), where the lost records took 53% of the busy ms
TRACE_AGREE = 0.05
BUSY_LIMIT = 1.1  # graph device-busy ms a step at most this times eager's


def _all(flag: bool) -> bool:
    """Whether `flag` holds on every rank (one uncounted all-gather over
    W ranks; `flag` itself on one)."""
    return all(mesh.gather_ints(int(flag)))


def whole_trace(take):
    """A trace `take()` returns (a `profile_steps` record) that an earlier
    one agrees with within TRACE_AGREE on device events and on device-busy
    ms a step outside NCCL's kernels, else None; with every trace's
    (events, busy ms). An NCCL kernel's time holds its wait for the slowest
    rank, which the host's jitter sets from step to step.
    The profiler now and then loses device records, or adds some: one
    eager trace of the dynamic FTRL step read 6.86 device-busy ms a step
    where the traces around it, before and after, read 14.4-14.5; the
    replayed eval of the GMF sample read 35.33, 40.0, 35.33 and 41.0 device
    events a batch in four traces in a row, where other runs read one count
    in every trace. One mode's traces repeat the same kernels, so a trace
    that lost or gained records disagrees with the others, and two that
    agree (in a row or not) read the same work twice.
    Over W ranks every rank takes as many traces as the slowest to agree
    (each trace runs the step's collectives)."""
    takes, seen, found = [], [], None
    for _ in range(TRACE_TAKES):
        r = take()
        now = (r["device_events_per_step"], r["compute_busy_ms_per_step"])
        takes.append(now)
        if any(all(abs(a - b) <= TRACE_AGREE * max(a, b) for a, b in zip(now, old)) for old in seen):
            found = r
        if _all(found is not None):
            return found, takes
        seen.append(now)
    return None, takes


def state_arrays(model) -> dict:
    """The carried state by name: tables, their optimizer state, the dense
    parameters and their optimizer state (the tensors themselves)."""
    out = {f"table/{k}": v for k, v in model.tables.items()}
    out.update({f"eopt/{g}/{k}": v for g, st in model.eopt.items() for k, v in st.items()})
    out.update({f"param/{lay}/{k}": p.data for lay, ps in model.network.param_tree().items() for k, p in ps.items()})
    out.update({f"dopt/{s}/{lay}/{k}": t for s, tree in model.dopt.items() for lay, ps in tree.items()
                for k, t in ps.items()})
    return out


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def ulp(t: torch.Tensor) -> float:
    """The spacing of t's floating type at t's largest magnitude (0 for an
    integer, empty or all-zero t)."""
    m = float(t.abs().max()) if t.is_floating_point() and t.numel() else 0.0
    return math.ldexp(torch.finfo(t.dtype).eps, math.frexp(m)[1] - 1) if m > 0 else 0.0


def replica_digests(model) -> dict:
    """SHA-256 of every array the ranks hold alike (the replicated arrays
    and each shard's replicas), by name."""
    from .hybrid import replicated_arrays, shard_replicas

    arrays = {**replicated_arrays(model), **shard_replicas(model)}
    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest() for k, v in arrays.items()}


def _counts() -> dict:
    return {"calls": dict(mesh.COLLECTIVE_CALLS), "bytes": dict(mesh.COLLECTIVE_BYTES)}


def run(model, label: str) -> dict:
    """The record of one graph-against-eager run (module docstring) of
    `model`, which `label` names; the model is left on its default step."""
    from .trace_step import profile_steps

    t0 = time.perf_counter()
    ranks = model.rm.num_devices > 1
    arrays = state_arrays(model)
    saved = {k: v.clone() for k, v in arrays.items()}
    step0 = model._step

    def restore(graph: bool):
        for k, v in arrays.items():
            v.copy_(saved[k])
        model._step = step0
        model.solver.use_cuda_graph = graph

    batch = model._next_train_batch()
    first, first_graph, losses, diffs, digests = None, None, [], [], []
    for turn in TURNS:
        restore(turn == "graph")
        model._staged_train_batch = batch
        losses.append(float(model.train_async()))
        if ranks:
            digests.append(replica_digests(model))
        if first is None:
            first = {k: v.clone() for k, v in arrays.items()}
            continue
        diffs.append({k: (bool(torch.equal(v, first[k])), max_abs_diff(v, first[k])) for k, v in arrays.items()})
        if turn == "graph" and first_graph is None:
            first_graph = {k: v.clone() for k, v in arrays.items()}
        elif turn == "graph":
            graph_spread = {k: max_abs_diff(v, first_graph[k]) for k, v in arrays.items()}
            first_graph = None
    g1, g2, e2 = diffs

    def group(k):  # a storage group's table and state, or the dense network
        return k.split("/")[1] if k.startswith(("table/", "eopt/")) else "dense"

    # a group is atomic where any of its arrays differs between the two
    # eager turns or the two graph turns
    spread_groups = {group(k) for k in arrays if not e2[k][0] or graph_spread[k] > 0}
    breaches, atomic, floor = [], [], {}
    for k in arrays:
        eager_spread = e2[k][1]
        if group(k) not in spread_groups:
            if not (g1[k][0] and g2[k][0]):
                breaches.append((k, "eager and graph each bitwise, not with each other", g1[k][1], g2[k][1]))
            continue
        atomic.append(k)
        floor[k] = ulp(first[k])
        lim = 4 * max(eager_spread, graph_spread[k], floor[k])
        if max(g1[k][1], g2[k][1]) > lim:
            breaches.append((k, "past 4 x the spread", g1[k][1], g2[k][1], eager_spread, graph_spread[k]))
    del first
    # ms/step and the collectives a step, in turns
    timing = []
    for turn in TURNS:
        restore(turn == "graph")
        model.train_async()  # the turn's first step outside the clock
        torch.cuda.synchronize()
        mesh.COLLECTIVE_CALLS.clear()
        mesh.COLLECTIVE_BYTES.clear()
        t = time.perf_counter()
        if turn == "graph":
            torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(STEPS):
                model.train_async()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        per_step = {k: {n: v / STEPS for n, v in d.items()} for k, d in _counts().items()}
        timing.append(dict(turn=turn, ms_per_step=dt / STEPS * 1e3,
                           examples_per_s=STEPS * model.solver.batchsize / dt,
                           collective_calls_per_step=per_step["calls"],
                           collective_bytes_per_step=per_step["bytes"]))
    # eval: eager against replayed, then in turns
    restore(False)
    n_eval = model.solver.max_eval_batches * model.solver.batchsize_eval
    ve = model.eval()
    pe = model.metrics._preds.clone()
    model.solver.use_cuda_graph = True
    vg = model.eval()
    eval_bitwise = bool(torch.equal(model.metrics._preds, pe))
    del pe
    eval_timing = []
    for turn in TURNS:
        model.solver.use_cuda_graph = turn == "graph"
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.eval()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        eval_timing.append(dict(turn=turn, ms_per_batch=dt / model.solver.max_eval_batches * 1e3,
                                examples_per_s=n_eval / dt))
    traces, trace_takes = {}, {}
    for turn in ("eager", "graph"):
        for what in ("train", "eval"):
            def take():
                restore(turn == "graph")
                return profile_steps(model, 3, eval_batches=what == "eval")
            r, takes = whole_trace(take)
            trace_takes[f"{turn}_{what}"] = takes
            if r is None:
                raise AssertionError(f"{label}: no two {turn} {what} traces in a row agree: {takes}")
            traces[f"{turn}_{what}"] = {k: r[k] for k in (
                "step_mode", "ms_per_step", "device_busy_ms_per_step", "compute_busy_ms_per_step",
                "device_idle_share", "host_ops_per_step", "host_syncs_per_step", "device_events_per_step",
                "nccl_ms_per_step", "by_category_ms", "launches_per_step")}
    restore(True)
    del saved
    busy_e, busy_g = (traces[f"{m}_train"]["compute_busy_ms_per_step"] for m in ("eager", "graph"))
    rec = dict(
        phase=f"{label}_graph_ab", step_mode=model.step_mode, world=model.rm.num_devices, rank=model.rm.rank,
        turns=list(TURNS), losses=losses,
        losses_bitwise=len(set(losses)) == 1, arrays=len(arrays), atomic_arrays=len(atomic),
        bitwise_arrays=len(arrays) - len(atomic),
        eager_spread_max={k: e2[k][1] for k in atomic}, graph_spread_max={k: graph_spread[k] for k in atomic},
        graph_minus_eager_max={k: max(g1[k][1], g2[k][1]) for k in atomic}, ulp_floor=floor, breaches=breaches,
        train=timing, eval_bitwise=eval_bitwise, auc_eager=ve.get("auc"), auc_graph=vg.get("auc"),
        eval_equal=ve == vg, eval=eval_timing, traces=traces, trace_takes=trace_takes,
        device_busy_graph_over_eager=busy_g / busy_e, seconds=time.perf_counter() - t0,
    )
    if ranks:
        rec["replica_digests"] = digests
    return rec


def failures(rec: dict) -> list:
    """What fails a record of `run`: a step that did not replay, losses not
    bitwise, a breach of the agreement rule, a replayed eval other than the
    eager one, graph device-busy ms past BUSY_LIMIT x eager's, and
    collective calls or bytes a step that differ between the modes."""
    out = []
    if rec["step_mode"] != "graph" or rec["traces"]["graph_train"]["step_mode"] != "graph":
        out.append(f"step mode {rec['step_mode']}")
    if not rec["losses_bitwise"] or rec["breaches"]:
        out.append(f"graph and eager disagree: losses {rec['losses']}, breaches {rec['breaches']}")
    if not (rec["eval_bitwise"] and rec["eval_equal"]):
        out.append(f"replayed eval differs from per-batch eval: {rec['auc_eager']} / {rec['auc_graph']}")
    if rec["device_busy_graph_over_eager"] > BUSY_LIMIT:
        out.append(f"device-busy ms under the graph {rec['device_busy_graph_over_eager']} x eager's")
    per_turn = [(t["collective_calls_per_step"], t["collective_bytes_per_step"]) for t in rec["train"]]
    if any(c != per_turn[0] for c in per_turn):
        out.append(f"collectives a step differ between the turns: {per_turn}")
    return out
