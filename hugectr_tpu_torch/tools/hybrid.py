"""Run a function on W ranks of one process group, each rank a process.

    from hugectr_tpu_torch.tools.hybrid import run
    results = run(fn, world=2, inputs={"x": np.ones(3)}, device="cpu")

`run` spawns W processes (`torch.multiprocessing`, start method "spawn").
Rank r joins a group of W ranks under a `FileStore` in a temporary
directory (`init_distributed(..., init_method="file://...")`: no TCP port,
so groups started by parallel test workers never meet), builds
`ResourceManager.create(device=device)` and calls `fn(rm, inputs)`.
`inputs` and each rank's result are trees (nested dicts) of numpy arrays,
numbers and strings, passed through `.npz` files; `run` returns the
results in rank order. A rank that raises makes `run` raise, after the
other ranks are stopped; so does a group that outlasts `timeout` seconds.

`fn` must be a module-level function of a module that imports no JAX:
each spawned rank imports the module that defines it. The ranks run on the
cards unless `device="cpu"`. `backend` "nccl" takes one card per rank;
"gloo" with `device="cuda"` lets the ranks share the cards (collectives
staged through the host, `core/mesh.py`); the default is NCCL where there
are enough cards.

`train_model` is such a function: it builds one of `tools/flagship.py`'s
models at W ranks, loads a carried state, trains and evaluates, and
returns what a comparison with another run needs. `parity_runs` trains the
tiny DLRM-DCNv2 on one device and on W ranks from one state, and
`parity_report` says how far apart they are.

On the command line, `python -m hugectr_tpu_torch.tools.hybrid --world 2
[--device cpu] [--backend gloo]` prints that report.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

Tree = Dict[str, Any]


def save_tree(path: str, tree: Tree) -> None:
    """A nested dict of arrays, numbers and strings as one `.npz` file, the
    keys joined by '/'."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                if "/" in str(k):
                    raise ValueError(f"key {k!r} holds '/'")
                walk(f"{prefix}{k}/", v)
        else:
            flat[prefix[:-1]] = np.asarray(node)

    walk("", tree)
    np.savez(path, **flat)


def load_tree(path: str) -> Tree:
    """The tree `save_tree` wrote; 0-d arrays come back as Python scalars."""
    out: Tree = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            v = z[key]
            node = out
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = v.item() if v.ndim == 0 else v
    return out


def _rank_main(rank: int, fn: Callable, world: int, backend: str, device: str, tmp: str) -> None:
    import torch.distributed as dist

    from ..core.mesh import ResourceManager, init_distributed

    if device == "cpu":
        torch.set_num_threads(1)  # W ranks share the host's cores
    init_distributed(backend, rank, world, init_method=f"file://{os.path.join(tmp, 'store')}")
    try:
        rm = ResourceManager.create(device=device)
        out = fn(rm, load_tree(os.path.join(tmp, "inputs.npz")))
        save_tree(os.path.join(tmp, f"result_{rank}.npz"), out or {})
    finally:
        dist.destroy_process_group()


def default_backend(world: int, device: str = "cuda") -> str:
    """NCCL where every rank has a card of its own, else gloo (the CPU, or
    ranks that share cards)."""
    return "nccl" if device == "cuda" and torch.cuda.device_count() >= world else "gloo"


def run(fn: Callable, world: int, inputs: Tree = None, backend: str = None, device: str = "cuda",
        timeout: float = 600.0) -> List[Tree]:
    """fn(rm, inputs) on `world` spawned ranks; their results in rank order.
    `backend` defaults to `default_backend(world, device)`."""
    import torch.multiprocessing as mp

    backend = backend or default_backend(world, device)
    with tempfile.TemporaryDirectory(prefix="hctr_hybrid_") as tmp:
        save_tree(os.path.join(tmp, "inputs.npz"), inputs or {})
        ctx = mp.start_processes(_rank_main, args=(fn, world, backend, device, tmp), nprocs=world,
                                 join=False, start_method="spawn")
        t0 = time.monotonic()
        while not ctx.join(timeout=1.0):  # raises if a rank failed, stopping the others
            if time.monotonic() - t0 > timeout:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"{world} ranks ran past {timeout} s")
        return [load_tree(os.path.join(tmp, f"result_{r}.npz")) for r in range(world)]


def replicated_arrays(model) -> Dict[str, np.ndarray]:
    """Every array that is whole on every rank (dense parameters and their
    state, the replicated groups' tables and state), by name, as this rank
    holds it."""
    out = {}
    params = model.network.param_tree()
    for layer, ps in params.items():
        for k, p in ps.items():
            out[f"dense:{layer}.{k}"] = p.detach().cpu().numpy()
    for kind, tree in model.dopt.items():
        for layer, ps in tree.items():
            for k, t in ps.items():
                out[f"dopt:{kind}.{layer}.{k}"] = t.cpu().numpy()
    for g in model.ec.plan.groups if model.ec is not None else ():
        if g.is_model_parallel and model.rm.data_parallel_size > 1:
            continue
        out[f"table:{g.name}"] = model.tables[g.name].detach().float().cpu().numpy()
        for k, t in model.eopt[g.name].items():
            out[f"eopt:{g.name}.{k}"] = t.float().cpu().numpy()
    return out


def _sync(rm) -> None:
    if rm.device.type == "cuda":
        torch.cuda.synchronize(rm.device)


def train_model(rm, inputs: Tree) -> Tree:
    """Rank function: `inputs["config"]` (JSON) names a builder of
    `tools/flagship.py` and its keyword arguments (`kwargs`), the training
    `steps`, whether to `eval`, and with `export` false leaves the tables
    and dense parameters out of the result; `inputs["state"]`, if given, is
    a carried state (`tools/carry.py`, global arrays laid out for
    `state_shards` shards, default W). Launch counts and the collectives'
    calls and bytes are set to 0 just before the steps and read just after,
    and again around the eval. Returns the losses, each step's seconds
    (synchronised), the eval's metrics and seconds, the launch and
    plain-call counts, the collectives' calls and bytes, the update routes,
    the peak device memory, every user table in key order and the dense
    parameters (`export`), and this rank's replicated arrays
    (`replicated_arrays`) or, with `digest`, their SHA-256."""
    from .. import ops
    from ..core import mesh
    from . import flagship
    from .carry import load_jax_state

    cfg = json.loads(inputs["config"])
    if rm.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(rm.device)
    model = getattr(flagship, cfg["builder"])(rm, **cfg.get("kwargs", {}))
    if "state" in inputs:
        load_jax_state(model, inputs["state"], cfg.get("state_shards", 0))
    model.start_data_reading()
    _sync(rm)

    def counted(fn):
        ops.reset_counts()
        mesh.COLLECTIVE_BYTES.clear()
        mesh.COLLECTIVE_CALLS.clear()
        res = fn()
        return res, dict(launches=ops.launch_counts(), plain_calls=ops.plain_counts(),
                         collective_calls=dict(mesh.COLLECTIVE_CALLS),
                         collective_bytes=dict(mesh.COLLECTIVE_BYTES))

    def steps():
        losses, secs = [], []
        for _ in range(cfg.get("steps", 3)):
            t = time.perf_counter()
            losses.append(model.train())  # float(): waits for the step
            _sync(rm)
            secs.append(time.perf_counter() - t)
        return losses, secs

    (losses, secs), counts = counted(steps)
    out: Tree = {"losses": np.asarray(losses), "step_seconds": np.asarray(secs), **counts}
    if cfg.get("eval"):
        t = time.perf_counter()
        out["eval"], out["eval_counts"] = counted(model.eval)
        _sync(rm)
        out["eval_seconds"] = time.perf_counter() - t
    out["routes"] = dict(model.ec.group_routes)
    if rm.device.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(rm.device)
    if cfg.get("export", True):
        out["tables"] = {lk.table.name: model.ec.export_table(model.tables, lk.table.name)
                         for lk in model.ec.plan.lookups}
        out["dense"] = {f"{layer}.{k}": p.detach().cpu().numpy()
                        for layer, ps in model.network.param_tree().items() for k, p in ps.items()}
    rep = replicated_arrays(model)
    if cfg.get("digest"):
        rep = {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest() for k, v in rep.items()}
    out["replicated"] = rep
    return out


# the tiny DLRM-DCNv2 of the parity checks: one-hot for vocab <= 100, the
# other tables one model-parallel group on the sorted (segscan) route
TINY_PARITY = dict(builder="build_tiny_dlrm", steps=3, eval=True,
                   kwargs=dict(batchsize=64, onehot_vocab=100, dense_update_rows=0, dense_key_ratio=0.0))


def parity_runs(world: int, backend: str, device: str = "cuda", config: Tree = None) -> tuple:
    """`config` (default `TINY_PARITY`) trained by `train_model` in this
    process on one device and on `world` spawned ranks, both from one
    carried state (this process's model's initial state). Returns (the
    one-device result, the ranks' results)."""
    from ..core.mesh import ResourceManager
    from . import flagship
    from .carry import export_state

    cfg = dict(config or TINY_PARITY, state_shards=1)
    rm = ResourceManager.create(device=device)
    state = export_state(getattr(flagship, cfg["builder"])(rm, **cfg["kwargs"]))
    inputs = {"config": json.dumps(cfg), "state": state}
    one = train_model(rm, inputs)
    return one, run(train_model, world, inputs, backend=backend, device=device)


def parity_report(one: Tree, ranks: List[Tree], rtol: float = 1e-4, atol: float = 1e-5) -> Tree:
    """How far W ranks are from one device (`parity_runs`): the largest
    |loss| relative difference, the largest excess over atol + rtol |want|
    of the tables and dense parameters (at most 0 passes), the AUC
    difference, and whether every replicated array holds the same bits on
    every rank."""
    def excess(got, want):
        return float(np.max(np.abs(got - want) - atol - rtol * np.abs(want), initial=-np.inf))

    worst = -np.inf
    for res in ranks:
        for part in ("tables", "dense"):
            for k, want in one[part].items():
                worst = max(worst, excess(res[part][k], want))
    r0 = ranks[0]["replicated"]
    return dict(
        loss_rel_diff=max(float(np.max(np.abs(r["losses"] - one["losses"]) / np.abs(one["losses"])))
                          for r in ranks),
        worst_excess=worst,
        auc_diff=max(abs(r["eval"]["auc"] - one["eval"]["auc"]) for r in ranks) if "eval" in one else None,
        replicas_equal=all(set(r["replicated"]) == set(r0)
                           and all(np.array_equal(r["replicated"][k], v) for k, v in r0.items())
                           for r in ranks[1:]),
    )


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    args = ap.parse_args()
    backend = args.backend or default_backend(args.world, args.device)
    one, ranks = parity_runs(args.world, backend, args.device, dict(TINY_PARITY, steps=args.steps))
    print(json.dumps({"world": args.world, "backend": backend, "losses": ranks[0]["losses"].tolist(),
                      "eval": ranks[0]["eval"], **parity_report(one, ranks)}))


if __name__ == "__main__":
    main()
