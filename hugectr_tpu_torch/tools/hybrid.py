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
returns what a comparison with another run needs. `parity_runs` trains a
tiny model (`tiny_config`) on one device and on W ranks from one state,
and `parity_report` says how far apart they are; `full_width_config` and
`path_summary` run and describe a full-width model over W ranks.

On the command line, `python -m hugectr_tpu_torch.tools.hybrid --world 2
[--model tiny | tiny_bench | tiny_partial] [--device cpu] [--backend
gloo]` prints that report; `--model dlrm_dcnv2 | bench | dlrm_ftrl
[--dynamic] [--fwd-partition 0] [--time-forward]` trains that full-width
model over the ranks, with the masked-gather forward for
`--fwd-partition 0`, and prints its summary (on the card), with the
embedding forward's own times for `--time-forward`. `--fwd-partition-ab
[--out DIR]` compares the two forwards in one call: it trains the
full-width model four times, a fresh group each, with `fwd_partition`
off, on, on, off (so drift within the call falls on both sides), timing
the forward alone too, and prints one JSON line a run (the setting,
ms/step, the forward's host and device ms, the collectives' calls and
bytes a step, eval ex/s, finite losses, equal replicas); with `--out`,
each run's whole summary goes to a file there.

The meshes: `--num-slices 2 --comm-strategy hierarchical` puts the ranks
on the (dcn, ici) mesh with the two-level exchange, `--ev-parallelism e`
on the ("data", "ev") mesh, `--column-factor 2` splits the f32 flagship's
sorted-route tables column-wise (`layout`, `full_width_config`), and
`--hosts H` starts the ranks as on H hosts (`LOCAL_WORLD_SIZE` W / H, the
multi-host reader rule). `mesh_parity_runs` (`chip_smoke.py`'s
mesh_parity) trains the tiny model on one device, on 4 ranks flat,
hierarchical and ("data", "ev"), and on 2 ranks, all on the global batches
of 2 hosts.

`exchange_checks` is the rank function of the exchanges' checks on the
card (`chip_smoke.py`'s hybrid_exchange_parity): the owner-partitioned
forward against the masked gather, the kernels on each rank's inputs, and
`collection_run` of the dense exchange and of the capacity factor.
"""
from __future__ import annotations

import hashlib
import importlib
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


def _rank_main(rank: int, fn: Callable, world: int, backend: str, device: str, tmp: str,
               local_world_size: int = 0) -> None:
    import torch.distributed as dist

    from ..core.mesh import ResourceManager, init_distributed

    if device == "cpu":
        torch.set_num_threads(1)  # W ranks share the host's cores
    if local_world_size:  # ranks as on world / local_world_size hosts
        os.environ["LOCAL_WORLD_SIZE"] = str(local_world_size)
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
        timeout: float = 600.0, hosts: int = 1) -> List[Tree]:
    """fn(rm, inputs) on `world` spawned ranks; their results in rank order.
    `backend` defaults to `default_backend(world, device)`. With `hosts` H
    the ranks take `LOCAL_WORLD_SIZE` W / H, as ranks on H hosts do (the
    multi-host reader rule, `Model._make_reader`)."""
    import torch.multiprocessing as mp

    backend = backend or default_backend(world, device)
    if world % hosts:
        raise ValueError(f"{world} ranks do not split over {hosts} hosts")
    local = world // hosts if hosts > 1 else 0
    with tempfile.TemporaryDirectory(prefix="hctr_hybrid_") as tmp:
        save_tree(os.path.join(tmp, "inputs.npz"), inputs or {})
        ctx = mp.start_processes(_rank_main, args=(fn, world, backend, device, tmp, local), nprocs=world,
                                 join=False, start_method="spawn")
        t0 = time.monotonic()
        while not ctx.join(timeout=1.0):  # raises if a rank failed, stopping the others
            if time.monotonic() - t0 > timeout:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"{world} ranks ran past {timeout} s")
        return [load_tree(os.path.join(tmp, f"result_{r}.npz")) for r in range(world)]


def jsonable(node: Any) -> Any:
    """A result tree with its arrays as (nested) lists, for `json.dumps`."""
    if isinstance(node, dict):
        return {k: jsonable(v) for k, v in node.items()}
    return node.tolist() if isinstance(node, (np.ndarray, np.generic)) else node


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


def shard_replicas(model) -> Dict[str, np.ndarray]:
    """The storage and state of this rank's shard of each model-parallel
    group that has replicas (a partial placement, or any group on the
    ("data", "ev") mesh), keyed by group and shard
    (`"table:{group}@{shard}"`): ranks that hold the same shard must hold
    the same bits."""
    out = {}
    rm = model.rm
    if model.ec is None or rm.num_devices == 1:
        return out
    for g in model.ec.plan.groups:
        if g.is_model_parallel and (g.num_replicas > 1 or rm.ev_parallel_size > 1):
            s = model.ec._meta[g.name].shard
            out[f"table:{g.name}@{s}"] = model.tables[g.name].detach().float().cpu().numpy()
            for k, t in model.eopt[g.name].items():
                out[f"eopt:{g.name}.{k}@{s}"] = t.float().cpu().numpy()
    return out


def _sync(rm) -> None:
    if rm.device.type == "cuda":
        torch.cuda.synchronize(rm.device)


def builder_kwargs(cfg: Tree) -> Dict[str, Any]:
    """A config's builder keyword arguments, its `reader` (the fields of a
    `DataReaderParams`, `async_param` those of an `AsyncParam`) as the
    builder's `reader=`."""
    from ..core.config import AsyncParam, DataReaderParams

    kw = dict(cfg.get("kwargs", {}))
    if cfg.get("reader"):
        rp = dict(cfg["reader"])
        if rp.get("async_param"):
            rp["async_param"] = AsyncParam(**rp["async_param"])
        kw["reader"] = DataReaderParams(**rp)
    return kw


def train_model(rm, inputs: Tree) -> Tree:
    """Rank function: `inputs["config"]` (JSON) names a builder of
    `tools/flagship.py` (or of the tools module `module`, e.g. "samples")
    and its keyword arguments (`kwargs`, `reader`: `builder_kwargs`), the training
    `steps`, whether to `eval`, and with `export` false leaves the tables
    and dense parameters out of the result; `inputs["state"]`, if given, is
    a carried state (`tools/carry.py`, global arrays of `state_shards`
    ranks, default W), and `inputs["table_state"]` one carried by table
    (`export_table_state`). Launch counts and the collectives' calls and
    bytes are set to 0 just before the steps and read just after, and again
    around the eval. Returns the losses, each step's seconds
    (synchronised), the eval's metrics and seconds, the launch and
    plain-call counts, the collectives' calls and bytes, the update routes,
    the peak device memory, every user table in key order and the dense
    parameters (`export`), this rank's replicated arrays
    (`replicated_arrays`) or, with `digest`, their SHA-256; with
    `storage`, this rank's storage, key stores and state; for dynamic
    tables, each step's store fill and dropped keys of this rank's shard
    (`EmbeddingCollection.dynamic_stats`) and its key stores; with
    `kernel_check`, each kernel held against its plain version at this
    rank's shapes after the run (`kernel_parity`); with `auc_both`, the
    binned and the exact AUC of the eval's buffers; with `carry_out`, the
    trained state (`export_state`, `final_state`); given
    `inputs["eval_state"]` (a state of `eval_state_shards` ranks), the eval
    of those weights last (`eval_carried`); with i64 keys, the exact fold's
    maps (`i64_fold_maps`). `shards` holds this rank's
    shard of each group with replicas (`shard_replicas`, digests with
    `digest`). `mesh` ({"num_slices": d} or {"ev_parallelism": e}) puts
    the ranks (W > 1) on that mesh; with `batch_out`, this rank's first
    cached batch is returned (`first_batch`); with `host_batches` H, one
    device trains on the global batches of ranks on H hosts
    (`host_batches`)."""
    from .. import ops
    from ..core import mesh
    from .carry import export_state, load_jax_state, load_table_state

    cfg = json.loads(inputs["config"])
    if rm.num_devices > 1:  # the flat, ("data", "ev") or ("dcn", "ici") mesh, its data axes the default
        from ..core.mesh import ResourceManager

        rm = ResourceManager.create(device=rm.device, **cfg.get("mesh", {}))
    if rm.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(rm.device)
    builders = importlib.import_module(f"{__package__}.{cfg.get('module', 'flagship')}")
    model = getattr(builders, cfg["builder"])(rm=rm, **builder_kwargs(cfg))
    if "state" in inputs:
        load_jax_state(model, inputs["state"], cfg.get("state_shards", 0))
    if "table_state" in inputs:
        load_table_state(model, inputs["table_state"])
    if cfg.get("host_batches") and rm.num_devices == 1:  # one device fed the multi-host global batches
        import itertools

        model._train_iter = itertools.cycle([model._put_now(b) for b in host_batches(model, cfg["host_batches"])])
    model.start_data_reading()
    # one pass over the cached batches leaves their cycle where it was
    batches = [next(model._train_iter) for _ in range(model.train_reader.num_batches)]
    ec = model.ec
    dynamic = ec is not None and any(g.slot_is_dynamic.any() for g in ec.plan.groups)
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
            if dynamic:  # outside the timed step and the collectives' counts
                kept = dict(mesh.COLLECTIVE_CALLS), dict(mesh.COLLECTIVE_BYTES)
                stats.append(ec.dynamic_stats(model.tables, model._feature_keys(batches[len(stats) % len(batches)])))
                for counter, before in zip((mesh.COLLECTIVE_CALLS, mesh.COLLECTIVE_BYTES), kept):
                    counter.clear()
                    counter.update(before)
        return losses, secs

    stats: List[Dict] = []
    (losses, secs), counts = counted(steps)
    out: Tree = {"losses": np.asarray(losses), "step_seconds": np.asarray(secs), **counts}
    if cfg.get("batch_out"):
        out["first_batch"] = {k: v.cpu().numpy() for k, v in batches[0].items()}
    if cfg.get("time_forward"):
        out["forward"] = forward_times(model, batches)
    if cfg.get("eval"):
        t = time.perf_counter()
        out["eval"], out["eval_counts"] = counted(model.eval)
        _sync(rm)
        out["eval_seconds"] = time.perf_counter() - t
        if cfg.get("auc_both"):  # the binned and the exact AUC of the same buffers
            from ..metrics.metrics import auc_score, auc_score_large

            m = model.metrics
            out["auc_binned"] = float(auc_score_large(m._preds, m._labels, m._valid, mesh.all_reduce))
            out["auc_exact"] = float(auc_score(*(m._global(x) for x in (m._preds, m._labels, m._valid))))
    out["routes"] = dict(ec.group_routes)
    if cfg.get("storage"):
        out["storage"] = {k: (t.float() if t.is_floating_point() else t).cpu().numpy() for k, t in model.tables.items()}
        out["state"] = {g: {k: t.float().cpu().numpy() for k, t in st.items()} for g, st in model.eopt.items()}
    if rm.device.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(rm.device)
    if dynamic:
        out["store_fill"] = {g: np.asarray([s[g][0] for s in stats]) for g in stats[0]}
        out["dropped_keys"] = {g: np.asarray([s[g][1] for s in stats]) for g in stats[0]}
        out["key_stores"] = {k: t.cpu().numpy() for k, t in model.tables.items() if k.endswith("#keys")}
    if cfg.get("export", True):
        out["tables"] = {lk.table.name: ec.export_table(model.tables, lk.table.name) for lk in ec.plan.lookups}
        out["dense"] = {f"{layer}.{k}": p.detach().cpu().numpy()
                        for layer, ps in model.network.param_tree().items() for k, p in ps.items()}
    for key, arrays in (("replicated", replicated_arrays(model)), ("shards", shard_replicas(model))):
        if cfg.get("digest"):
            arrays = {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest() for k, v in arrays.items()}
        out[key] = arrays
    if cfg.get("kernel_check"):
        out["kernel_parity"] = kernel_parity(model, batches[0])
    if model._i64_maps:  # the exact i64 fold's maps, as i64_fold_maps.npz holds them
        out["i64_fold_maps"] = model._i64_fold_maps_arrays()
    if cfg.get("carry_out"):
        out["final_state"] = export_state(model)
    if "eval_state" in inputs:  # another run's weights, evaluated here
        load_jax_state(model, inputs["eval_state"], cfg.get("eval_state_shards", 0))
        out["eval_carried"] = model.eval()
    model._close_readers()
    return out


def host_batches(model, hosts: int) -> List[Dict[str, np.ndarray]]:
    """The synthetic global batches of ranks on `hosts` hosts (the
    multi-host rule, `Model._make_reader`): host h's batch of B / H rows from
    seed + 7919 h, the hosts' batches one after another, as a one-device
    model's reader would give them (its seed, vocabularies and batches)."""
    import dataclasses

    from ..data.reader import SyntheticReader

    rp, spec = model.reader_params, model.batch_spec
    host_spec = dataclasses.replace(spec, batch_size=spec.batch_size // hosts)
    readers = [iter(SyntheticReader(host_spec, model._slot_vocabs(), num_batches=rp.synthetic_num_batches,
                                    alpha=rp.synthetic_alpha, seed=(model.solver.seed or 1234) + 7919 * h,
                                    learnable_labels=rp.synthetic_learnable)) for h in range(hosts)]
    out = []
    for _ in range(rp.synthetic_num_batches):
        parts = [next(r) for r in readers]
        out.append({k: np.concatenate([p[k] for p in parts]) for k in parts[0]})
    return out


def forward_times(model, batches, n: int = 10) -> Tree:
    """The embedding collection's forward (its collectives included) over
    the cached batches, n times after a warm-up, every rank together: the
    median host ms of one synchronised forward, and on the card the device
    ms a forward under `torch.profiler`, of every kernel and of NCCL's
    alone (an NCCL kernel's time includes its wait for the other ranks),
    left out where the profile recorded no device activity."""
    import statistics

    rm = model.rm
    fks = [model._feature_keys(model._decode_batch(b)) for b in batches]
    with torch.no_grad():
        model.ec.forward(model.tables, fks[0])
        secs = []
        for i in range(n):
            _sync(rm)
            t = time.perf_counter()
            model.ec.forward(model.tables, fks[i % len(fks)])
            _sync(rm)
            secs.append(time.perf_counter() - t)
        out: Tree = {"host_ms": statistics.median(secs) * 1e3}
        if rm.device.type == "cuda":
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                for i in range(n):
                    model.ec.forward(model.tables, fks[i % len(fks)])
                _sync(rm)
            kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
            if kernels:
                out["device_ms"] = sum(e.self_device_time_total for e in kernels) / 1e3 / n
                out["nccl_device_ms"] = sum(e.self_device_time_total for e in kernels if "nccl" in e.key.lower()) / 1e3 / n
    return out


def model_state(model) -> Dict[str, np.ndarray]:
    """A model's state as this rank holds it, each float array as its
    bits, for bitwise comparisons: every table in key order (`export_rows`;
    every rank calls this together), this rank's key stores and sparse
    optimizer state, the dense parameters and their state, the step."""
    def bits(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu().clone()  # a copy: the model trains on
        if t.is_floating_point():
            t = t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
        return t.numpy()

    out = {}
    ec = model.ec
    for g in ec.plan.groups:
        for t in g.tables:
            out[f"table:{t.name}"] = bits(ec.export_rows(model.tables, t.name))
        if f"{g.name}#keys" in model.tables:
            out[f"keys:{g.name}"] = bits(model.tables[f"{g.name}#keys"])
    for g, st in model.eopt.items():
        for k, t in st.items():
            out[f"eopt:{g}.{k}"] = bits(t)
    for layer, ps in model.network.param_tree().items():
        for k, p in ps.items():
            out[f"dense:{layer}.{k}"] = bits(p)
    for kind, tree in model.dopt.items():
        for layer, ps in tree.items():
            for k, t in ps.items():
                out[f"dopt:{kind}.{layer}.{k}"] = bits(t)
    out["step"] = np.asarray(model._step)
    return out


def state_differs(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> List[str]:
    """The names of the arrays of two `model_state`s that differ."""
    return sorted(k for k, v in a.items() if not np.array_equal(b[k], v))


def snapshot_round_trip(rm, inputs: Tree) -> Tree:
    """Rank function: a model of `tools/flagship.py` (`inputs["config"]`:
    `builder`, `kwargs`) started from the snapshot dir `load` if given,
    moved `skip` batches on and trained `before` steps, then written with
    `download_params_to_files(prefix, iteration)` while this rank's writes
    are counted; then `after` more steps. A second model from seed + 1
    loads the written snapshot. Returns this rank's writes, the losses of
    the `after` steps, the names of the state arrays (`model_state`) that
    differ between the written model and the reloaded one (none, when the
    round trip is bitwise), the reloaded step and the written files' bytes
    and the seconds to write and to load."""
    from ..io import filesystem as iofs
    from . import flagship

    cfg = json.loads(inputs["config"])
    build = getattr(flagship, cfg["builder"])
    model = build(rm, **cfg.get("kwargs", {}))
    if cfg.get("load"):
        model.load_params_from_files(cfg["load"])
    model.start_data_reading()
    for _ in range(cfg.get("skip", 0)):
        next(model._train_iter)
    for _ in range(cfg.get("before", 0)):
        model.train()
    written = model_state(model)
    writes = {"n": 0, "bytes": 0}
    saved = {name: getattr(iofs, name) for name in ("save_npy", "save_npz", "open_file")}

    def counting(name):
        def fn(path, *a, **kw):
            writes["n"] += 1
            return saved[name](path, *a, **kw)
        return fn

    for name in saved:
        setattr(iofs, name, counting(name))
    try:
        _sync(rm)
        t = time.perf_counter()
        model.download_params_to_files(cfg["prefix"], cfg.get("iteration", 0))
        write_s = time.perf_counter() - t
    finally:
        for name, fn in saved.items():
            setattr(iofs, name, fn)
    losses = [model.train() for _ in range(cfg.get("after", 0))]
    again = build(rm, **dict(cfg.get("kwargs", {}), seed=cfg.get("kwargs", {}).get("seed", 0) + 1))
    out_dir = f"{cfg['prefix']}_iter{cfg.get('iteration', 0)}"
    _sync(rm)
    t = time.perf_counter()
    again.load_params_from_files(out_dir)
    _sync(rm)
    load_s = time.perf_counter() - t
    differ = state_differs(written, model_state(again))
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out_dir) for f in fs) \
        if rm.is_master_process() and "://" not in out_dir else 0
    return {"writes": writes["n"], "losses": np.asarray(losses), "differ": json.dumps(differ),
            "arrays": len(written), "step": again._step, "bytes": nbytes, "write_seconds": write_s,
            "load_seconds": load_s}


def _scaled_err(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> float:
    """max |got - want| / (the sum of |inputs| that went into the element)."""
    d = (got.double() - want.double()).abs() / (scale.double() + 1e-30)
    return float(torch.nan_to_num(d, nan=float("inf")).max()) if d.numel() else 0.0


def kernel_parity(model, batch: Dict[str, torch.Tensor], seed: int = 5) -> Tree:
    """Each hand-written kernel against its plain version on this rank's
    inputs of the step (on the card; on the CPU both sides are the plain
    version): the one-hot group's forward on the rank's block of `batch`,
    each one-hot lookup's backward from those keys with a cotangent drawn
    in the table's type, segscan over the owned prefix of each
    sorted-route group's gathered keys (bf16 rows with float32 sums for
    bf16 tables, as the step gives them), and over W > 1 ranks the ordered
    pool of each model-parallel rowop group's owned prefix (the
    owner-partitioned forward's), which must be bitwise. A frozen table's one-hot lookups
    are left out and its slots masked out of the sorted keys, as the step
    does (`EmbeddingCollection.frozen_tables`). Every rank calls this together
    (the keys are all-gathered). Returns, per kernel, the largest error
    scaled by the sum of |inputs| into an element, the largest absolute
    error and the shapes."""
    from ..core.mesh import all_gather
    from ..ops import onehot_matmul as oh
    from ..ops import ordered_pool as op
    from ..ops import segscan as ss

    ec, dev = model.ec, model.device
    fk = model._feature_keys(model._decode_batch(batch))
    gen = torch.Generator(device=dev).manual_seed(seed + model.rm.rank)
    res: Tree = {}

    def note(name, got, want, scale, shape):
        r = res.setdefault(name, {"scaled_err": 0.0, "max_abs_err": 0.0, "shapes": []})
        r["scaled_err"] = max(r["scaled_err"], _scaled_err(got, want, scale))
        if got.numel():
            r["max_abs_err"] = max(r["max_abs_err"], float((got.float() - want.float()).abs().max()))
        r["shapes"].append(shape)

    with torch.no_grad():
        for g in ec.plan.groups:
            table = model.tables[g.name]
            if g.compute_kind == "onehot":
                meta = ec._meta[g.name]
                keys = ec._lookup_keys(g, fk)
                got = oh.onehot_fwd_group(keys, meta.fwd_lookups, table, g.out_width)
                want = oh.onehot_fwd_group_plain(keys, meta.fwd_lookups, table, g.out_width)
                scale = oh.onehot_fwd_group_plain(keys, meta.fwd_lookups, table.float().abs(), g.out_width)
                note("onehot_fwd", got, want, scale, [int(keys[0].shape[0]), len(keys)])
                gkeys = ec._group_keys(g, fk)
                valid, _owner, local_row = ec._slot_placement(g.name, gkeys)
                for lm in g.lookups:
                    if ec._is_frozen(g.tables[lm.table_index].name):
                        continue
                    v = int(g.table_vocab[lm.table_index])
                    k_rel = ec._onehot_local_keys(g, lm, valid, local_row)
                    d = torch.randn((k_rel.shape[0], g.ev_size), generator=gen, device=dev).to(table.dtype)
                    got, cnt = oh.onehot_matmul_bwd(k_rel, d, v, torch.float32)
                    want, want_c = oh.onehot_matmul_bwd_plain(k_rel, d, v, torch.float32)
                    scale, _ = oh.onehot_matmul_bwd_plain(k_rel, d.float().abs(), v, torch.float32)
                    if not torch.equal(cnt, want_c):
                        raise AssertionError(f"onehot_bwd counts differ from the plain version ({g.name})")
                    note("onehot_bwd", got, want, scale, [int(k_rel.shape[0]), int(k_rel.shape[1]), v])
            elif ec.group_routes.get(g.name) == "sorted":
                keys = ec._group_keys(g, fk)
                if ec.world > 1:
                    keys = all_gather(keys)
                valid, owner, local_row = ec._slot_placement(g.name, keys, model.tables.get(f"{g.name}#keys"))
                if owner is not None:
                    valid = valid & (owner == ec._meta[g.name].shard)
                frozen = [ec._is_frozen(g.tables[ti].name) for ti in g.slot_table]
                valid = valid & ~torch.as_tensor(frozen, device=dev).unsqueeze(0)
                sidx = torch.sort(local_row[valid]).values  # the owned prefix of the sorted keys
                heads = torch.ones(sidx.shape[0], dtype=torch.bool, device=dev)
                heads[1:] = sidx[1:] != sidx[:-1]
                vals = torch.randn((sidx.shape[0], g.ev_size), generator=gen, device=dev).to(table.dtype)
                got = ss.segmented_sum_sorted(vals, heads, torch.float32)
                want = ss.segmented_sum_sorted_plain(vals, heads, torch.float32)
                scale = ss.segmented_sum_sorted_plain(vals.float().abs(), heads, torch.float32)
                note("segscan", got, want, scale, [int(sidx.shape[0]), int(keys.numel()), g.ev_size])
            if g.compute_kind == "rowop" and g.is_model_parallel and ec.world > 1 and ec.fwd_partition:
                keys = all_gather(ec._group_keys(g, fk))
                srows, offsets, _w = ec._pool_segments(g.name, keys, table.shape[0], model.tables.get(f"{g.name}#keys"))
                n_slots = offsets.numel() - 1
                got = op.ordered_pool(table, srows, offsets)
                want = op.ordered_pool_plain(table, srows, offsets)
                # a zero scale: any difference is an infinite error
                note("ordered_pool", got, want, torch.zeros((), device=dev), [int(srows.shape[0]), n_slots, g.ev_size])
    return res


# The collections of `exchange_checks`, ev 8 (rows as (table, vocab,
# feature, top, combiner, hotness)): the dense exchange on the concat tables
# of tests/test_dense_exchange.py:27-50, the capacity factor on the table of
# the JAX package's test_mp_capacity_slicing_matches_uncapped
# (tests/test_embedding_collection.py:240-272)
DX_SPEC = (("t0", 96, "f0", "e0", "concat", 4), ("t1", 64, "f1", "e1", "concat", 3),
           ("t0", 96, "f2", "e2", "concat", 2))
CAP_SPEC = (("big", 4096, "f0", "e0", "sum", 4),)


def collection_inputs(spec, batch: int, seed: int) -> Tree:
    """Tables (0.1 x normal, key order), a global batch of keys (a fifth of
    them -1) and its cotangents for `collection_run`."""
    rng = np.random.default_rng(seed)
    tables = {t: (rng.normal(size=(v, 8)) * 0.1).astype(np.float32) for t, v, *_ in spec}
    keys = {}
    for _t, v, f, _top, _c, h in spec:
        k = rng.integers(0, v, size=(batch, h)).astype(np.int32)
        k[rng.random((batch, h)) < 0.2] = -1
        keys[f] = k
    d = {top: rng.normal(size=(batch, 8 * (h if c == "concat" else 1))).astype(np.float32)
         for _t, _v, _f, top, c, h in spec}
    return {"tables": tables, "keys": keys, "d": d}


def collection_run(rm, spec, inputs: Tree, **settings) -> Tree:
    """A collection of `spec` (one model-parallel group, AdaGrad on the
    dense sweep) with `settings` (`EmbeddingCollection`'s exchange
    settings), the tables of `inputs` imported: the forward of this rank's
    block of the keys and one update from its block of the cotangents.
    Returns the outputs, the tables in key order and the collectives'
    calls of the two passes."""
    from ..core import mesh
    from ..core.types import Combiner_t, Optimizer_t
    from ..embedding.collection import EmbeddingCollection
    from ..optim.params import OptParams
    from ..parallel import plan as tplan

    cfgs, lookups = {}, []
    for i, (t, v, f, top, c, h) in enumerate(spec):
        cfgs.setdefault(t, tplan.EmbeddingTableConfig(t, v, 8))
        lookups.append(tplan.LookupConfig(i, cfgs[t], f, top, Combiner_t(c), h))
    plan = tplan.compile_plan(lookups, tplan.ShardingPlan([("mp", sorted(cfgs))]), rm.num_devices,
                              onehot_vocab=0, split_vocab=0)
    ec = EmbeddingCollection(plan, rm, OptParams(Optimizer_t.AdaGrad), dense_update_rows=1000,
                             dense_key_ratio=0.0, **settings)
    tables = ec.init(rm.generator(0))
    for name, values in inputs["tables"].items():
        ec.import_table(tables, name, values)
    state = ec.init_optimizer(tables)
    w, r = rm.num_devices, rm.rank

    def block(a):
        n = a.shape[0] // w
        return torch.from_numpy(a[r * n : (r + 1) * n]).to(rm.device)

    feats = {f: block(k) for f, k in inputs["keys"].items()}
    mesh.COLLECTIVE_CALLS.clear()
    outs = ec.forward(tables, feats)
    ec.backward_and_update(tables, state, feats, {k: block(v) for k, v in inputs["d"].items()},
                           torch.tensor(0.3), 1)
    calls = dict(mesh.COLLECTIVE_CALLS)
    return {"fwd": {k: v.cpu().numpy() for k, v in outs.items()}, "calls": calls,
            "tables": {t: ec.export_table(tables, t) for t in sorted(inputs["tables"])}}


def exchange_checks(rm, inputs: Tree) -> Tree:
    """Rank function of the exchanges' checks over W ranks: (1) the tiny
    bench-configured model's forward (`tiny_config("tiny_bench")`) on this
    rank's block of its first batch by the owner-partitioned forward
    against the masked gather: per output, the largest excess of |difference|
    over (h + 4 t) x 2^-8 x S, where h is the slots that feed the output,
    t its tiers and S the same forward of |tables| (each of the h bf16 adds
    rounds by at most 2^-8 of the running |sum|, and each tier's pool, the
    reduce over ranks and the tiers' merge add a few roundings more); (2)
    `kernel_parity` of the same model and batch (the ordered pool bitwise);
    (3) `collection_run` of `DX_SPEC` with the dense exchange's lists of 64
    rows and of 2 (inputs["dx"]); (4) of `CAP_SPEC` with capacity factor
    1.25 and without one (inputs["cap"])."""
    from . import flagship

    model = flagship.build_dlrm_dcnv2(rm, **tiny_config("tiny_bench")["kwargs"])
    model.start_data_reading()
    batch = next(model._train_iter)
    fk = model._feature_keys(model._decode_batch(batch))
    ec = model.ec
    hot = {lm.top_name: lm.hotness for g in ec.plan.groups for lm in g.lookups}
    tiers = dict.fromkeys(hot, 1)
    for m in ec.plan.merges:
        hot[m.top_name] = sum(hot.pop(s) for s in m.sub_tops)
        tiers[m.top_name] = len(m.sub_tops)
    with torch.no_grad():
        part = ec.forward(model.tables, fk)
        ec.fwd_partition = False
        masked = ec.forward(model.tables, fk)
        scale = ec.forward({k: t.abs() if t.is_floating_point() else t for k, t in model.tables.items()}, fk)
        ec.fwd_partition = True
    excess, diff, differing = -np.inf, 0.0, 0
    for top, p in part.items():
        d = (p.float() - masked[top].float()).abs()
        lim = (hot[top] + 4 * tiers[top]) * 2.0**-8 * scale[top].float()
        excess = max(excess, float((d - lim).max()))
        diff = max(diff, float(d.max()))
        differing += int((d > 0).sum())
    out = {"forward_excess": excess, "forward_max_abs_diff": diff, "forward_outputs_differing": differing,
           "forward_outputs": sum(p.numel() for p in part.values()), "kernel_parity": kernel_parity(model, batch)}
    model._close_readers()
    for cap in (64, 2):
        out[f"dx{cap}"] = collection_run(rm, DX_SPEC, inputs["dx"], dense_exchange_cap=cap)
    for name, factor in (("cap", 1.25), ("nocap", 0.0)):
        out[name] = collection_run(rm, CAP_SPEC, inputs["cap"], capacity_factor=factor)
    return out


# the tiny DLRM-DCNv2 of the parity checks: one-hot for vocab <= 100, the
# other tables one model-parallel group on the sorted (segscan) route
TINY_PARITY = dict(builder="build_tiny_dlrm", steps=3, eval=True,
                   kwargs=dict(batchsize=64, onehot_vocab=100, dense_update_rows=0, dense_key_ratio=0.0))
# AUC with the threshold build_dlrm_dcnv2 sets, and AverageLoss
METRICS = {"auc": 0.80275, "average_loss": 0.0}


def tiny_config(model: str = "tiny", steps: int = 3) -> Tree:
    """The tiny models of the parity checks as `train_model` configs:
    "tiny" (`TINY_PARITY`), "tiny_bench" (`bench_settings()` at
    `flagship.TINY_BENCH`'s size) and "tiny_partial"
    (`flagship.build_tiny_partial`)."""
    from . import flagship

    if model == "tiny":
        return dict(TINY_PARITY, steps=steps)
    if model == "tiny_bench":
        kw = dict(flagship.bench_settings(), **flagship.TINY_BENCH, metrics_spec=METRICS)
        return dict(builder="build_dlrm_dcnv2", steps=steps, eval=True, kwargs=kw)
    if model == "tiny_partial":
        return dict(builder="build_tiny_partial", steps=steps, eval=True, kwargs={})
    raise ValueError(f"unknown tiny model {model!r}")


# the f32 flagship's tables on the sorted route (the others take the one-hot
# engine or the dense sweep), which `--column-factor` splits
SORTED_TABLES = ("0", "9", "10", "19", "21", "22")


def layout(num_slices: int = 1, ev_parallelism: int = 1, comm_strategy: str = "uniform",
           column_factor: int = 1) -> Tree:
    """The mesh and the collection settings of a run, as `full_width_config`
    takes them: the ranks' mesh, the collection's communication strategy
    and a column factor on `SORTED_TABLES`."""
    out: Tree = {}
    if num_slices > 1 or ev_parallelism > 1:
        out["mesh"] = {"num_slices": num_slices, "ev_parallelism": ev_parallelism}
    kw: Tree = {}
    if comm_strategy != "uniform":
        kw["comm_strategy"] = comm_strategy
    if column_factor > 1:
        kw["column_factors"] = {t: column_factor for t in SORTED_TABLES}
    if kw:
        out["kwargs"] = kw
    return out


def full_width_config(model: str, staged: bool, batch: int = 16384, dynamic: bool = False,
                      lay: Tree = None) -> Tree:
    """A full-width model of `tools/flagship.py` over W ranks as a
    `train_model` config: "dlrm_dcnv2" (float32), "bench" (with
    `bench_settings()`) or "dlrm_ftrl" (`dynamic`: exact dynamic tables),
    on the mesh and with the settings of `lay` (`layout`).
    6 steps and a 20-batch eval; 4 and 4 where the collectives are staged
    through the host (`staged`), whose times are then no speed numbers.
    Scalars only (no tables or parameters), replicas as SHA-256 digests."""
    from . import flagship

    steps, eval_batches = (4, 4) if staged else (6, 20)
    lay = lay or {}
    kw = dict(batchsize=batch, synthetic_batches=steps, max_eval_batches=eval_batches, metrics_spec=METRICS,
              **lay.get("kwargs", {}))
    if model == "dlrm_dcnv2":
        builder, kw = "build_dlrm_dcnv2", dict(kw, vocab_cap=2_000_000, optimizer="rowwise_adagrad")
    elif model == "bench":
        builder, kw = "build_dlrm_dcnv2", dict(flagship.bench_settings(), **kw)
    elif model == "dlrm_ftrl":
        builder, kw = "build_dlrm_ftrl", dict(kw, dynamic=dynamic)
    else:
        raise ValueError(f"unknown model {model!r}")
    return dict(builder=builder, steps=steps, eval=True, export=False, digest=True, kwargs=kw,
                **({"mesh": lay["mesh"]} if "mesh" in lay else {}))


def path_summary(ranks: List[Tree], cfg: Tree) -> Tree:
    """What a full-width run over W ranks shows (`full_width_config`):
    rank 0's losses, step times (median of steps 2 on), eval; each rank's
    peak memory, launches in the steps and in the eval; the collectives'
    calls and bytes a step and an eval batch (rank 0); whether every
    replicated array has the same digest on every rank; for dynamic
    tables, each rank's store fill and dropped keys a step."""
    import statistics

    r0 = ranks[0]
    steps, batch = cfg["steps"], cfg["kwargs"]["batchsize"]
    eval_batches = cfg["kwargs"]["max_eval_batches"]
    secs = r0["step_seconds"].tolist()
    steady = statistics.median(secs[1:])
    out = dict(
        world=len(ranks), batch=batch, per_rank_batch=batch // len(ranks), steps=steps,
        eval_batches=eval_batches, losses=r0["losses"].tolist(),
        step_ms=[x * 1e3 for x in secs], median_ms_per_step=steady * 1e3, examples_per_s=batch / steady,
        eval_seconds=r0["eval_seconds"], eval_examples_per_s=eval_batches * batch / r0["eval_seconds"],
        eval=r0["eval"], max_memory_allocated=[r.get("max_memory_allocated") for r in ranks],
        routes=r0["routes"], launches=[r["launches"] for r in ranks],
        eval_launches=[r["eval_counts"]["launches"] for r in ranks],
        collective_calls_per_step={k: v / steps for k, v in r0["collective_calls"].items()},
        collective_bytes_per_step={k: v / steps for k, v in r0["collective_bytes"].items()},
        eval_collective_bytes_per_batch={k: v / eval_batches
                                         for k, v in r0["eval_counts"]["collective_bytes"].items()},
        replicated_arrays=len(r0["replicated"]), fwd_partition=cfg["kwargs"].get("fwd_partition", True),
        forward=r0.get("forward"),
        replicas_equal=all(r["replicated"] == r0["replicated"] for r in ranks[1:]),
        shard_replicas_equal=_shards_equal(ranks),
        finite=all(bool(np.isfinite(r["losses"]).all()) for r in ranks),
    )
    if "store_fill" in r0:
        out["store_fill"] = [{g: v.tolist() for g, v in r["store_fill"].items()} for r in ranks]
        out["dropped_keys"] = [{g: v.tolist() for g, v in r["dropped_keys"].items()} for r in ranks]
    return out


def _shards_equal(ranks: List[Tree]) -> bool:
    """Whether the ranks that hold a shard (`shard_replicas`) hold the same
    bits of it."""
    shards: Dict[str, List] = {}
    for r in ranks:
        for k, v in r.get("shards", {}).items():
            shards.setdefault(k, []).append(v)
    return all(all(np.array_equal(v, vs[0]) for v in vs[1:]) for vs in shards.values())


def parity_runs(world: int, backend: str, device: str = "cuda", config: Tree = None,
                eval_carried: bool = False, hosts: int = 1) -> tuple:
    """`config` (default `TINY_PARITY`) trained by `train_model` in this
    process on one device and on `world` spawned ranks, both from one state
    carried by table (this process's model's initial state,
    `export_table_state`: any placement). With `eval_carried`, the ranks
    then also evaluate the one device's trained weights (`eval_carried`),
    so that one eval set meets the same weights on both. Returns (the
    one-device result, the ranks' results)."""
    from ..core.mesh import ResourceManager
    from . import flagship
    from .carry import export_table_state

    cfg = dict(config or TINY_PARITY)
    rm = ResourceManager.create(device=device)
    model = getattr(flagship, cfg["builder"])(rm, **builder_kwargs(cfg))
    state = export_table_state(model)
    model._close_readers()
    one = train_model(rm, {"config": json.dumps(dict(cfg, carry_out=eval_carried)), "table_state": state})
    inputs = {"config": json.dumps(dict(cfg, eval_state_shards=1)), "table_state": state}
    if eval_carried:
        inputs["eval_state"] = one.pop("final_state")
    return one, run(train_model, world, inputs, backend=backend, device=device, hosts=hosts)


def parity_report(one: Tree, ranks: List[Tree], rtol: float = 1e-4, atol: float = 1e-5) -> Tree:
    """How far W ranks are from one device (`parity_runs`): each step's
    largest |loss| relative difference over the ranks and the largest of
    them, the largest excess over atol + rtol |want| of the tables and
    dense parameters (at most 0 passes), the AUC difference (and, after an
    eval of the one device's weights, that AUC's and AverageLoss's
    difference), whether every replicated array holds the same bits on
    every rank, and whether the ranks that hold a shard of a partial
    placement hold the same bits (`shard_replicas`)."""
    def excess(got, want):
        return float(np.max(np.abs(got - want) - atol - rtol * np.abs(want), initial=-np.inf))

    worst = -np.inf
    for res in ranks:
        for part in ("tables", "dense"):
            for k, want in one[part].items():
                worst = max(worst, excess(res[part][k], want))
    r0 = ranks[0]["replicated"]
    per_step = np.max([np.abs(r["losses"] - one["losses"]) / np.abs(one["losses"]) for r in ranks], axis=0)
    out = dict(
        loss_rel_diffs=per_step.tolist(), loss_rel_diff=float(per_step.max()),
        worst_excess=worst,
        auc_diff=max(abs(r["eval"]["auc"] - one["eval"]["auc"]) for r in ranks) if "eval" in one else None,
        replicas_equal=all(set(r["replicated"]) == set(r0)
                           and all(np.array_equal(r["replicated"][k], v) for k, v in r0.items())
                           for r in ranks[1:]),
        shard_replicas=len({k for r in ranks for k in r.get("shards", {})}),
        shard_replicas_equal=_shards_equal(ranks),
    )
    if "eval_carried" in ranks[0]:
        ev = one["eval"]
        out["carried_auc_diff"] = max(abs(r["eval_carried"]["auc"] - ev["auc"]) for r in ranks)
        if "average_loss" in ev:
            out["carried_average_loss_rel_diff"] = max(
                abs(r["eval_carried"]["average_loss"] - ev["average_loss"]) / abs(ev["average_loss"])
                for r in ranks)
    return out


# the tiny model of the mesh checks: the sorted route and no one-hot group,
# so that no update sums with atomics and runs compare bit for bit
TINY_SORTED = dict(TINY_PARITY, eval=False, export=True, batch_out=True, digest=True,
                   kwargs=dict(TINY_PARITY["kwargs"], onehot_vocab=0))
# 1.0 on one rank and 2^-9 on the three others, one placement a column
SUM_ORDERS = np.where(np.eye(4, dtype=bool), 1.0, 2.0**-9).astype(np.float32)


def mesh_checks(rm, inputs: Tree) -> Tree:
    """Rank function of the mesh checks over 4 ranks: the bf16 all_reduce
    and reduce_scatter of `SUM_ORDERS` (this rank's row), then `train_model`
    of each config in inputs["configs"] (JSON {name: config}) from
    inputs["table_state"]."""
    from ..core import mesh

    x = torch.from_numpy(SUM_ORDERS[rm.rank]).to(rm.device, torch.bfloat16)
    out: Tree = {"bf16_reduce_scatter": mesh.reduce_scatter(x.clone()).float().cpu().numpy(),
                 "bf16_all_reduce": mesh.all_reduce(x).float().cpu().numpy()}
    for name, cfg in json.loads(inputs["configs"]).items():
        out[name] = train_model(rm, {"config": json.dumps(cfg), "table_state": inputs["table_state"]})
    return out


def mesh_parity_runs(backend: str, device: str = "cuda") -> Tree:
    """The meshes on the tiny model (`TINY_SORTED`), every run from one
    carried state and on the global batches of ranks on 2 hosts: one device
    fed them (`host_batches`); 4 ranks started as 2 hosts of 2, flat, as the
    hierarchical (2, 2) mesh with Hierarchical communication and as the
    ("data", "ev") (2, 2) mesh (`mesh_checks`, with the bf16 sums); 2 ranks
    as 2 hosts of 1, flat. Returns the one device's result, the 4 ranks'
    and the 2 ranks'."""
    from ..core.mesh import ResourceManager
    from . import flagship
    from .carry import export_table_state

    rm = ResourceManager.create(device=device)
    model = flagship.build_tiny_dlrm(rm, **TINY_SORTED["kwargs"])
    state = export_table_state(model)
    model._close_readers()
    one = train_model(rm, {"config": json.dumps(dict(TINY_SORTED, host_batches=2)), "table_state": state})
    configs = {"flat": TINY_SORTED, "hier": dict(TINY_SORTED, mesh={"num_slices": 2},
                                                 kwargs=dict(TINY_SORTED["kwargs"], comm_strategy="hierarchical")),
               "ev": dict(TINY_SORTED, mesh={"ev_parallelism": 2})}
    four = run(mesh_checks, 4, {"configs": json.dumps(configs), "table_state": state}, backend=backend,
               device=device, hosts=2)
    two = run(train_model, 2, {"config": json.dumps(TINY_SORTED), "table_state": state}, backend=backend,
              device=device, hosts=2)
    return {"one": one, "four": four, "two": two}


# what `--fwd-partition-ab` prints of each run
AB_KEYS = ("model", "fwd_partition", "backend", "median_ms_per_step", "step_ms", "forward",
           "collective_calls_per_step", "collective_bytes_per_step", "eval_examples_per_s", "finite", "replicas_equal")


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--model", default="tiny",
                    choices=("tiny", "tiny_bench", "tiny_partial", "dlrm_dcnv2", "bench", "dlrm_ftrl", "weighted"))
    ap.add_argument("--dynamic", action="store_true", help="dlrm_ftrl with exact dynamic tables")
    ap.add_argument("--steps", type=int, default=3, help="training steps of a tiny model")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--fwd-partition", type=int, choices=(0, 1), default=1,
                    help="a full-width model's forward: 1 the owner-partitioned one (default), 0 the masked gather")
    ap.add_argument("--time-forward", action="store_true",
                    help="also time the embedding forward alone (`forward_times`)")
    ap.add_argument("--fwd-partition-ab", action="store_true",
                    help="a full-width model with the forward off, on, on, off; one JSON line a run")
    ap.add_argument("--out", default=None, help="with --fwd-partition-ab, a directory for each run's whole summary")
    ap.add_argument("--num-slices", type=int, default=1, help="the ranks as a (dcn, ici) mesh of this many slices")
    ap.add_argument("--ev-parallelism", type=int, default=1, help="the ranks as a (data, ev) mesh of this ev size")
    ap.add_argument("--comm-strategy", choices=("uniform", "hierarchical"), default="uniform",
                    help="hierarchical: the two-level exchange on a (dcn, ici) mesh")
    ap.add_argument("--column-factor", type=int, default=1,
                    help="split the f32 flagship's sorted-route tables (0, 9, 10, 19, 21, 22) column-wise")
    ap.add_argument("--hosts", type=int, default=1,
                    help="start the ranks as on this many hosts (LOCAL_WORLD_SIZE = world / hosts)")
    ap.add_argument("--batch", type=int, default=0, help="weighted: the global batch (default 16,384)")
    ap.add_argument("--vocab", type=int, default=0, help="weighted: the table's rows (default 2,000,000)")
    args = ap.parse_args()
    if args.dynamic and args.model != "dlrm_ftrl":
        ap.error("--dynamic is a dlrm_ftrl setting")
    backend = args.backend or default_backend(args.world, args.device)
    lay = layout(args.num_slices, args.ev_parallelism, args.comm_strategy, args.column_factor)
    head = {"world": args.world, "backend": backend, "model": args.model, "hosts": args.hosts,
            "num_slices": args.num_slices, "ev_parallelism": args.ev_parallelism,
            "comm_strategy": args.comm_strategy, "column_factor": args.column_factor}
    if args.model == "weighted":
        from . import weighted

        cfg = dict(tiers=True, steps=args.steps, seed=0, batch=args.batch or weighted.BATCH,
                   vocab=args.vocab or weighted.VOCAB, dtype="bfloat16")
        ranks = run(weighted.rank_run, args.world, {"config": json.dumps(cfg)}, backend=backend,
                    device=args.device, timeout=1800.0, hosts=args.hosts)
        keys = ("median_ms_per_step", "routes", "launches_per_step", "weighted_launches_per_step",
                "collective_calls_per_step", "peak_memory_bytes", "pool_checks")
        print(json.dumps({**head, **cfg, "staged_through_host": backend == "gloo",
                          "ranks": [{k: jsonable(r[k]) for k in keys} for r in ranks]}))
        return
    if args.model.startswith("tiny"):
        cfg = tiny_config(args.model, args.steps)
        cfg = dict(cfg, kwargs=dict(cfg["kwargs"], **lay.get("kwargs", {})), **{k: v for k, v in lay.items() if k == "mesh"})
        one, ranks = parity_runs(args.world, backend, args.device, cfg, hosts=args.hosts)
        print(json.dumps({**head, "losses": ranks[0]["losses"].tolist(), "eval": ranks[0]["eval"],
                          **parity_report(one, ranks)}))
        return
    for i, partition in enumerate((0, 1, 1, 0) if args.fwd_partition_ab else (args.fwd_partition,)):
        cfg = full_width_config(args.model, backend == "gloo" and args.device == "cuda", dynamic=args.dynamic,
                                lay=lay)
        cfg["kwargs"]["fwd_partition"] = bool(partition)
        cfg["time_forward"] = args.time_forward or args.fwd_partition_ab
        ranks = run(train_model, args.world, {"config": json.dumps(cfg)}, backend=backend, device=args.device,
                    timeout=1800.0, hosts=args.hosts)
        rec = {**head, "dynamic": args.dynamic, "staged_through_host": backend == "gloo", **path_summary(ranks, cfg)}
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"{args.model}_{i}.json"), "w") as f:
                json.dump(rec, f)
        print(json.dumps({k: rec.get(k) for k in AB_KEYS} if args.fwd_partition_ab else rec), flush=True)


if __name__ == "__main__":
    main()
