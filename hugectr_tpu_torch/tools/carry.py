"""Carry training state into a port `Model`, and out of it.

`load_jax_state` takes `hugectr_tpu.Model.state` brought to the host as a
tree of numpy arrays (e.g. with `jax.device_get`); this module imports no
JAX. The tree holds:

* `emb_tables` {group name: [R, E]} -> `model.tables`, with each dynamic
  group's int32 key store `"{group}#keys"` [R], copied bit for bit;
* `eopt` {group name: {"accum" | "m" | "v" | "z" | "n": ...}} -> `model.eopt`;
* `dense_params` {layer: {weight_i, bias_i, U_i, V_i, b_i}} -> the network;
* `dopt` {"accum" | "m" | "v" | "z" | "n": {layer: {key: ...}}} -> `model.dopt`;
* `step` -> the model's step counter.

The two packages name groups and layers alike and keep the same layouts
(MLP weights [fan_in, fan_out], row-wise accumulators [R, 1]), so no array
is transposed; shapes are checked. A split table's tiers are groups of
their own in both (`mp_ev128_20::cold`, the superhot tier's rows inside the
one-hot group's storage), so they carry like any group. bfloat16 arrays
(numpy's from the JAX package, or torch's) go through float32, which holds
every bfloat16 value, and are rounded back exactly. `export_state` writes a
port model's state as the same tree (bfloat16 as float32), so one port
model can be copied into another (on another device).

Over W ranks a model-parallel group's storage is row-sharded: the JAX
package's global array [f * R_local, E] (and its state) holds shard s at
rows [s * R_local, (s + 1) * R_local) (`P(data_axes, None)`), so rank r
copies that block of its own, and `export_state` all-gathers the shards
back into the global array (every rank calls it together). Replicated
groups, the dense parameters and their state are whole on every rank.
`load_jax_state(..., num_shards=f)` takes a state laid out for f shards
and moves each table's rows to where the model's shard count puts them
(key k of a table on shard (k + rot) % f at row k // f), so that one state
starts a run on one card and on W ranks alike.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.mesh import all_gather


def _copy(dst: torch.Tensor, src: Any, what: str) -> None:
    arr = np.array(src)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {arr.shape} != {tuple(dst.shape)}")
    if arr.dtype.name == "bfloat16":  # ml_dtypes' type, which torch does not read
        arr = arr.astype(np.float32)
    dst.copy_(torch.from_numpy(arr).to(dst.dtype))


def _sharded(model) -> set:
    """Names of the groups whose storage is row-sharded over the ranks."""
    if model.ec is None or model.rm.data_parallel_size == 1:
        return set()
    return {g.name for g in model.ec.plan.groups if g.is_model_parallel}


def _relayout(g, arr: Any, f_src: int) -> np.ndarray:
    """A model-parallel group's global array laid out for `f_src` shards,
    laid out for the group's own shard count; padding rows are 0."""
    arr = np.asarray(arr)
    f = g.num_shards
    rps = [-(-int(v) // f_src) for v in g.table_vocab]
    off_src = np.concatenate([[0], np.cumsum(rps)[:-1]]).astype(np.int64)
    r_src, r_dst = int(sum(rps)), g.total_local_rows
    out = np.zeros((f * r_dst, *arr.shape[1:]), arr.dtype)
    for ti in range(len(g.tables)):
        k = np.arange(int(g.table_vocab[ti]), dtype=np.int64)
        rot = int(g.table_rotation[ti])
        src = (k + rot) % f_src * r_src + off_src[ti] + k // f_src
        dst = (k + rot) % f * r_dst + int(g.local_offsets[ti]) + k // f
        out[dst] = arr[src]
    return out


def _rows(model, gname: str, arr: Any, sharded: set, f_src: int) -> Any:
    """The rank's rows of a group's global array laid out for `f_src`
    shards."""
    g = next((x for x in model.ec.plan.groups if x.name == gname), None) if model.ec else None
    if g is not None and g.is_model_parallel and f_src != g.num_shards:
        arr = _relayout(g, arr, f_src)
    if gname not in sharded:
        return arr
    n = model.tables[gname].shape[0]
    return np.asarray(arr)[model.rm.rank * n : (model.rm.rank + 1) * n]


@torch.no_grad()
def load_jax_state(model, state: Dict[str, Any], num_shards: int = 0) -> None:
    """Overwrite `model`'s parameters and optimizer state with `state`,
    whose model-parallel arrays are laid out for `num_shards` shards
    (default: the model's rank count)."""
    sharded = _sharded(model)
    f_src = num_shards or model.rm.data_parallel_size
    for gname, arr in state["emb_tables"].items():
        _copy(model.tables[gname], _rows(model, gname, arr, sharded, f_src), f"table {gname}")
    for gname, st in state["eopt"].items():
        for k, arr in st.items():
            _copy(model.eopt[gname][k], _rows(model, gname, arr, sharded, f_src), f"sparse state {gname}/{k}")
    params = model.network.param_tree()
    for layer, ps in state["dense_params"].items():
        for k, arr in ps.items():
            _copy(params[layer][k], arr, f"dense param {layer}/{k}")
    for kind, tree in state["dopt"].items():
        for layer, ps in tree.items():
            for k, arr in ps.items():
                _copy(model.dopt[kind][layer][k], arr, f"dense state {kind}/{layer}/{k}")
    model._step = int(np.asarray(state["step"]))


def export_state(model) -> Dict[str, Any]:
    """`model`'s state as the numpy tree `load_jax_state` reads, a sharded
    group's arrays all-gathered (a collective over W ranks)."""
    sharded = _sharded(model)

    def host(t: torch.Tensor, gname: str = "") -> np.ndarray:
        t = t.detach()
        t = t.float() if t.dtype == torch.bfloat16 else t
        return (all_gather(t) if gname in sharded else t).cpu().numpy()

    return {
        "emb_tables": {g: host(t, g) for g, t in model.tables.items()},
        "eopt": {g: {k: host(t, g) for k, t in st.items()} for g, st in model.eopt.items()},
        "dense_params": {
            layer: {k: host(p) for k, p in ps.items()}
            for layer, ps in model.network.param_tree().items()
        },
        "dopt": {
            kind: {layer: {k: host(t) for k, t in ps.items()} for layer, ps in tree.items()}
            for kind, tree in model.dopt.items()
        },
        "step": model._step,
    }
