"""Carry training state into a port `Model`, and out of it.

`load_jax_state` takes `hugectr_tpu.Model.state` brought to the host as a
tree of numpy arrays (e.g. with `jax.device_get`); this module imports no
JAX. The tree holds:

* `emb_tables` {group name: [R, E]} -> `model.tables`, with each dynamic
  group's int32 key store `"{group}#keys"` [R], copied bit for bit;
* `eopt` {group name: {"accum" | "m" | "v" | "z" | "n": ...}} -> `model.eopt`;
* `dense_params` {layer: {weight_i, bias_i, U_i, V_i, b_i, w_i, weight,
  bias, gamma, beta}} -> the network (MLP, MultiCross, InnerProduct,
  WeightMultiply, LayerNorm);
* `dopt` {"accum" | "m" | "v" | "z" | "n": {layer: {key: ...}}} -> `model.dopt`;
* `step` -> the model's step counter;
* `i64_fold_maps` (optional) {"<table>.orig" | "<table>.fold": ...}, the
  exact i64 fold's maps as `i64_fold_maps.npz` holds them (the JAX model's
  `_i64_fold_maps_arrays()`) -> the model's maps.

The two packages name groups and layers alike and keep the same layouts
(MLP weights [fan_in, fan_out], row-wise accumulators [R, 1]), so no array
is transposed; shapes are checked. A SparseEmbedding's table
`sparse_table_<name>` sits in its group like any table. An optimizer
without state (SGD) has no `eopt` / `dopt` entries. A split table's tiers are groups of
their own in both (`mp_ev128_20::cold`, the superhot tier's rows inside the
one-hot group's storage), so they carry like any group. bfloat16 arrays
(numpy's from the JAX package, or torch's) go through float32, which holds
every bfloat16 value, and are rounded back exactly. `export_state` writes a
port model's state as the same tree (bfloat16 as float32), so one port
model can be copied into another (on another device).

Over W ranks a model-parallel group's storage is row-sharded: the JAX
package's global array [W * R_local, E] (and its state, and a dynamic
group's key store) holds rank r's block at rows [r * R_local, (r + 1) *
R_local) (`P(data_axes, None)`), and rank r holds shard r % f of an
f-shard group (f < W: each shard tiled over its W / f replicas). So rank r
copies block r, and `export_state` all-gathers the blocks back into the
global array (every rank calls it together). Replicated groups, the dense
parameters and their state are whole on every rank.
`load_jax_state(..., num_shards=W_src)` takes a state of W_src ranks; at
another rank count a group on every rank (f = W) moves each table's rows
to where the model's shard count puts them (key k of a table on shard
(k + rot) % f at row k // f), so that one state starts a run on one card
and on W ranks alike. A partial placement's groups differ with the rank
count, and a dynamic table's rows follow its hash over the shards: such
states load at their own rank count only. `export_table_state` and
`load_table_state` carry a model's static tables and their state by user
table, in key order, which loads at any rank count and placement.
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


def _group_of(model, name: str):
    """The plan group of a storage array (a key store `"{group}#keys"` is
    its group's), or None."""
    base = name.split("#keys", 1)[0]
    return next((g for g in model.ec.plan.groups if g.name == base), None) if model.ec else None


def _sharded(model, name: str) -> bool:
    """Whether a storage array is row-sharded over the ranks."""
    return model._row_sharded(name)


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


def _rows(model, name: str, arr: Any, w_src: int) -> Any:
    """The rank's rows of a storage array (or its state) from a state of
    `w_src` ranks. At the model's own rank count the plans are the same and
    rank r takes block r (a shard of a partial placement is tiled over its
    replicas in both packages). At another rank count a model-parallel
    group must be on every rank in both (full placement, f = W): its
    static rows move to where the model's shard count puts them."""
    g = _group_of(model, name)
    w = model.rm.data_parallel_size
    if g is not None and g.is_model_parallel and w_src != w:
        if name.endswith("#keys") or g.slot_is_dynamic.any():
            raise ValueError(f"{name}: a dynamic table's rows follow its hash over {w_src} shards; "
                             f"its state loads at {w_src} ranks only")
        if g.num_shards != w:
            raise ValueError(f"{name}: a partial placement's state loads at its own rank count "
                             f"({w_src}); carry it by table (`export_table_state`)")
        arr = _relayout(g, arr, w_src)
    if not _sharded(model, name):
        return arr
    n = model.tables[name].shape[0]
    return np.asarray(arr)[model.rm.data_index * n : (model.rm.data_index + 1) * n]


@torch.no_grad()
def load_jax_state(model, state: Dict[str, Any], num_shards: int = 0) -> None:
    """Overwrite `model`'s parameters and optimizer state with `state`,
    whose model-parallel arrays are laid out for `num_shards` shards
    (default: the model's rank count)."""
    w_src = num_shards or model.rm.data_parallel_size
    differ = set(state["emb_tables"]) ^ set(model.tables)
    if differ:
        raise ValueError(f"the state's groups and the model's differ in {sorted(differ)}: a partial "
                         "placement's groups change with the rank count; carry it by table (export_table_state)")
    for gname, arr in state["emb_tables"].items():
        _copy(model.tables[gname], _rows(model, gname, arr, w_src), f"table {gname}")
    for gname, st in state.get("eopt", {}).items():
        for k, arr in st.items():
            _copy(model.eopt[gname][k], _rows(model, gname, arr, w_src), f"sparse state {gname}/{k}")
    _load_dense(model, state)


def _load_dense(model, state: Dict[str, Any]) -> None:
    params = model.network.param_tree()
    for layer, ps in state["dense_params"].items():
        for k, arr in ps.items():
            _copy(params[layer][k], arr, f"dense param {layer}/{k}")
    for kind, tree in state.get("dopt", {}).items():
        for layer, ps in tree.items():
            for k, arr in ps.items():
                _copy(model.dopt[kind][layer][k], arr, f"dense state {kind}/{layer}/{k}")
    model._step = int(np.asarray(state["step"]))
    if "i64_fold_maps" in state:
        model._restore_i64_fold_maps(state["i64_fold_maps"])


def _dense_host(model) -> Dict[str, Any]:
    return {
        "dense_params": {
            layer: {k: _host(p) for k, p in ps.items()}
            for layer, ps in model.network.param_tree().items()
        },
        "dopt": {
            kind: {layer: {k: _host(t) for k, t in ps.items()} for layer, ps in tree.items()}
            for kind, tree in model.dopt.items()
        },
        "step": model._step,
        **({"i64_fold_maps": maps} if (maps := model._i64_fold_maps_arrays()) else {}),
    }


def _host(t: torch.Tensor, gather: bool = False) -> np.ndarray:
    t = t.detach()
    t = t.float() if t.dtype == torch.bfloat16 else t
    return (all_gather(t) if gather else t).cpu().numpy()


def export_state(model) -> Dict[str, Any]:
    """`model`'s state as the numpy tree `load_jax_state` reads, a sharded
    group's arrays (key stores too) all-gathered (a collective over W
    ranks): the JAX package's global layout at W devices."""
    return {
        "emb_tables": {g: _host(t, _sharded(model, g)) for g, t in model.tables.items()},
        "eopt": {g: {k: _host(t, _sharded(model, g)) for k, t in st.items()} for g, st in model.eopt.items()},
        **_dense_host(model),
    }


def _user_tables(model):
    return sorted({lk.table.name for lk in model.ec.plan.lookups}) if model.ec else []


def export_table_state(model) -> Dict[str, Any]:
    """`model`'s state by user table, independent of the plan: `tables`
    {table: [vocab, E]} and `eopt` {state kind: {table: [vocab, ...]}} in
    key order (`EmbeddingCollection.export_table`, a split table put back
    together), with the dense parameters, their state and the step as in
    `export_state`. It loads into the same model at any rank count and any
    `shard_matrix` (`load_table_state`); static tables only, since a dynamic
    table's rows follow its hash. Over W ranks every rank calls it
    together."""
    ec = model.ec
    if any(g.slot_is_dynamic.any() for g in (ec.plan.groups if ec else [])):
        raise ValueError("a dynamic table has no key order: carry it with export_state")
    kinds = sorted({k for st in model.eopt.values() for k in st})
    return {
        "tables": {t: ec.export_table(model.tables, t) for t in _user_tables(model)},
        "eopt": {k: {t: ec.export_table({g: st[k] for g, st in model.eopt.items() if k in st}, t)
                     for t in _user_tables(model)} for k in kinds},
        **_dense_host(model),
    }


@torch.no_grad()
def load_table_state(model, state: Dict[str, Any]) -> None:
    """Overwrite `model`'s parameters and optimizer state with an
    `export_table_state` tree (each rank writes its shards' rows)."""
    ec = model.ec
    for t, values in state["tables"].items():
        ec.import_table(model.tables, t, values)
    for k, per_table in state["eopt"].items():
        arrays = {g: st[k] for g, st in model.eopt.items() if k in st}
        for t, values in per_table.items():
            ec.import_table(arrays, t, values)
    _load_dense(model, state)
