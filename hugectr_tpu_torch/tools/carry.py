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
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _copy(dst: torch.Tensor, src: Any, what: str) -> None:
    arr = np.array(src)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {arr.shape} != {tuple(dst.shape)}")
    if arr.dtype.name == "bfloat16":  # ml_dtypes' type, which torch does not read
        arr = arr.astype(np.float32)
    dst.copy_(torch.from_numpy(arr).to(dst.dtype))


@torch.no_grad()
def load_jax_state(model, state: Dict[str, Any]) -> None:
    """Overwrite `model`'s parameters and optimizer state with `state`."""
    for gname, arr in state["emb_tables"].items():
        _copy(model.tables[gname], arr, f"table {gname}")
    for gname, st in state["eopt"].items():
        for k, arr in st.items():
            _copy(model.eopt[gname][k], arr, f"sparse state {gname}/{k}")
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
    """`model`'s state as the numpy tree `load_jax_state` reads."""

    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    return {
        "emb_tables": {g: host(t) for g, t in model.tables.items()},
        "eopt": {g: {k: host(t) for k, t in st.items()} for g, st in model.eopt.items()},
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
