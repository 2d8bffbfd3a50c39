"""Diagnostics: tensor histograms, samples and dumps, and the embedding
health check (counterpart of hugectr_tpu/utils/diagnose.py).

`histogram`, `sample` and `dump` take a tensor (any device) or an array and
work on a host copy; `count_nonfinite` counts the NaN and inf elements of
the floating-point tensors of a dict or list (nested), as the JAX
package's does over a pytree.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from ..core.logger import get_logger
from ..core.mesh import all_gather


def _host(arr: Any) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(arr)


def histogram(name: str, arr, bins: int = 20) -> str:
    """Log and return an ASCII histogram of the finite values, with their
    min, max, mean and std and the count of the others (diagnose.py:21)."""
    a = _host(arr).astype(np.float64).ravel()
    finite = a[np.isfinite(a)]
    n_bad = a.size - finite.size
    if finite.size == 0:
        msg = f"{name}: ALL {a.size} values non-finite"
        get_logger().warning(msg)
        return msg
    counts, edges = np.histogram(finite, bins=bins)
    peak = counts.max() or 1
    lines = [
        f"histogram of {name}: shape={tuple(np.shape(_host(arr)))} min={finite.min():.5g} "
        f"max={finite.max():.5g} mean={finite.mean():.5g} std={finite.std():.5g}"
        + (f" NONFINITE={n_bad}" if n_bad else "")
    ]
    for c, lo, hi in zip(counts, edges[:-1], edges[1:]):
        lines.append(f"  [{lo:+.3e}, {hi:+.3e}) {c:>9d} {'#' * int(40 * c / peak)}")
    out = "\n".join(lines)
    get_logger().info(out)
    return out


def sample(name: str, arr, n: int = 10) -> np.ndarray:
    """Log and return `n` evenly spaced values of the flattened tensor
    (diagnose.py:47)."""
    a = _host(arr).ravel()
    idx = np.linspace(0, max(a.size - 1, 0), min(n, a.size)).astype(int)
    vals = a[idx]
    get_logger().info(f"sample of {name}: idx={idx.tolist()} vals={vals.tolist()}")
    return vals


def dump(path: str, arr) -> None:
    """`np.save` of the tensor's host copy (diagnose.py:56)."""
    np.save(path, _host(arr))


def count_nonfinite(tree) -> int:
    """NaN and inf elements over the floating-point tensors (or arrays) of a
    nested dict / list / tuple (diagnose.py:61)."""
    if isinstance(tree, dict):
        return sum(count_nonfinite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_nonfinite(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return int((~torch.isfinite(tree.detach())).sum()) if tree.is_floating_point() else 0
    a = np.asarray(tree)
    return int((~np.isfinite(a)).sum()) if np.issubdtype(a.dtype, np.floating) else 0


def check_embedding_overflow(model) -> Dict[str, float]:
    """Max |value| of each group's table (diagnose.py:71; the reference's
    Model::check_overflow): a dynamic table's key store is left out, and a
    value past 1e4 or not finite is logged. Over W ranks the max is taken
    over every rank's storage (every rank calls this together).
    HCTR_TPU_DISABLE_OVERFLOW_CHECK turns it off, as in the JAX package."""
    if os.environ.get("HCTR_TPU_DISABLE_OVERFLOW_CHECK") or getattr(model, "ec", None) is None:
        return {}
    out = {}
    for gname, arr in model.tables.items():
        if gname.endswith("#keys"):
            continue
        m = arr.detach().abs().max().float().reshape(1)
        out[gname] = float(all_gather(m).max())
        if not np.isfinite(out[gname]) or out[gname] > 1e4:
            get_logger().warning(f"embedding group {gname}: suspicious max |value| {out[gname]}")
    return out
