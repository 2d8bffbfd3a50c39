"""Hand-written kernels of the port and their launch counters.

`launch_counts()` counts kernel launches (CUDA tensors); `plain_counts()`
counts calls that took a kernel's plain version (CPU tensors);
`weighted_counts()` counts the launches that carried per-key weights.
"""
from __future__ import annotations

from typing import Dict, List

from . import dropout, onehot_matmul, ordered_pool, row_scatter, segscan

_MODULES = (segscan, onehot_matmul, ordered_pool, row_scatter, dropout)


def launch_counts() -> Dict[str, int]:
    return {k: v for m in _MODULES for k, v in m.LAUNCHES.items()}


def plain_counts() -> Dict[str, int]:
    return {k: v for m in _MODULES for k, v in m.PLAIN_CALLS.items()}


def weighted_counts() -> Dict[str, int]:
    return {k: v for m in _MODULES for k, v in getattr(m, "WEIGHTED_LAUNCHES", {}).items()}


def counters() -> List[Dict[str, int]]:
    """The dicts a launch adds to (`LAUNCHES`, `WEIGHTED_LAUNCHES`): a
    captured step keeps what it added and adds it again on every replay."""
    return [d for m in _MODULES for d in (m.LAUNCHES, getattr(m, "WEIGHTED_LAUNCHES", None)) if d is not None]


def reset_counts() -> None:
    for m in _MODULES:
        for d in (m.LAUNCHES, m.PLAIN_CALLS, getattr(m, "WEIGHTED_LAUNCHES", {})):
            for k in d:
                d[k] = 0
