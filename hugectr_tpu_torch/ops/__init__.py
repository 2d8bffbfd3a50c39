"""Hand-written kernels of the port and their launch counters.

`launch_counts()` counts kernel launches (CUDA tensors); `plain_counts()`
counts calls that took a kernel's plain version (CPU tensors).
"""
from __future__ import annotations

from typing import Dict

from . import onehot_matmul, ordered_pool, segscan

_MODULES = (segscan, onehot_matmul, ordered_pool)


def launch_counts() -> Dict[str, int]:
    return {k: v for m in _MODULES for k, v in m.LAUNCHES.items()}


def plain_counts() -> Dict[str, int]:
    return {k: v for m in _MODULES for k, v in m.PLAIN_CALLS.items()}


def reset_counts() -> None:
    for m in _MODULES:
        for d in (m.LAUNCHES, m.PLAIN_CALLS):
            for k in d:
                d[k] = 0
