"""Embedding health check (the port's copy of the part of
hugectr_tpu/utils/diagnose.py that `Model.check_overflow` needs).
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..core.logger import get_logger
from ..core.mesh import all_gather


def check_embedding_overflow(model) -> Dict[str, float]:
    """Max |value| of each group's table (diagnose.py:78; the reference's
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
