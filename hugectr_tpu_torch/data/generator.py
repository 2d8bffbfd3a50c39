"""Synthetic key sampler (counterpart of hugectr_tpu/data/generator.py:33).

numpy only; the same generator state gives the same keys as the JAX
package's sampler.
"""
from __future__ import annotations

import numpy as np


def power_law_keys(rng: np.random.Generator, vocab: int, size, alpha: float) -> np.ndarray:
    """Inverse-CDF power-law sampler over [0, vocab) (reference:
    IntPowerLawDataSimulator, include/data_generator.hpp:109-128)."""
    x = rng.random(size)
    mn, mx = 1.0, float(vocab)
    one_m_a = 1.0 - alpha
    y = ((mx**one_m_a - mn**one_m_a) * x + mn**one_m_a) ** (1.0 / one_m_a)
    return np.clip(np.round(y) - 1.0, 0, vocab - 1).astype(np.int64)
