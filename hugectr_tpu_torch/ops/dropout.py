"""Dropout's keep mask as a function of (the layer's key, the global step).

The JAX package draws its mask with `jax.random.bernoulli` from the key
folded with the step (hugectr_tpu/model/model.py:801,
hugectr_tpu/layers/core_layers.py:88-97): a function of the step, which the
jitted step traces. The port's step is captured as a CUDA graph, so its mask
is a counter-based hash of the key, the step, read from a device int64 that
the model fills before each step, and the element's global index
(csrc/dropout.cu): a replay draws the mask of the step it runs, and an eager
step and a replay at one step draw the same mask. The two packages' bits
differ; the keep rate and the scaling are the same.

* `dropout_mask(key, step, n, first, keep)`: [n] bool, element i kept when
  mix(mix((first + i) ^ k1) + mix(step ^ k0)) < keep x 2^32 on 32-bit words
  (`mix`: two xorshift-multiply rounds).

The plain version computes the same words in int64 tensor ops (the
multipliers are below 2^31, so every product is exact before its low 32
bits are kept) and gives the kernel's bits.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _lib

LAUNCHES = {"dropout_mask": 0}  # kernel launches (CUDA tensors)
PLAIN_CALLS = {"dropout_mask": 0}  # plain-version calls (CPU tensors)

M32 = 0xFFFFFFFF
MULTIPLIERS = (0x7FEB352D, 0x68E31DA5)


def key_of(seed: int) -> Tuple[int, int]:
    """The two 31-bit words of a layer's seed."""
    return seed & 0x7FFFFFFF, (seed >> 31) & 0x7FFFFFFF


def threshold(keep: float) -> int:
    """The 32-bit word below which an element is kept: keep x 2^32."""
    return min(int(keep * 2.0**32), M32)


def _mix(h: torch.Tensor) -> torch.Tensor:
    """csrc/dropout.cu's `mix32` on int64 words below 2^32."""
    h = h ^ (h >> 16)
    h = (h * MULTIPLIERS[0]) & M32
    h = h ^ (h >> 15)
    h = (h * MULTIPLIERS[1]) & M32
    return h ^ (h >> 16)


def dropout_mask_plain(key: Tuple[int, int], step: torch.Tensor, n: int, first: int, keep: float) -> torch.Tensor:
    idx = torch.arange(first, first + n, dtype=torch.int64, device=step.device)
    s = _mix((step & M32) ^ key[0])
    return _mix((_mix((idx & M32) ^ key[1]) + s) & M32) < threshold(keep)


def dropout_mask(key: Tuple[int, int], step: torch.Tensor, n: int, first: int, keep: float) -> torch.Tensor:
    """[n] bool keep mask of elements first .. first + n - 1 at the step held
    by `step` (a 0-dim int64 tensor on the mask's device) for the layer key
    `key` (two 31-bit ints) and keep probability `keep` in (0, 1)."""
    _lib.require(step.dim() == 0 and step.dtype == torch.int64, "dropout_mask: step is a 0-dim int64")
    _lib.require(0.0 < keep < 1.0, f"dropout_mask: keep {keep} outside (0, 1)")
    if step.device.type == "cpu":
        PLAIN_CALLS["dropout_mask"] += 1
        return dropout_mask_plain(key, step, n, first, keep)
    _lib.require(step.device.type == "cuda", f"unsupported device {step.device}")
    out = torch.empty(n, dtype=torch.bool, device=step.device)
    lib = _lib.library()
    with torch.cuda.device(step.device):
        rc = lib.hctr_dropout_mask(out.data_ptr(), step.data_ptr(), first, n, key[0], key[1], threshold(keep),
                                   _lib.stream_of(step))
    _lib.check(rc, "dropout_mask")
    LAUNCHES["dropout_mask"] += 1
    return out
