"""Segmented running sum over rows sorted by segment.

Counterpart of hugectr_tpu/ops/pallas/segscan.py::segmented_sum_sorted. The
kernel is csrc/segscan.cu (single pass with decoupled look-back, bitwise
deterministic; see its note for the bound and design). The plain PyTorch
version beside it serves the CPU and the checks on the card; a CUDA tensor
always takes the kernel.

Contract: ``out[i] = sum(vals[s..i])`` with ``s`` the last head at or before
``i`` (row 0 always starts a segment), summed in float32 and stored in
``vals.dtype``; the TAIL row of each segment holds the segment's full sum.
Unlike the Pallas kernel, K needs no padding to a block multiple.
"""
from __future__ import annotations

import torch

from . import _lib

LAUNCHES = {"segscan": 0}  # kernel launches (CUDA tensors)
PLAIN_CALLS = {"segscan": 0}  # plain-version calls (CPU tensors)


def segmented_sum_sorted_plain(vals: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
    """float64 prefix sums minus the prefix before each segment's head."""
    k = vals.shape[0]
    if k == 0:
        return vals.clone()
    h = heads.clone()
    h[0] = True
    c = torch.cumsum(vals.double(), dim=0)
    seg = torch.cumsum(h.long(), dim=0) - 1
    head_pos = torch.nonzero(h).squeeze(1)
    before = c[(head_pos - 1).clamp(min=0)] * (head_pos > 0).unsqueeze(1)
    return (c - before[seg]).to(vals.dtype)


def segmented_sum_sorted(vals: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sums of `vals` [K, E] (f32 or bf16) along sorted
    segments; `heads` [K] bool marks each segment's first row."""
    _lib.require(vals.dim() == 2, f"vals must be [K, E], got {tuple(vals.shape)}")
    _lib.require(vals.dtype in _lib.DTYPE_CODE, f"vals dtype {vals.dtype} not f32/bf16")
    _lib.require(
        heads.dtype == torch.bool and heads.shape == vals.shape[:1],
        f"heads must be bool [{vals.shape[0]}], got {heads.dtype} {tuple(heads.shape)}",
    )
    _lib.require(heads.device == vals.device, "vals and heads on different devices")
    if vals.device.type == "cpu":
        PLAIN_CALLS["segscan"] += 1
        return segmented_sum_sorted_plain(vals, heads)
    _lib.require(vals.device.type == "cuda", f"unsupported device {vals.device}")
    _lib.require(vals.is_contiguous() and heads.is_contiguous(), "inputs must be contiguous")
    k, e = vals.shape
    out = torch.empty_like(vals)
    if k == 0 or e == 0:
        return out
    lib = _lib.library()
    with torch.cuda.device(vals.device):
        nbytes = lib.hctr_segscan_scratch_bytes(k, e)
        _lib.require(nbytes >= 0, f"segscan: E = {e} is too wide for one tile in shared memory")
        # tile status flags, aggregates and prefixes; the kernel zeroes the flags
        scratch = torch.empty((nbytes,), dtype=torch.uint8, device=vals.device)
        rc = lib.hctr_segscan(
            _lib.DTYPE_CODE[vals.dtype], vals.data_ptr(), heads.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), k, e, _lib.vec_width(e, vals, out), _lib.stream_of(vals),
        )
    _lib.check(rc, "segscan")
    LAUNCHES["segscan"] += 1
    return out


def tile_rows() -> int:
    """Rows per tile of the CUDA kernel (the card's edge cases are set by it)."""
    return _lib.library().hctr_segscan_tile_rows()
