"""Segmented running sum over rows sorted by segment.

Counterpart of hugectr_tpu/ops/pallas/segscan.py::segmented_sum_sorted. The
kernel is csrc/segscan.cu (single pass with decoupled look-back, bitwise
deterministic; see its note for the bound and design). The plain PyTorch
version beside it serves the CPU and the checks on the card; a CUDA tensor
always takes the kernel.

Contract: ``out[i] = sum(vals[s..i])`` with ``s`` the last head at or before
``i`` (row 0 always starts a segment), summed in float32 and stored in
``out_dtype`` (default ``vals.dtype``; bfloat16 rows may keep float32 sums);
the TAIL row of each segment holds the segment's full sum.
Unlike the Pallas kernel, K needs no padding to a block multiple.

The fixed-shape sorted update (embedding/sparse_optimizer.py) passes two
more inputs: `rowsrc` [K] int64, so that row i is vals[rowsrc[i]] (the
gather of the sorted keys' gradient rows, which the kernel does in its
loads), and `count`, a 0-dim int64 tensor on the device: only rows [0,
count) are scanned and written, and rows past it are left as they are
(the plain version zeroes them). Nothing reads the count on the host.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _lib

LAUNCHES = {"segscan": 0}  # kernel launches (CUDA tensors)
PLAIN_CALLS = {"segscan": 0}  # plain-version calls (CPU tensors)


def segmented_sum_sorted_plain(
    vals: torch.Tensor, heads: torch.Tensor, out_dtype: Optional[torch.dtype] = None,
    count: Optional[torch.Tensor] = None, rowsrc: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """float64 prefix sums minus the prefix before each segment's head
    (each row's head found by a running maximum: no host sync); with
    `count`, rows at or past it are zero."""
    if rowsrc is not None:
        vals = vals[rowsrc]
    k = vals.shape[0]
    out_dtype = out_dtype or vals.dtype
    if k == 0:
        return vals.to(out_dtype, copy=True)
    h = heads.clone()
    h[0] = True
    c = torch.cumsum(vals.double(), dim=0)
    pos = torch.arange(k, device=vals.device)
    head_pos = torch.cummax(torch.where(h, pos, 0), dim=0).values
    before = c[(head_pos - 1).clamp(min=0)] * (head_pos > 0).unsqueeze(1)
    out = (c - before).to(out_dtype)
    if count is not None:
        out = torch.where((pos < count).unsqueeze(1), out, torch.zeros((), dtype=out_dtype, device=out.device))
    return out


def segmented_sum_sorted(
    vals: torch.Tensor, heads: torch.Tensor, out_dtype: Optional[torch.dtype] = None,
    count: Optional[torch.Tensor] = None, rowsrc: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inclusive segmented sums of `vals` [K, E] (f32 or bf16) along sorted
    segments, as `out_dtype` (default vals.dtype; f32 sums of bf16 rows are
    allowed, bf16 sums of f32 rows are not); `heads` [K] bool marks each
    segment's first row. With `rowsrc` [K] int64, vals is [S, E] and row i
    is vals[rowsrc[i]]; with `count` (0-dim int64 on vals' device) only
    rows [0, count) are summed and written."""
    _lib.require(vals.dim() == 2, f"vals must be [K, E], got {tuple(vals.shape)}")
    _lib.require(vals.dtype in _lib.DTYPE_CODE, f"vals dtype {vals.dtype} not f32/bf16")
    k_rows = rowsrc.shape[0] if rowsrc is not None else vals.shape[0]
    _lib.require(
        heads.dtype == torch.bool and heads.shape == (k_rows,),
        f"heads must be bool [{k_rows}], got {heads.dtype} {tuple(heads.shape)}",
    )
    _lib.require(heads.device == vals.device, "vals and heads on different devices")
    for what, t in (("rowsrc", rowsrc), ("count", count)):
        _lib.require(t is None or (t.dtype == torch.int64 and t.device == vals.device),
                     f"{what} must be int64 on {vals.device}")
    _lib.require(count is None or count.dim() == 0, "count must be a 0-dim tensor")
    out_dtype = out_dtype or vals.dtype
    _lib.require(
        out_dtype == vals.dtype or (vals.dtype, out_dtype) == (torch.bfloat16, torch.float32),
        f"segscan: {vals.dtype} rows cannot give {out_dtype} sums",
    )
    if vals.device.type == "cpu":
        PLAIN_CALLS["segscan"] += 1
        return segmented_sum_sorted_plain(vals, heads, out_dtype, count, rowsrc)
    _lib.require(vals.device.type == "cuda", f"unsupported device {vals.device}")
    _lib.require(vals.is_contiguous() and heads.is_contiguous(), "inputs must be contiguous")
    _lib.require(rowsrc is None or rowsrc.is_contiguous(), "rowsrc must be contiguous")
    k, e = k_rows, vals.shape[1]
    out = torch.empty((k, e), dtype=out_dtype, device=vals.device)
    if k == 0 or e == 0:
        return out
    lib = _lib.library()
    with torch.cuda.device(vals.device):
        nbytes = lib.hctr_segscan_scratch_bytes(k, e)
        _lib.require(nbytes >= 0, f"segscan: E = {e} is too wide for one tile in shared memory")
        # tile status flags, aggregates and prefixes; the kernel zeroes the flags
        scratch = torch.empty((nbytes,), dtype=torch.uint8, device=vals.device)
        rc = lib.hctr_segscan(
            _lib.DTYPE_CODE[vals.dtype], _lib.DTYPE_CODE[out_dtype], vals.data_ptr(),
            rowsrc.data_ptr() if rowsrc is not None else None, heads.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), k, count.data_ptr() if count is not None else None, e,
            _lib.vec_width(e, vals, out), _lib.stream_of(vals),
        )
    _lib.check(rc, "segscan")
    LAUNCHES["segscan"] += 1
    return out


def tile_rows() -> int:
    """Rows per tile of the CUDA kernel (the card's edge cases are set by it)."""
    return _lib.library().hctr_segscan_tile_rows()
