"""Drop-mode row scatters of the fixed-shape sparse update.

The JAX package writes its row updates with XLA scatters in mode="drop"
(hugectr_tpu/embedding/sparse_optimizer.py:408, :486, :705, :746, :788,
:800): an index at or past the table's rows writes nothing. torch has no
such mode, so the port's update took the valid keys out on the host, which
waits for the card. The kernels of csrc/row_scatter.cu take the key lists
at their fixed length and skip those entries instead (see the file's note
for the bound and design):

* `scatter_add_rows(idx, src, vals, rows, dtype)`: a new [rows, E] buffer
  of `dtype` (float32 or bfloat16) holding, for every entry with 0 <=
  idx[i] < rows, vals[src[i]] added into row idx[i] (the dense sweep's
  gradient buffer). On the card the adds are atomic, as `index_add_`'s.
* `adagrad_rows(opt, table, accum, sidx, g, count, lr)`: the AdaGrad or
  RowWiseAdaGrad update, in place, of the rows of a sorted id list sidx [K]
  whose float32 segmented sums are g [K, E]: each segment tail among the
  first `count` entries (a 0-dim int64 tensor on the device) updates its
  row once (the sorted route's `_apply_rows`).

The plain versions beside the kernels serve the CPU and the checks on the
card; they are written without a host sync or a shape that follows the
data (a temporary row past the end takes what the kernels drop), and give
the port's earlier update bitwise: `adagrad_rows_plain` computes every
entry with `sparse_optimizer.update_math` and keeps the tails' results.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.types import Optimizer_t
from . import _lib

LAUNCHES = {"row_scatter": 0, "adagrad_rows": 0}  # kernel launches (CUDA tensors)
PLAIN_CALLS = {"row_scatter": 0, "adagrad_rows": 0}  # plain-version calls (CPU tensors)

ROWWISE = {Optimizer_t.AdaGrad: 0, Optimizer_t.RowWiseAdaGrad: 1}


def scatter_add_rows_plain(idx: torch.Tensor, src: torch.Tensor, vals: torch.Tensor, rows: int,
                           dtype: torch.dtype) -> torch.Tensor:
    """`index_add_` into a buffer with one spare row, which takes every
    entry outside [0, rows), dropped afterwards."""
    tgt = torch.where((idx >= 0) & (idx < rows), idx, rows)
    buf = torch.zeros((rows + 1, vals.shape[1]), dtype=dtype, device=vals.device)
    buf.index_add_(0, tgt, vals[src].to(dtype))
    return buf[:rows]


def scatter_add_rows(idx: torch.Tensor, src: torch.Tensor, vals: torch.Tensor, rows: int,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[rows, E] `dtype` sums of vals[src[i]] ([S, E], float32 or bfloat16,
    each cast to `dtype`) at row idx[i], over the entries with idx in [0,
    rows); idx and src are [K] int64."""
    _lib.require(vals.dim() == 2 and idx.dim() == 1 and src.shape == idx.shape,
                 "scatter_add_rows: vals [S, E], idx and src [K]")
    _lib.require(vals.dtype in _lib.DTYPE_CODE and dtype in _lib.DTYPE_CODE, "scatter_add_rows: f32/bf16 only")
    _lib.require(idx.dtype == torch.int64 and src.dtype == torch.int64, "scatter_add_rows: int64 indices")
    if vals.device.type == "cpu":
        PLAIN_CALLS["row_scatter"] += 1
        return scatter_add_rows_plain(idx, src, vals, rows, dtype)
    _lib.require(vals.device.type == "cuda", f"unsupported device {vals.device}")
    vals, idx, src = vals.contiguous(), idx.contiguous(), src.contiguous()
    e = vals.shape[1]
    out = torch.zeros((rows, e), dtype=dtype, device=vals.device)
    lib = _lib.library()
    with torch.cuda.device(vals.device):
        rc = lib.hctr_scatter_add_rows(
            _lib.DTYPE_CODE[vals.dtype], _lib.DTYPE_CODE[dtype], vals.data_ptr(), idx.data_ptr(), src.data_ptr(),
            out.data_ptr(), idx.shape[0], rows, e, _lib.stream_of(vals),
        )
    _lib.check(rc, "scatter_add_rows")
    LAUNCHES["row_scatter"] += 1
    return out


def _drop_copy_(a: torch.Tensor, tgt: torch.Tensor, vals: torch.Tensor) -> None:
    """a[tgt[i]] = vals[i] where tgt[i] < rows; the rest go to a spare row."""
    ext = torch.cat([a, a[:1]])
    ext.index_copy_(0, tgt, vals.to(a.dtype))
    a.copy_(ext[:-1])


def adagrad_rows_plain(opt, table: torch.Tensor, accum: torch.Tensor, sidx: torch.Tensor, g: torch.Tensor,
                       count: torch.Tensor, lr: torch.Tensor) -> None:
    """The tails among the first `count` entries take `update_math`'s new
    rows: the table adds the delta rounded to its type (an entry that is
    not taken adds -0.0, which changes no bit), the accumulator is set
    through a spare row."""
    from ..embedding.sparse_optimizer import update_math

    k, rows = sidx.shape[0], table.shape[0]
    pos = torch.arange(k, device=sidx.device)
    tail = torch.ones(k, dtype=torch.bool, device=sidx.device)
    tail[:-1] = sidx[1:] != sidx[:-1]
    live = tail & (pos < count) & (sidx >= 0) & (sidx < rows)
    safe = torch.where(live, sidx, 0)
    gl = torch.where(live.unsqueeze(1), g, 0.0)
    _op, val, new = update_math(opt, table, {"accum": accum[safe]}, gl, lr, 1)
    neg0 = torch.full((), -0.0, dtype=table.dtype, device=table.device)
    table.index_add_(0, safe, torch.where(live.unsqueeze(1), val.to(table.dtype), neg0))
    _drop_copy_(accum, torch.where(live, sidx, rows), new["accum"])


def adagrad_rows(opt, table: torch.Tensor, accum: torch.Tensor, sidx: torch.Tensor, g: torch.Tensor,
                 count: torch.Tensor, lr: torch.Tensor) -> None:
    """AdaGrad (accum [R, E]) or RowWiseAdaGrad (accum [R, 1]) on table [R,
    E], in place, from sorted int64 row ids sidx [K] (the padding's ids at
    least R, last), their float32 inclusive segmented sums g [K, E] and
    `count`, the 0-dim int64 count of sidx's valid prefix on the device;
    lr is a 0-dim float32 or bfloat16 device tensor. On the card, a lane
    takes 4 columns in one access where E and the rows allow
    (`_lib.vec_width`), else one."""
    kind = opt.optimizer
    _lib.require(kind in ROWWISE, f"adagrad_rows: {kind} is not AdaGrad or RowWiseAdaGrad")
    _lib.require(table.dim() == 2 and g.shape == (sidx.shape[0], table.shape[1]) and g.dtype == torch.float32,
                 "adagrad_rows: table [R, E], g float32 [K, E]")
    width = 1 if kind == Optimizer_t.RowWiseAdaGrad else table.shape[1]
    _lib.require(accum.shape == (table.shape[0], width), f"adagrad_rows: accum must be [R, {width}]")
    _lib.require(count.dim() == 0 and count.dtype == torch.int64, "adagrad_rows: count is a 0-dim int64")
    if table.device.type == "cpu":
        PLAIN_CALLS["adagrad_rows"] += 1
        adagrad_rows_plain(opt, table, accum, sidx, g, count, lr)
        return
    _lib.require(table.device.type == "cuda", f"unsupported device {table.device}")
    for what, t in (("table", table), ("accum", accum), ("sidx", sidx), ("g", g)):
        _lib.require(t.is_contiguous(), f"adagrad_rows: {what} must be contiguous")
    _lib.require(lr.dtype in _lib.DTYPE_CODE and lr.device == table.device, "adagrad_rows: lr on the card")
    e = table.shape[1]
    vec = _lib.vec_width(e, table, g, *(() if width == 1 else (accum,)))
    lib = _lib.library()
    with torch.cuda.device(table.device):
        rc = lib.hctr_adagrad_rows(
            _lib.DTYPE_CODE[table.dtype], _lib.DTYPE_CODE[accum.dtype], table.data_ptr(), accum.data_ptr(),
            sidx.data_ptr(), g.data_ptr(), count.data_ptr(), lr.data_ptr(), _lib.DTYPE_CODE[lr.dtype],
            sidx.shape[0], table.shape[0], e, ctypes.c_float(opt.epsilon), ROWWISE[kind], vec,
            _lib.stream_of(table),
        )
    _lib.check(rc, "adagrad_rows")
    LAUNCHES["adagrad_rows"] += 1
