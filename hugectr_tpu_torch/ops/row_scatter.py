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
  `scatter_add_rows_(dst, idx, src, vals)` adds the same into `dst` in
  place (SGD's update of its table, sparse_optimizer.py:408).
* `adagrad_rows(opt, table, accum, sidx, g, count, lr)`: the AdaGrad or
  RowWiseAdaGrad update, in place, of the rows of a sorted id list sidx [K]
  whose float32 segmented sums are g [K, E]: each segment tail among the
  first `count` entries (a 0-dim int64 tensor on the device) updates its
  row once (the sorted route's `_apply_rows`).
* `ftrl_rows(opt, table, z, n, sidx, g, count, lr)`: FTRL's update of the
  same tails, in place: each sets its row of the table and of its state z
  and n (the JAX package's `_apply_rows` FTRL, sparse_optimizer.py:873-891).
* `adam_rows(opt, table, m, v, sidx, g, count, lr, bc1, bc2)`: Adam's
  update of the same tails, in place, with the bias corrections read from
  the device scalars bc1, bc2: each sets its rows of m and v and adds its
  delta to the table (`_apply_rows` Adam, sparse_optimizer.py:855-870).
  A live tail whose summed gradient is 0 is updated too: its moments decay.

The plain versions beside the kernels serve the CPU and the checks on the
card; they are written without a host sync or a shape that follows the
data (a temporary row past the end, or an add of -0.0 into row 0, takes
what the kernels drop), and give the port's earlier update bitwise:
`adagrad_rows_plain`, `ftrl_rows_plain` and `adam_rows_plain` compute every
entry with `sparse_optimizer.update_math` and keep the tails' results.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.types import Optimizer_t
from . import _lib

LAUNCHES = {"row_scatter": 0, "adagrad_rows": 0, "ftrl_rows": 0, "adam_rows": 0}  # kernel launches (CUDA tensors)
PLAIN_CALLS = {"row_scatter": 0, "adagrad_rows": 0, "ftrl_rows": 0, "adam_rows": 0}  # plain-version calls (CPU)

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
    out = torch.zeros((rows, vals.shape[1]), dtype=dtype, device=vals.device)
    scatter_add_rows_(out, idx, src, vals)
    return out


def scatter_add_rows_into_plain(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                                vals: torch.Tensor) -> None:
    """`index_add_` into dst of every entry's row, the entries outside [0,
    rows) as -0.0 into row 0, which changes no bit (+0.0 would turn a -0.0
    into +0.0)."""
    rows = dst.shape[0]
    live = ((idx >= 0) & (idx < rows)).unsqueeze(1)
    neg0 = torch.full((), -0.0, dtype=dst.dtype, device=dst.device)
    dst.index_add_(0, torch.where(live.squeeze(1), idx, 0), torch.where(live, vals[src].to(dst.dtype), neg0))


def scatter_add_rows_(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor, vals: torch.Tensor) -> None:
    """dst [rows, E] (float32 or bfloat16) += vals[src[i]] ([S, E], float32
    or bfloat16, each cast to dst's type) at row idx[i], in place, over the
    entries with idx in [0, rows); idx and src are [K] int64."""
    _lib.require(vals.dim() == 2 and dst.dim() == 2 and vals.shape[1] == dst.shape[1] and idx.dim() == 1
                 and src.shape == idx.shape, "scatter_add_rows_: dst [R, E], vals [S, E], idx and src [K]")
    _lib.require(vals.dtype in _lib.DTYPE_CODE and dst.dtype in _lib.DTYPE_CODE, "scatter_add_rows_: f32/bf16 only")
    _lib.require(idx.dtype == torch.int64 and src.dtype == torch.int64, "scatter_add_rows_: int64 indices")
    if dst.device.type == "cpu":
        PLAIN_CALLS["row_scatter"] += 1
        scatter_add_rows_into_plain(dst, idx, src, vals)
        return
    _lib.require(dst.device.type == "cuda", f"unsupported device {dst.device}")
    _lib.require(dst.is_contiguous(), "scatter_add_rows_: dst must be contiguous")
    vals, idx, src = vals.contiguous(), idx.contiguous(), src.contiguous()
    lib = _lib.library()
    with torch.cuda.device(dst.device):
        rc = lib.hctr_scatter_add_rows(
            _lib.DTYPE_CODE[vals.dtype], _lib.DTYPE_CODE[dst.dtype], vals.data_ptr(), idx.data_ptr(), src.data_ptr(),
            dst.data_ptr(), idx.shape[0], dst.shape[0], dst.shape[1], _lib.stream_of(dst),
        )
    _lib.check(rc, "scatter_add_rows_")
    LAUNCHES["row_scatter"] += 1


def _drop_copy_(a: torch.Tensor, tgt: torch.Tensor, vals: torch.Tensor) -> None:
    """a[tgt[i]] = vals[i] where tgt[i] < rows; the rest go to a spare row."""
    ext = torch.cat([a, a[:1]])
    ext.index_copy_(0, tgt, vals.to(a.dtype))
    a.copy_(ext[:-1])


def _live_tails(sidx: torch.Tensor, count: torch.Tensor, rows: int) -> torch.Tensor:
    """[K] bool: the segment tails among the first `count` entries whose
    ids lie in [0, rows)."""
    k = sidx.shape[0]
    pos = torch.arange(k, device=sidx.device)
    tail = torch.ones(k, dtype=torch.bool, device=sidx.device)
    tail[:-1] = sidx[1:] != sidx[:-1]
    return tail & (pos < count) & (sidx >= 0) & (sidx < rows)


def adagrad_rows_plain(opt, table: torch.Tensor, accum: torch.Tensor, sidx: torch.Tensor, g: torch.Tensor,
                       count: torch.Tensor, lr: torch.Tensor) -> None:
    """The tails among the first `count` entries take `update_math`'s new
    rows: the table adds the delta rounded to its type (an entry that is
    not taken adds -0.0, which changes no bit), the accumulator is set
    through a spare row."""
    from ..embedding.sparse_optimizer import update_math

    rows = table.shape[0]
    live = _live_tails(sidx, count, rows)
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


def ftrl_rows_plain(opt, table: torch.Tensor, z: torch.Tensor, n: torch.Tensor, sidx: torch.Tensor,
                    g: torch.Tensor, count: torch.Tensor, lr: torch.Tensor) -> None:
    """The tails among the first `count` entries take `update_math`'s FTRL
    rows: w, z and n are set through a spare row, which takes every other
    entry."""
    from ..embedding.sparse_optimizer import update_math

    rows = table.shape[0]
    live = _live_tails(sidx, count, rows)
    safe, tgt = torch.where(live, sidx, 0), torch.where(live, sidx, rows)
    _op, w, new = update_math(opt, table[safe], {"z": z[safe], "n": n[safe]}, g, lr, 1)
    for a, v in ((table, w), (z, new["z"]), (n, new["n"])):
        _drop_copy_(a, tgt, v)


def ftrl_rows(opt, table: torch.Tensor, z: torch.Tensor, n: torch.Tensor, sidx: torch.Tensor, g: torch.Tensor,
              count: torch.Tensor, lr: torch.Tensor) -> None:
    """FTRL on table [R, E] and its state z, n [R, E] (float32 or bfloat16,
    the two of one type), in place, from sorted int64 row ids sidx [K] (the
    padding's ids at least R, last), their float32 inclusive segmented sums
    g [K, E] and `count`, the 0-dim int64 count of sidx's valid prefix on
    the device; lr is a 0-dim float32 or bfloat16 device tensor. On the
    card, a lane takes 4 columns in one access where E and the rows allow
    (`_lib.vec_width`), else one."""
    _lib.require(opt.optimizer == Optimizer_t.FTRL, f"ftrl_rows: {opt.optimizer} is not FTRL")
    _lib.require(table.dim() == 2 and g.shape == (sidx.shape[0], table.shape[1]) and g.dtype == torch.float32,
                 "ftrl_rows: table [R, E], g float32 [K, E]")
    _lib.require(z.shape == n.shape == table.shape and z.dtype == n.dtype, "ftrl_rows: z and n [R, E] of one type")
    _lib.require(count.dim() == 0 and count.dtype == torch.int64, "ftrl_rows: count is a 0-dim int64")
    if table.device.type == "cpu":
        PLAIN_CALLS["ftrl_rows"] += 1
        ftrl_rows_plain(opt, table, z, n, sidx, g, count, lr)
        return
    _lib.require(table.device.type == "cuda", f"unsupported device {table.device}")
    for what, t in (("table", table), ("z", z), ("n", n), ("sidx", sidx), ("g", g)):
        _lib.require(t.is_contiguous(), f"ftrl_rows: {what} must be contiguous")
    _lib.require(table.dtype in _lib.DTYPE_CODE and z.dtype in _lib.DTYPE_CODE, "ftrl_rows: f32/bf16 only")
    _lib.require(lr.dtype in _lib.DTYPE_CODE and lr.device == table.device, "ftrl_rows: lr on the card")
    e = table.shape[1]
    vec = _lib.vec_width(e, table, g, z, n)
    lib = _lib.library()
    with torch.cuda.device(table.device):
        rc = lib.hctr_ftrl_rows(
            _lib.DTYPE_CODE[table.dtype], _lib.DTYPE_CODE[z.dtype], table.data_ptr(), z.data_ptr(), n.data_ptr(),
            sidx.data_ptr(), g.data_ptr(), count.data_ptr(), lr.data_ptr(), _lib.DTYPE_CODE[lr.dtype],
            sidx.shape[0], table.shape[0], e, ctypes.c_float(opt.ftrl_beta), ctypes.c_float(opt.lambda1),
            ctypes.c_float(opt.lambda2), vec, _lib.stream_of(table),
        )
    _lib.check(rc, "ftrl_rows")
    LAUNCHES["ftrl_rows"] += 1


def adam_rows_plain(opt, table: torch.Tensor, m: torch.Tensor, v: torch.Tensor, sidx: torch.Tensor, g: torch.Tensor,
                    count: torch.Tensor, lr: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor) -> None:
    """The tails among the first `count` entries take `update_math`'s Adam
    rows: the table adds the delta rounded to its type (an entry that is not
    taken adds -0.0, which changes no bit), m and v are set through a spare
    row."""
    from ..embedding.sparse_optimizer import update_math

    rows = table.shape[0]
    live = _live_tails(sidx, count, rows)
    safe, tgt = torch.where(live, sidx, 0), torch.where(live, sidx, rows)
    gl = torch.where(live.unsqueeze(1), g, 0.0)
    _op, val, new = update_math(opt, table, {"m": m[safe], "v": v[safe]}, gl, lr, (bc1, bc2))
    neg0 = torch.full((), -0.0, dtype=table.dtype, device=table.device)
    table.index_add_(0, safe, torch.where(live.unsqueeze(1), val.to(table.dtype), neg0))
    _drop_copy_(m, tgt, new["m"])
    _drop_copy_(v, tgt, new["v"])


def adam_rows(opt, table: torch.Tensor, m: torch.Tensor, v: torch.Tensor, sidx: torch.Tensor, g: torch.Tensor,
              count: torch.Tensor, lr: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor) -> None:
    """Adam on table [R, E] and its state m, v [R, E] (float32 or bfloat16,
    the two of one type), in place, from sorted int64 row ids sidx [K] (the
    padding's ids at least R, last), their float32 inclusive segmented sums
    g [K, E] and `count`, the 0-dim int64 count of sidx's valid prefix on
    the device; lr is a 0-dim float32 or bfloat16 device tensor, bc1 and bc2
    the 0-dim float32 device scalars 1 - beta1^t and 1 - beta2^t. On the
    card, a lane takes 4 columns in one access where E and the rows allow
    (`_lib.vec_width`), else one."""
    _lib.require(opt.optimizer == Optimizer_t.Adam, f"adam_rows: {opt.optimizer} is not Adam")
    _lib.require(table.dim() == 2 and g.shape == (sidx.shape[0], table.shape[1]) and g.dtype == torch.float32,
                 "adam_rows: table [R, E], g float32 [K, E]")
    _lib.require(m.shape == v.shape == table.shape and m.dtype == v.dtype, "adam_rows: m and v [R, E] of one type")
    _lib.require(count.dim() == 0 and count.dtype == torch.int64, "adam_rows: count is a 0-dim int64")
    _lib.require(all(b.dim() == 0 and b.dtype == torch.float32 for b in (bc1, bc2)),
                 "adam_rows: bc1 and bc2 are 0-dim float32")
    if table.device.type == "cpu":
        PLAIN_CALLS["adam_rows"] += 1
        adam_rows_plain(opt, table, m, v, sidx, g, count, lr, bc1, bc2)
        return
    _lib.require(table.device.type == "cuda", f"unsupported device {table.device}")
    for what, t in (("table", table), ("m", m), ("v", v), ("sidx", sidx), ("g", g)):
        _lib.require(t.is_contiguous(), f"adam_rows: {what} must be contiguous")
    _lib.require(table.dtype in _lib.DTYPE_CODE and m.dtype in _lib.DTYPE_CODE, "adam_rows: f32/bf16 only")
    for what, t in (("lr", lr), ("bc1", bc1), ("bc2", bc2)):
        _lib.require(t.device == table.device, f"adam_rows: {what} on the card")
    _lib.require(lr.dtype in _lib.DTYPE_CODE, "adam_rows: lr is float32 or bfloat16")
    e = table.shape[1]
    vec = _lib.vec_width(e, table, g, m, v)
    lib = _lib.library()
    with torch.cuda.device(table.device):
        rc = lib.hctr_adam_rows(
            _lib.DTYPE_CODE[table.dtype], _lib.DTYPE_CODE[m.dtype], table.data_ptr(), m.data_ptr(), v.data_ptr(),
            sidx.data_ptr(), g.data_ptr(), count.data_ptr(), lr.data_ptr(), _lib.DTYPE_CODE[lr.dtype],
            bc1.data_ptr(), bc2.data_ptr(), sidx.shape[0], table.shape[0], e, *adam_consts(opt), vec,
            _lib.stream_of(table),
        )
    _lib.check(rc, "adam_rows")
    LAUNCHES["adam_rows"] += 1


def adam_consts(opt):
    """beta1, 1 - beta1, beta2, 1 - beta2 and epsilon as the kernel takes
    them: float32 roundings of the Python floats torch rounds, 1 - beta
    taken in double first, as Python takes it."""
    return tuple(ctypes.c_float(x) for x in (opt.beta1, 1.0 - opt.beta1, opt.beta2, 1.0 - opt.beta2, opt.epsilon))
