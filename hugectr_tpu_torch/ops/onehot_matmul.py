"""Pooled lookup and its weight gradient for the small-table (one-hot) engine.

Counterparts of hugectr_tpu/ops/pallas/onehot_matmul.py::onehot_matmul_fwd
and ::onehot_matmul_bwd. The TPU kernels build one-hot tiles for the matrix
unit; on the card the same functions are a gather-pool and a scatter-add
(csrc/onehot_matmul.cu; see its note for bounds and design). Keys are
table-local rows; a key outside [0, V) is padding. The plain PyTorch versions
beside the kernels serve the CPU and the checks on the card; a CUDA tensor
always takes the kernel. The backward can add into a caller's float32
buffers (`out=`, `cnt_out=`), so a group of tables zeroes its gradient once.

    forward:   out[b, :] = sum_h [0 <= keys[b,h] < V] * table[keys[b,h], :]
    backward:  grad[v, :] = sum_{b,h} [keys[b,h] == v] * d[b, :]
               cnt[v]     = sum_{b,h} [keys[b,h] == v]
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _lib

LAUNCHES = {"onehot_fwd": 0, "onehot_bwd": 0}  # kernel launches (CUDA tensors)
PLAIN_CALLS = {"onehot_fwd": 0, "onehot_bwd": 0}  # plain-version calls (CPU)


def onehot_matmul_fwd_plain(keys: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    v = table.shape[0]
    valid = (keys >= 0) & (keys < v)
    rows = table[torch.where(valid, keys, 0).long()].float()
    return (rows * valid.unsqueeze(-1)).sum(dim=1).to(table.dtype)


def onehot_matmul_bwd_plain(
    keys: torch.Tensor, d: torch.Tensor, vocab: int, out_dtype: torch.dtype,
    out: Optional[torch.Tensor] = None, cnt_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, h = keys.shape
    flat = keys.reshape(-1)
    valid = (flat >= 0) & (flat < vocab)
    kk = flat[valid].long()
    src = torch.arange(b, device=keys.device).repeat_interleave(h)[valid]
    grad = torch.zeros((vocab, d.shape[1]), dtype=torch.float32, device=d.device)
    grad.index_add_(0, kk, d.float()[src])
    cnt = torch.bincount(kk, minlength=vocab).float()
    if out is None:
        return grad.to(out_dtype), cnt
    return out.add_(grad), cnt_out.add_(cnt)


def _check_keys(keys: torch.Tensor) -> None:
    _lib.require(
        keys.dim() == 2 and keys.dtype == torch.int32,
        f"keys must be int32 [B, h], got {keys.dtype} {tuple(keys.shape)}",
    )


def onehot_matmul_fwd(keys: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Pooled (sum) lookup: [B, h] local keys x [V, E] table -> [B, E]."""
    _check_keys(keys)
    _lib.require(
        table.dim() == 2 and table.dtype in _lib.DTYPE_CODE,
        f"table must be f32/bf16 [V, E], got {table.dtype} {tuple(table.shape)}",
    )
    _lib.require(keys.device == table.device, "keys and table on different devices")
    if table.device.type == "cpu":
        PLAIN_CALLS["onehot_fwd"] += 1
        return onehot_matmul_fwd_plain(keys, table)
    _lib.require(table.device.type == "cuda", f"unsupported device {table.device}")
    _lib.require(keys.is_contiguous() and table.is_contiguous(), "inputs must be contiguous")
    (b, h), (v, e) = keys.shape, table.shape
    out = torch.empty((b, e), dtype=table.dtype, device=table.device)
    lib = _lib.library()
    with torch.cuda.device(table.device):
        rc = lib.hctr_onehot_fwd(
            _lib.DTYPE_CODE[table.dtype], keys.data_ptr(), table.data_ptr(), out.data_ptr(),
            b, h, v, e, _lib.vec_width(e, table, out), _lib.stream_of(table),
        )
    _lib.check(rc, "onehot_fwd")
    LAUNCHES["onehot_fwd"] += 1
    return out




def bwd_tile_rows(e: int, device: torch.device) -> int:
    """Table rows one block of the CUDA backward holds at width `e`."""
    with torch.cuda.device(device):
        return _lib.library().hctr_onehot_bwd_tile_rows(e)


def bwd_route(b: int, h: int, vocab: int, e: int, device: torch.device) -> str:
    """The CUDA backward's route for a shape: "privatised" or "global"."""
    with torch.cuda.device(device):
        return "privatised" if _lib.library().hctr_onehot_bwd_privatised(b, h, vocab, e) else "global"


def onehot_matmul_bwd(
    keys: torch.Tensor, d: torch.Tensor, vocab: int, out_dtype: torch.dtype,
    out: Optional[torch.Tensor] = None, cnt_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight gradient and touch counts: [B, h] keys x [B, E] cotangents ->
    (grad [V, E] in `out_dtype`, cnt [V] f32). Given `out` and `cnt_out`
    (contiguous float32 [V, E] and [V]), adds into them and returns them."""
    _check_keys(keys)
    _lib.require(
        d.dim() == 2 and d.shape[0] == keys.shape[0] and d.dtype in _lib.DTYPE_CODE,
        f"d must be f32/bf16 [{keys.shape[0]}, E], got {d.dtype} {tuple(d.shape)}",
    )
    _lib.require(out_dtype in _lib.DTYPE_CODE, f"out_dtype {out_dtype} not f32/bf16")
    _lib.require(keys.device == d.device, "keys and d on different devices")
    e = d.shape[1]
    _lib.require((out is None) == (cnt_out is None), "give both out and cnt_out, or neither")
    if out is not None:
        _lib.require(
            out_dtype == torch.float32 and out.dtype == torch.float32
            and tuple(out.shape) == (vocab, e) and out.is_contiguous()
            and cnt_out.dtype == torch.float32 and tuple(cnt_out.shape) == (vocab,)
            and cnt_out.is_contiguous() and out.device == d.device == cnt_out.device,
            f"out/cnt_out must be contiguous float32 [{vocab}, {e}] / [{vocab}] on {d.device}",
        )
    if d.device.type == "cpu":
        PLAIN_CALLS["onehot_bwd"] += 1
        return onehot_matmul_bwd_plain(keys, d, vocab, out_dtype, out, cnt_out)
    _lib.require(d.device.type == "cuda", f"unsupported device {d.device}")
    _lib.require(keys.is_contiguous() and d.is_contiguous(), "inputs must be contiguous")
    b, h = keys.shape
    accumulate = out is not None
    if not accumulate:  # the launcher zeroes them
        out = torch.empty((vocab, e), dtype=torch.float32, device=d.device)
        cnt_out = torch.empty((vocab,), dtype=torch.float32, device=d.device)
    grad = out
    if out_dtype == torch.bfloat16:
        grad = torch.empty((vocab, e), dtype=torch.bfloat16, device=d.device)
    lib = _lib.library()
    with torch.cuda.device(d.device):
        rc = lib.hctr_onehot_bwd(
            _lib.DTYPE_CODE[d.dtype], keys.data_ptr(), d.data_ptr(), out.data_ptr(),
            cnt_out.data_ptr(), grad.data_ptr() if grad is not out else None,
            b, h, vocab, e, int(accumulate), _lib.stream_of(d),
        )
    _lib.check(rc, "onehot_bwd")
    LAUNCHES["onehot_bwd"] += 1
    return grad, cnt_out
