"""Pooled lookup and its weight gradient for the small-table (one-hot) engine.

Counterparts of hugectr_tpu/ops/pallas/onehot_matmul.py::onehot_matmul_fwd
and ::onehot_matmul_bwd. The TPU kernels build one-hot tiles for the matrix
unit; on the card the backward is a scatter-add and the forward a
gather-pool or, for small tables of high hotness, the counts matmul on the
tensor cores (csrc/onehot_matmul.cu; see its note for bounds and design).
The plain PyTorch versions beside the kernels serve the CPU and the checks
on the card; a CUDA tensor always takes the kernel. The backward can add
into a caller's float32 buffers (`out=`, `cnt_out=`), so a group of tables
zeroes its gradient once.

`onehot_fwd_group` pools every lookup of a one-hot group in one launch from
the raw feature keys (int32 or int64, any row stride). Each key is placed as
the JAX package's `_group_keys` and `_slot_placement` place it: cut to
int32; -1, and for a windowed lookup (a tier of a split table) any key
outside its window [key_lo, key_hi), is padding; a key in the window is
shifted down by key_lo; any other key wraps by floor modulo into the
table's vocabulary. Each lookup is written into its columns of the group's
[B, W] output. The per-table
`onehot_matmul_fwd` keeps the Pallas kernel's contract (table-local keys; a
key outside [0, V) is padding) and runs the same kernel as a one-lookup
group.

    forward:   out[b, :] = sum_h [0 <= keys[b,h] < V] * w[b,h] * table[keys[b,h], :]
    backward:  grad[v, :] = sum_{b,h} [keys[b,h] == v] * w[b,h] * d[b, :]
               cnt[v]     = sum_{b,h} [keys[b,h] == v] * |w[b,h]|

w is 1 unless the caller passes per-key float32 weights (a weighted lookup,
the JAX package's sp_weight_name, collection.py:1236-1300): a weighted Mean
divides by the sum of the weights of its non-padding keys (1 where that sum
is 0), and the touch count of a row sums |w|, so that weights that cancel
across samples still mark it touched (collection.py:1383-1391). The JAX
package builds weighted counts in the table's type (bfloat16 weights, a
bfloat16 sum of a sample's duplicate keys' weights); these sum in float32
and round once.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.types import INVALID_KEY
from . import _lib

LAUNCHES = {"onehot_fwd": 0, "onehot_bwd": 0}  # kernel launches (CUDA tensors)
PLAIN_CALLS = {"onehot_fwd": 0, "onehot_bwd": 0}  # plain-version calls (CPU)
# the launches above that carried per-key weights (a weighted lookup)
WEIGHTED_LAUNCHES = {"onehot_fwd": 0, "onehot_bwd": 0}

MAX_GROUP_LOOKUPS = 48  # kMaxLookups of csrc/onehot_matmul.cu
FWD_ROUTES = ("gather", "mma")  # FwdRoute of csrc/onehot_matmul.cu, by code


INT32_MAX = 2**31 - 1


class GroupLookup(NamedTuple):
    """One lookup of a one-hot group: its table's rows [row_off, row_off +
    vocab) of the group storage, its output columns [out_begin, out_begin +
    E), whether it averages (Mean) or sums, and its key window (plan.py:81
    with key_shift = key_lo, as the split makes it): windowed iff key_lo > 0
    or key_hi >= 0; key_hi -1 has no upper bound."""

    row_off: int
    vocab: int
    out_begin: int
    mean: bool
    key_lo: int = 0
    key_hi: int = -1

    @property
    def windowed(self) -> bool:
        return self.key_lo > 0 or self.key_hi >= 0


class _CLookup(ctypes.Structure):
    """hctr_fwd_lookup of csrc/onehot_matmul.cu."""

    _fields_ = [
        ("keys", ctypes.c_void_p), ("key_stride", ctypes.c_int64), ("row_off", ctypes.c_int64),
        ("h", ctypes.c_int), ("v", ctypes.c_int), ("out_col", ctypes.c_int),
        ("mean", ctypes.c_int), ("key64", ctypes.c_int), ("key_lo", ctypes.c_int),
        ("key_hi", ctypes.c_int), ("weights", ctypes.c_void_p), ("w_stride", ctypes.c_int64),
    ]


def onehot_matmul_fwd_plain(keys: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    v = table.shape[0]
    valid = (keys >= 0) & (keys < v)
    rows = table[torch.where(valid, keys, 0).long()].float()
    return (rows * valid.unsqueeze(-1)).sum(dim=1).to(table.dtype)


def window_keys(keys: torch.Tensor, key_lo: int = 0, key_hi: int = -1) -> torch.Tensor:
    """int32 keys of a lookup with its window applied (collection.py:741):
    cut to int32; for a windowed lookup, keys outside [key_lo, key_hi)
    become -1 (padding) and the others are shifted down by key_lo."""
    k32 = keys.to(torch.int32)
    if not (key_lo > 0 or key_hi >= 0):
        return k32
    hi = key_hi if key_hi >= 0 else INT32_MAX
    return torch.where((k32 >= key_lo) & (k32 < hi), k32 - key_lo, INVALID_KEY)


def place_keys(keys: torch.Tensor, vocab) -> Tuple[torch.Tensor, torch.Tensor]:
    """(valid, table-local row) of static keys, as the JAX package places
    them: cut to int32 (its astype without x64), -1 is padding, any other
    key wraps by floor modulo into [0, vocab). `vocab` is an int or a
    tensor that broadcasts against `keys`; padding gets row 0."""
    k32 = keys.to(torch.int32)
    valid = k32 != INVALID_KEY
    return valid, torch.where(valid, torch.remainder(k32, vocab), 0).long()


Weights = Optional[Sequence[Optional[torch.Tensor]]]


def onehot_fwd_group_plain(
    keys: Sequence[torch.Tensor], lookups: Sequence[GroupLookup], table: torch.Tensor,
    out_width: int, weights: Weights = None,
) -> torch.Tensor:
    """Per lookup: the placement (int32 cut, window, -1 padding, floor-mod
    wrap), the pooled (weighted) sum in float32, the Mean division by the
    count of non-padding keys or the sum of their weights (1 where it is
    0), one rounding."""
    e = table.shape[1]
    out = torch.zeros((keys[0].shape[0], out_width), dtype=table.dtype, device=table.device)
    for i, (k, lk) in enumerate(zip(keys, lookups)):
        valid, local = place_keys(window_keys(k, lk.key_lo, lk.key_hi), lk.vocab)
        rows = table[lk.row_off : lk.row_off + lk.vocab].float()[local]
        w = weights[i] if weights is not None else None
        m = valid.float() if w is None else torch.where(valid, w.float(), 0.0)
        o = (rows * m.unsqueeze(-1)).sum(dim=1)
        if lk.mean:
            den = m.sum(dim=1, keepdim=True)
            o = o / (torch.clamp(den, min=1.0) if w is None else torch.where(den == 0, 1.0, den))
        out[:, lk.out_begin : lk.out_begin + e] = o.to(table.dtype)
    return out


def fwd_route(vocab: int, h: int, e: int, device: torch.device, weighted: bool = False) -> str:
    """The CUDA forward's route for a lookup: "gather" or "mma" (a weighted
    lookup always gathers: the counts matmul's integer counts hold no
    weights)."""
    if weighted:
        return "gather"
    with torch.cuda.device(device):
        code = _lib.library().hctr_onehot_fwd_route(vocab, h, e)
    return FWD_ROUTES[code]


def _check_weights(weights: Weights, keys: Sequence[torch.Tensor]) -> None:
    _lib.require(weights is None or len(weights) == len(keys), "give one weight tensor (or None) per lookup")
    for w, k in zip(weights or (), keys):
        if w is not None and not (w.dtype == torch.float32 and tuple(w.shape) == tuple(k.shape)
                                  and w.device == k.device and (w.shape[1] == 1 or w.stride(1) == 1)):
            raise ValueError(f"weights must be float32 {tuple(k.shape)} with a unit column stride on {k.device}, "
                             f"got {w.dtype} {tuple(w.shape)}")


def onehot_fwd_group(
    keys: Sequence[torch.Tensor], lookups: Sequence[GroupLookup], table: torch.Tensor,
    out_width: int, weights: Weights = None,
) -> torch.Tensor:
    """Pooled lookups of a one-hot group in one launch: keys[i] ([B, h_i]
    int32/int64, unit column stride) of lookup i into `table` (the group
    storage [R, E]) -> [B, out_width], lookup i in columns
    [out_begin, out_begin + E); on the card, columns no lookup covers are
    left as allocated. `weights[i]` (float32 [B, h_i], unit column stride,
    or None) weights lookup i's keys. The launcher picks each lookup's
    route (`fwd_route`)."""
    _lib.require(len(keys) == len(lookups) >= 1, "give one key tensor per lookup")
    _lib.require(
        table.dim() == 2 and table.dtype in _lib.DTYPE_CODE,
        f"table must be f32/bf16 [R, E], got {table.dtype} {tuple(table.shape)}",
    )
    b, e = keys[0].shape[0], table.shape[1]
    for k, lk in zip(keys, lookups):  # messages formatted only on failure: this runs every step
        if not (k.dim() == 2 and k.shape[0] == b and k.shape[1] >= 1
                and k.dtype in (torch.int32, torch.int64)):
            raise ValueError(f"keys must be int32/int64 [{b}, h], got {k.dtype} {tuple(k.shape)}")
        if k.device != table.device:
            raise ValueError("keys and table on different devices")
        if not (0 <= lk.row_off and lk.vocab >= 1 and lk.row_off + lk.vocab <= table.shape[0]
                and 0 <= lk.out_begin and lk.out_begin + e <= out_width
                and 0 <= lk.key_lo <= INT32_MAX and -1 <= lk.key_hi <= INT32_MAX):
            raise ValueError(f"lookup {lk} outside table rows {table.shape[0]}, width {out_width} "
                             "or the int32 keys")
    _check_weights(weights, keys)
    if table.device.type == "cpu":
        PLAIN_CALLS["onehot_fwd"] += 1
        return onehot_fwd_group_plain(keys, lookups, table, out_width, weights)
    _lib.require(table.device.type == "cuda", f"unsupported device {table.device}")
    _lib.require(table.is_contiguous(), "table must be contiguous")
    _lib.require(len(lookups) <= MAX_GROUP_LOOKUPS,
                 f"{len(lookups)} lookups: the kernel takes at most {MAX_GROUP_LOOKUPS}")
    if not all(k.shape[1] == 1 or k.stride(1) == 1 for k in keys):
        raise ValueError("keys need a unit column stride")
    ws = list(weights) if weights is not None else [None] * len(keys)
    descs = (_CLookup * len(lookups))(*[
        _CLookup(k.data_ptr(), k.stride(0), lk.row_off, k.shape[1], lk.vocab, lk.out_begin,
                 int(lk.mean), int(k.dtype == torch.int64), lk.key_lo, lk.key_hi,
                 w.data_ptr() if w is not None else None, w.stride(0) if w is not None else 0)
        for k, lk, w in zip(keys, lookups, ws)
    ])
    out = torch.empty((b, out_width), dtype=table.dtype, device=table.device)
    lib = _lib.library()
    with torch.cuda.device(table.device):
        rc = lib.hctr_onehot_fwd_group(
            _lib.DTYPE_CODE[table.dtype], descs, len(lookups), table.data_ptr(), out.data_ptr(),
            b, e, out_width, _lib.stream_of(table),
        )
    _lib.check(rc, "onehot_fwd_group")
    LAUNCHES["onehot_fwd"] += 1
    WEIGHTED_LAUNCHES["onehot_fwd"] += any(w is not None for w in ws)
    return out


def onehot_matmul_bwd_plain(
    keys: torch.Tensor, d: torch.Tensor, vocab: int, out_dtype: torch.dtype,
    out: Optional[torch.Tensor] = None, cnt_out: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, h = keys.shape
    flat = keys.reshape(-1)
    valid = (flat >= 0) & (flat < vocab)
    kk = flat[valid].long()
    src = torch.arange(b, device=keys.device).repeat_interleave(h)[valid]
    grad = torch.zeros((vocab, d.shape[1]), dtype=torch.float32, device=d.device)
    if weights is None:
        grad.index_add_(0, kk, d.float()[src])
        cnt = torch.bincount(kk, minlength=vocab).float()
    else:
        w = weights.reshape(-1)[valid].float()
        grad.index_add_(0, kk, d.float()[src] * w.unsqueeze(1))
        cnt = torch.zeros(vocab, dtype=torch.float32, device=d.device).index_add_(0, kk, w.abs())
    if out is None:
        return grad.to(out_dtype), cnt
    return out.add_(grad), cnt_out.add_(cnt)


def _check_keys(keys: torch.Tensor) -> None:
    _lib.require(
        keys.dim() == 2 and keys.dtype == torch.int32,
        f"keys must be int32 [B, h], got {keys.dtype} {tuple(keys.shape)}",
    )


def onehot_matmul_fwd(keys: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Pooled (sum) lookup: [B, h] local keys x [V, E] table -> [B, E]; the
    group kernel with one lookup, in local-keys mode."""
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
            b, h, v, e, _lib.stream_of(table),
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
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight gradient and touch counts: [B, h] keys x [B, E] cotangents ->
    (grad [V, E] in `out_dtype`, cnt [V] f32). Given `out` and `cnt_out`
    (contiguous float32 [V, E] and [V]), adds into them and returns them.
    `weights` (contiguous float32 [B, h]) scales each key's cotangent, and
    the counts sum |w|."""
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
    if weights is not None:
        _lib.require(weights.dtype == torch.float32 and weights.shape == keys.shape
                     and weights.device == keys.device,
                     f"weights must be float32 {tuple(keys.shape)} on {keys.device}")
    if d.device.type == "cpu":
        PLAIN_CALLS["onehot_bwd"] += 1
        return onehot_matmul_bwd_plain(keys, d, vocab, out_dtype, out, cnt_out, weights)
    _lib.require(d.device.type == "cuda", f"unsupported device {d.device}")
    _lib.require(keys.is_contiguous() and d.is_contiguous(), "inputs must be contiguous")
    _lib.require(weights is None or weights.is_contiguous(), "weights must be contiguous")
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
            _lib.DTYPE_CODE[d.dtype], keys.data_ptr(), d.data_ptr(),
            weights.data_ptr() if weights is not None else None, out.data_ptr(),
            cnt_out.data_ptr(), grad.data_ptr() if grad is not out else None,
            b, h, vocab, e, int(accumulate), _lib.stream_of(d),
        )
    _lib.check(rc, "onehot_bwd")
    LAUNCHES["onehot_bwd"] += 1
    WEIGHTED_LAUNCHES["onehot_bwd"] += weights is not None
    return grad, cnt_out
