"""Ordered pooling of the owner-partitioned forward over W ranks.

The JAX package's default forward of a model-parallel rowop group at W > 1
(`_mp_fwd_partitioned`, hugectr_tpu/embedding/collection.py:867-936) sorts
the gathered (row, pool slot) pairs by row, so that the rows this rank's
shard owns form a prefix, gathers that prefix and pools it with a
scatter-add in the table's type:

    pooled = zeros((slots, E), table.dtype).at[slot].add(table[row])

No Pallas kernel computes this, but its result depends on the order of the
updates. XLA adds the updates of a scatter one by one, in the order of the
update list, and rounds to the table's type after every add: in bfloat16,
`zeros(1).at[[0] * 257].add([1.0] + [2^-9] * 256)` is 1.0, and the same 257
updates with the 1.0 last give 1.5 (eager and under `jit`). The list is
sorted by row (`lax.sort` is stable by default), so each slot sums its owned
rows in ascending row order, rounded after each add; float32 tables sum in
the same order. `index_add_` on the card adds with atomics in an order that
changes from run to run, so this is a kernel of its own
(csrc/ordered_pool.cu).

The collection lays out each slot's rows itself, as the plan fixes which
key columns a slot pools (`EmbeddingCollection._pool_segments`). Where a
capacity factor cuts the row-sorted list, `segments(rows, slots, n_slots,
sentinel)` regroups the surviving (row, slot) pairs: it sorts them by slot
and, within a slot, by row (one sort of slot x (sentinel + 1) + row: equal
keys are equal pairs, so no tie needs an order), and gives each slot's
[begin, end) offsets; a row id of `sentinel` or more (a key this rank does
not pool) sorts last in its slot. `ordered_pool(table, rows, offsets)` then
writes out[s] = table[rows[begin]] + table[rows[begin + 1]] + ..., added in
that order in float32 and rounded to the table's type after every add, up
to the slot's end or its first row id >= the table's rows; a slot with no
such row is zero. Nothing here waits for the card. The plain PyTorch
version serves CPU tensors and the checks on the card; a CUDA tensor
always launches the kernel.

Weighted lookups: the JAX package sorts (row, slot, w) by row, stable
(collection.py:884-888), and pools rows * w.astype(table dtype) in the
table's type (:890-900). `segments(..., weights=)` carries the weights
through its sort (stable, so equal (slot, row) pairs keep their order),
and `ordered_pool(..., weights=)` multiplies each row by its weight
rounded to the table's type, rounds the product to that type, then adds in
the same order with one rounding per add.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _lib

LAUNCHES = {"ordered_pool": 0}  # kernel launches (CUDA tensors)
PLAIN_CALLS = {"ordered_pool": 0}  # plain-version calls (CPU tensors)
WEIGHTED_LAUNCHES = {"ordered_pool": 0}  # the launches above with per-key weights


def segments(rows: torch.Tensor, slots: torch.Tensor, n_slots: int, sentinel: int,
             weights: Optional[torch.Tensor] = None):
    """(the rows of pairs (rows[i], slots[i]) sorted by slot, then by row;
    [n_slots + 1] int64 offsets of each slot's rows), slots in [0,
    n_slots), rows in [0, sentinel]. With `weights` ([K] float32, one a
    pair) a third entry, the weights in the same order (a stable sort:
    equal pairs keep their order)."""
    key = slots.to(torch.int64) * (sentinel + 1) + rows
    if weights is None:
        key = torch.sort(key).values
    else:
        key, perm = torch.sort(key, stable=True)
    bounds = torch.arange(n_slots + 1, dtype=torch.int64, device=rows.device) * (sentinel + 1)
    out = ((key % (sentinel + 1)).contiguous(), torch.searchsorted(key, bounds))
    return out if weights is None else (*out, weights[perm].contiguous())


def ordered_pool_plain(table: torch.Tensor, rows: torch.Tensor, offsets: torch.Tensor,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: position p of every slot that
    has one, p = 0, 1, ..., each add taken in float32 and rounded to the
    table's type; a slot ends at its first row id >= the table's rows. With
    `weights`, each row first times its weight in the table's type."""
    n = offsets.numel() - 1
    acc = torch.zeros((n, table.shape[1]), dtype=table.dtype, device=table.device)
    # each slot's rows before its first id >= R (those come last in a slot)
    before = torch.zeros(rows.numel() + 1, dtype=torch.int64, device=rows.device)
    torch.cumsum((rows < table.shape[0]).to(torch.int64), dim=0, out=before[1:])
    lens = before[offsets[1:]] - before[offsets[:-1]]
    for p in range(int(lens.max()) if n else 0):
        live = torch.nonzero(lens > p).squeeze(1)
        x = table[rows[offsets[live] + p]]
        if weights is not None:
            wj = weights[offsets[live] + p].to(table.dtype).float()
            x = (x.float() * wj.unsqueeze(1)).to(table.dtype)
        acc[live] = (acc[live].float() + x.float()).to(table.dtype)
    return acc


def ordered_pool(table: torch.Tensor, rows: torch.Tensor, offsets: torch.Tensor,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[n_slots, E] slot sums of `table` [R, E] (float32 or bfloat16) rows
    `rows` (int64, slot by slot), slot s over rows[offsets[s]:offsets[s +
    1]] in order up to its first row id >= R (such ids come last in a slot,
    as `segments` orders them), rounded to the table's type after every
    add; `weights` ([K] float32, aligned with `rows`) scales each row
    first, the product rounded to the table's type."""
    _lib.require(table.dim() == 2, f"table must be [R, E], got {tuple(table.shape)}")
    _lib.require(table.dtype in _lib.DTYPE_CODE, f"table dtype {table.dtype} not f32/bf16")
    _lib.require(rows.dtype == torch.int64 and rows.dim() == 1, "rows must be int64 [K]")
    _lib.require(offsets.dtype == torch.int64 and offsets.dim() == 1 and offsets.numel() >= 1,
                 "offsets must be int64 [n_slots + 1]")
    _lib.require(rows.device == table.device == offsets.device, "table, rows and offsets on different devices")
    _lib.require(weights is None or (weights.dtype == torch.float32 and weights.shape == rows.shape
                                     and weights.device == rows.device),
                 "weights must be float32, one a row id, on the rows' device")
    if table.device.type == "cpu":
        PLAIN_CALLS["ordered_pool"] += 1
        return ordered_pool_plain(table, rows, offsets, weights)
    _lib.require(table.device.type == "cuda", f"unsupported device {table.device}")
    _lib.require(table.is_contiguous() and rows.is_contiguous() and offsets.is_contiguous()
                 and (weights is None or weights.is_contiguous()), "inputs must be contiguous")
    n_slots, e = offsets.numel() - 1, table.shape[1]
    out = torch.empty((n_slots, e), dtype=table.dtype, device=table.device)
    if n_slots == 0 or e == 0:
        return out
    with torch.cuda.device(table.device):
        rc = _lib.library().hctr_ordered_pool(
            _lib.DTYPE_CODE[table.dtype], table.data_ptr(), table.shape[0], rows.data_ptr(),
            weights.data_ptr() if weights is not None else None, offsets.data_ptr(),
            out.data_ptr(), n_slots, e, _lib.vec_width(e, table, out), _lib.stream_of(table),
        )
    _lib.check(rc, "ordered_pool")
    LAUNCHES["ordered_pool"] += 1
    WEIGHTED_LAUNCHES["ordered_pool"] += weights is not None
    return out

