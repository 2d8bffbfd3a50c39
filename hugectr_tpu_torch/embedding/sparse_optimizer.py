"""Sparse (per-touched-row) embedding optimizers.

Counterpart of hugectr_tpu/embedding/sparse_optimizer.py for the update
routes of the training slice:

* the dense sweep (`apply_sparse`, sparse_optimizer.py:428-505): small
  shards, or big shards whose key count reaches `dense_ratio` x rows, add
  their row gradients into a dense [R, E] buffer and run one element-wise
  pass (`apply_dense`, :254);
* the sorted route (:623-643): sort (row, grad-source) pairs, gather the
  gradient rows, take segmented running sums with the segscan kernel
  (`dedup_rows` scan contract, :127-149) and update the segment tails
  (`_apply_rows`, :752).

The JAX package returns new arrays; the port updates tables and state in
place, which saves a table-sized copy per group and step. Out-of-range
indices are masked or compacted explicitly: torch's index ops do not drop
them the way XLA's "drop"/"fill" modes do.

Only AdaGrad and RowWiseAdaGrad are ported; the others raise.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.types import Optimizer_t
from ..ops.segscan import segmented_sum_sorted
from ..optim.params import OptParams

State = Dict[str, torch.Tensor]

_PORTED = (Optimizer_t.AdaGrad, Optimizer_t.RowWiseAdaGrad)


def _require_ported(kind: Optimizer_t) -> None:
    if kind not in _PORTED:
        raise NotImplementedError(
            f"sparse optimizer {kind.value} is not ported yet (ROADMAP Queue 1 item 5)"
        )


def init_state(
    opt: OptParams, rows: int, ev: int, dtype=torch.float32, device=None
) -> State:
    """Per-row optimizer state for a [rows, ev] table (sparse_optimizer.py:60)."""
    _require_ported(opt.optimizer)
    width = 1 if opt.optimizer == Optimizer_t.RowWiseAdaGrad else ev
    return {
        "accum": torch.full((rows, width), opt.initial_accu_value, dtype=dtype, device=device)
    }


def dedup_rows(
    idx: torch.Tensor, src: torch.Tensor, dsrc: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scan contract of `dedup_rows` (sparse_optimizer.py:127-149).

    idx [K] row ids (invalid entries carry the sentinel R, which sorts
    last); src [K] row of `dsrc` [S, E] holding each key's gradient.
    Returns (sorted row ids with duplicates, inclusive segmented sums, tail
    mask): the tail row of each run of equal ids holds the run's full sum.
    The sort is stable, like lax.sort, so sums are taken in the same order.
    """
    sidx, perm = torch.sort(idx, stable=True)
    sgrads = dsrc[src[perm]]
    k = sidx.shape[0]
    head = torch.ones(k, dtype=torch.bool, device=idx.device)
    head[1:] = sidx[1:] != sidx[:-1]
    summed = segmented_sum_sorted(sgrads.contiguous(), head)
    tail = torch.ones_like(head)
    tail[:-1] = head[1:]
    return sidx, summed, tail


def apply_dense(
    opt: OptParams,
    table: torch.Tensor,
    state: State,
    grad: torch.Tensor,
    touched: torch.Tensor,
    lr: torch.Tensor,
) -> None:
    """Full-table update with lazy-row semantics, in place
    (sparse_optimizer.py:254): untouched rows keep table and state."""
    kind = opt.optimizer
    _require_ported(kind)
    g = grad.float()
    if kind == Optimizer_t.AdaGrad:
        accum = state["accum"] + g * g
        table.add_((-lr * g / (torch.sqrt(accum) + opt.epsilon)).to(table.dtype))
        state["accum"].copy_(accum)
        return
    # RowWiseAdaGrad: the sqrt stays float32 here (:297-303)
    g2 = torch.mean(g * g, dim=1, keepdim=True)
    accum = state["accum"].float() + g2
    table.add_((-lr * g / (torch.sqrt(accum) + opt.epsilon)).to(table.dtype))
    state["accum"].copy_(torch.where(touched.unsqueeze(1), accum, state["accum"].float()))


def _apply_rows(
    opt: OptParams,
    table: torch.Tensor,
    state: State,
    lr: torch.Tensor,
    uidx: torch.Tensor,
    g: torch.Tensor,
) -> None:
    """Per-row update of unique rows `uidx` with summed gradients `g`, in
    add form like the JAX dup-mode scatters (sparse_optimizer.py:752-844)."""
    kind = opt.optimizer
    _require_ported(kind)
    acc = state["accum"]
    accum_old = acc[uidx]
    if kind == Optimizer_t.AdaGrad:
        accum = accum_old + g * g
        delta = -lr * g / (torch.sqrt(accum) + opt.epsilon)
    else:
        # RowWiseAdaGrad: mean of g^2 in f32; sqrt cast to g's type (:840)
        g2 = torch.mean(torch.square(g.float()), dim=1, keepdim=True)
        accum = accum_old.float() + g2
        delta = -lr * g / (torch.sqrt(accum).to(g.dtype) + opt.epsilon)
    table.index_add_(0, uidx, delta.to(table.dtype))
    acc.index_add_(0, uidx, (accum - accum_old).to(acc.dtype))


def update_route(rows: int, k: int, dense_rows: int, dense_ratio: float) -> str:
    """"dense" for shards of at most `dense_rows` rows or with at least
    `dense_ratio` x rows keys (sparse_optimizer.py:440-447; the AdaGrad
    family only, which is all this slice ports), else "sorted"."""
    ratio_dense = dense_ratio > 0 and rows > 0 and k >= rows * dense_ratio
    return "dense" if (0 < rows <= dense_rows) or ratio_dense else "sorted"


def apply_sparse(
    opt: OptParams,
    table: torch.Tensor,
    state: State,
    idx: torch.Tensor,
    src: torch.Tensor,
    dsrc: torch.Tensor,
    lr: torch.Tensor,
    dense_rows: int,
    dense_ratio: float,
) -> str:
    """One sparse update for (possibly duplicated) row gradients, in place
    (sparse_optimizer.py:343). idx [K] rows with the sentinel R for invalid
    keys; src [K] rows of dsrc [S, E]. Returns the route it took."""
    _require_ported(opt.optimizer)
    rows = table.shape[0]
    route = update_route(rows, idx.shape[0], dense_rows, dense_ratio)
    if route == "dense":
        valid = idx < rows
        grad = torch.zeros((rows, dsrc.shape[1]), dtype=torch.float32, device=table.device)
        grad.index_add_(0, idx[valid], dsrc[src[valid]].float())
        # AdaGrad-family updates are exact no-ops on a zero gradient, so the
        # touched mask comes from the buffer itself (:499-501)
        touched = torch.any(grad != 0, dim=1)
        apply_dense(opt, table, state, grad, touched, lr)
        return route
    sidx, summed, tail = dedup_rows(idx, src, dsrc.to(table.dtype))
    # only tails carry full sums; keeping them makes the rows unique
    keep = tail & (sidx < rows)
    _apply_rows(opt, table, state, lr, sidx[keep], summed[keep])
    return route
