"""Sparse (per-touched-row) embedding optimizers.

Counterpart of hugectr_tpu/embedding/sparse_optimizer.py: SGD, MomentumSGD,
Nesterov, AdaGrad, RowWiseAdaGrad, RMSProp, Adam and FTRL on the update
routes of one device:

* SGD (`apply_sparse`, sparse_optimizer.py:403-410) is stateless: one
  masked `index_add_` of -lr x each key's gradient, no sort;
* the dense sweep (:428-505): small shards, or (AdaGrad family only) big
  shards whose key count reaches `dense_ratio` x rows, add their row
  gradients into a dense float32 [R, E] buffer and run one element-wise
  pass (`apply_dense`, :254). The AdaGrad family is an exact no-op on a
  zero summed gradient, so its touched rows are those with a nonzero
  gradient; the others (Momentum and Adam decay the moments of a touched
  row, FTRL recomputes its weights from z) count touches exactly: a row
  is touched when a valid key lands on it (the JAX package's ones column,
  :464-504);
* the sorted route (:506-621): sort (row, grad-source) pairs, keep the
  valid prefix (invalid keys carry the sentinel row and sort last, :607),
  gather its gradient rows, take segmented running sums in float32 with the
  segscan kernel (`dedup_rows` scan contract, :127-149) and update the
  segment tails, which are the unique rows (`_apply_rows`, :752).

Tables may be bfloat16 and the state bfloat16: the update math runs in
float32 and each result is rounded once to its array's type, at the JAX
package's cast points (`sel(new.astype(old.dtype))`, :272-338; the row
route adds the delta rounded to the table's type or sets the new value,
:780-893). Adam's bias corrections are float32 scalars of the global step
(:311-318).

The JAX package returns new arrays; the port updates tables and state in
place, which saves a table-sized copy per group and step. Every row a
formula reads is gathered before any row is written. Out-of-range indices
are masked or compacted explicitly: torch's index ops do not drop them the
way XLA's "drop"/"fill" modes do.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.types import Optimizer_t
from ..ops.segscan import segmented_sum_sorted
from ..optim.params import OptParams, adam_bias_corrections

State = Dict[str, torch.Tensor]

# exact no-ops on a zero summed gradient (sparse_optimizer.py:471)
ADAGRAD_FAMILY = (Optimizer_t.AdaGrad, Optimizer_t.RowWiseAdaGrad)
# the routes that sum duplicate rows with `index_add_`, whose atomics on
# the card sum in an order that differs from run to run; the sorted route
# is deterministic
ATOMIC_ROUTES = ("scatter", "dense")


def init_state(
    opt: OptParams, rows: int, ev: int, dtype=torch.float32, device=None
) -> State:
    """Per-row optimizer state for a [rows, ev] table (sparse_optimizer.py:60)."""
    kind = opt.optimizer

    def z():
        return torch.zeros((rows, ev), dtype=dtype, device=device)

    if kind == Optimizer_t.SGD:
        return {}
    if kind in (Optimizer_t.MomentumSGD, Optimizer_t.Nesterov):
        return {"m": z()}
    if kind in ADAGRAD_FAMILY:
        width = 1 if kind == Optimizer_t.RowWiseAdaGrad else ev
        return {"accum": torch.full((rows, width), opt.initial_accu_value, dtype=dtype, device=device)}
    if kind == Optimizer_t.RMSProp:
        return {"v": z()}
    if kind == Optimizer_t.Adam:
        return {"m": z(), "v": z()}
    if kind == Optimizer_t.FTRL:
        return {"z": z(), "n": z()}
    raise ValueError(f"unsupported sparse optimizer {kind}")


def update_math(
    opt: OptParams, w: torch.Tensor, st: State, g: torch.Tensor, lr: torch.Tensor, step: int
) -> Tuple[str, torch.Tensor, State]:
    """One update of rows `w` with state rows `st` and float32 gradient `g`,
    as the JAX package writes it (sparse_optimizer.py:278-338, :805-891).
    Returns ("add", delta) or ("set", new value) for the table, and the new
    state rows; nothing is rounded or written here. bfloat16 state is read
    as float32: XLA computes a bfloat16 product such as beta1 * m in float32
    without rounding it (excess precision), and so does this."""
    kind = opt.optimizer
    raw, st = st, {k: v.float() for k, v in st.items()}
    if kind == Optimizer_t.SGD:
        return "add", -lr * g, {}
    if kind in (Optimizer_t.MomentumSGD, Optimizer_t.Nesterov):
        m = opt.momentum_factor * st["m"] - lr * g
        if kind == Optimizer_t.MomentumSGD:
            return "add", m, {"m": m}
        return "add", opt.momentum_factor * m - lr * g, {"m": m}
    if kind == Optimizer_t.AdaGrad:
        accum = st["accum"] + g * g
        return "add", -lr * g / (torch.sqrt(accum) + opt.epsilon), {"accum": accum}
    if kind == Optimizer_t.RowWiseAdaGrad:
        # the mean of g^2 over the row in float32 (:836)
        accum = st["accum"] + torch.mean(torch.square(g.float()), dim=1, keepdim=True)
        return "add", -lr * g / (torch.sqrt(accum).to(g.dtype) + opt.epsilon), {"accum": accum}
    if kind == Optimizer_t.RMSProp:
        v = opt.beta * st["v"] + (1.0 - opt.beta) * g * g
        return "add", -lr * g / (torch.sqrt(v) + opt.epsilon), {"v": v}
    if kind == Optimizer_t.Adam:
        bc1, bc2 = adam_bias_corrections(opt, step)
        m = opt.beta1 * st["m"] + (1.0 - opt.beta1) * g
        v = opt.beta2 * st["v"] + (1.0 - opt.beta2) * g * g
        delta = -lr * (m / bc1) / (torch.sqrt(v / bc2) + opt.epsilon)
        return "add", delta, {"m": m, "v": v}
    if kind == Optimizer_t.FTRL:
        # FTRL-proximal; w is the table's own type, the rest float32, but the
        # square root of the old n is taken in n's type, as jnp.sqrt does
        # (:324-338)
        n_old, z_old = st["n"], st["z"]
        n_new = n_old + g * g
        sigma = (torch.sqrt(n_new) - torch.sqrt(raw["n"]).float()) / lr
        z_new = z_old + g - sigma * w
        denom = (opt.ftrl_beta + torch.sqrt(n_new)) / lr + opt.lambda2
        w_new = torch.where(
            torch.abs(z_new) > opt.lambda1,
            -(z_new - torch.sign(z_new) * opt.lambda1) / denom,
            torch.zeros_like(z_new),
        )
        return "set", w_new, {"z": z_new, "n": n_new}
    raise ValueError(f"unsupported sparse optimizer {kind}")


def dedup_rows(
    idx: torch.Tensor, src: torch.Tensor, dsrc: torch.Tensor, rows: Optional[int] = None, k_limit: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scan contract of `dedup_rows` (sparse_optimizer.py:127-149).

    idx [K] row ids (invalid entries carry the sentinel R, which sorts
    last); src [K] row of `dsrc` [S, E] holding each key's gradient.
    Returns (sorted row ids with duplicates, inclusive segmented sums in
    float32 for float32 or bfloat16 `dsrc`, tail mask): the tail row of
    each run of equal ids holds the run's full sum. The sort is stable, like
    lax.sort, so sums are taken in the same order. Given `rows` (= R), only
    the valid prefix (ids < R) is kept: the same sums for the valid rows,
    without gathering and scanning the padding (sparse_optimizer.py:607).
    A `k_limit` > 0 keeps at most the first k_limit sorted entries and drops
    the rest (the owner-partition capacity, :120-125).
    """
    sidx, perm = torch.sort(idx, stable=True)
    if rows is not None or k_limit:
        n = int(torch.count_nonzero(sidx < rows)) if rows is not None else sidx.shape[0]
        n = min(n, k_limit) if k_limit else n
        sidx, perm = sidx[:n], perm[:n]
    sgrads = dsrc[src[perm]]
    k = sidx.shape[0]
    head = torch.ones(k, dtype=torch.bool, device=idx.device)
    head[1:] = sidx[1:] != sidx[:-1]
    summed = segmented_sum_sorted(sgrads.contiguous(), head, torch.float32)
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
    step: int = 1,
) -> None:
    """Full-table update with lazy-row semantics, in place
    (sparse_optimizer.py:254): untouched rows keep table and state. New
    rows are computed in float32 (table + delta, or the new value) and
    rounded once to each array's type."""
    kind = opt.optimizer
    g = grad.float()
    if kind == Optimizer_t.AdaGrad:
        # an exact no-op on untouched rows (g = 0): no select (:290-295)
        accum = state["accum"] + g * g
        table.copy_(table + (-lr * g / (torch.sqrt(accum) + opt.epsilon)))
        state["accum"].copy_(accum)
        return
    op, val, new = update_math(opt, table, state, g, lr, step)
    mask = touched.unsqueeze(1)
    if kind in (Optimizer_t.SGD, Optimizer_t.RowWiseAdaGrad):
        table.copy_(table + val)  # zero-gradient rows are unchanged (:279, :301)
    else:
        table.copy_(torch.where(mask, (table + val if op == "add" else val).to(table.dtype), table))
    for k, v in new.items():
        state[k].copy_(torch.where(mask, v.to(state[k].dtype), state[k]))


def _apply_rows(
    opt: OptParams,
    table: torch.Tensor,
    state: State,
    lr: torch.Tensor,
    uidx: torch.Tensor,
    g: torch.Tensor,
    step: int = 1,
) -> None:
    """Per-row update of unique rows `uidx` with float32 summed gradients
    `g`, as the JAX package's unique-row route (sparse_optimizer.py:752-893):
    the table adds the delta rounded to its type (FTRL sets the new
    weights), the state is set to the new value rounded to its type."""
    old = {k: a[uidx] for k, a in state.items()}
    w = table[uidx] if opt.optimizer == Optimizer_t.FTRL else table
    op, val, new = update_math(opt, w, old, g, lr, step)
    if op == "add":
        table.index_add_(0, uidx, val.to(table.dtype))
    else:
        table.index_copy_(0, uidx, val.to(table.dtype))
    for k, v in new.items():
        state[k].index_copy_(0, uidx, v.to(state[k].dtype))


def update_route(
    rows: int, k: int, dense_rows: int, dense_ratio: float,
    kind: Optimizer_t = Optimizer_t.RowWiseAdaGrad,
) -> str:
    """The route `apply_sparse` takes for `k` keys into `rows` rows:
    "scatter" for SGD; "dense" for shards of at most `dense_rows` rows or,
    for the AdaGrad family only, with at least `dense_ratio` x rows keys
    (sparse_optimizer.py:440-447); else "sorted"."""
    if kind == Optimizer_t.SGD:
        return "scatter"
    ratio_dense = (
        kind in ADAGRAD_FAMILY and dense_ratio > 0 and rows > 0 and k >= rows * dense_ratio
    )
    return "dense" if (0 < rows <= dense_rows) or ratio_dense else "sorted"


def bf16_row_sums(idx: torch.Tensor, src: torch.Tensor, vals: torch.Tensor, rows: int) -> torch.Tensor:
    """[rows, E] bfloat16 sums of the rows vals[src] ([K] valid rows idx),
    each cast to bfloat16 and added with a rounding after every add
    (sparse_optimizer.py:476-489, the bf16 dense-sweep buffer). On the CPU
    the adds go in the JAX package's order, by row and then by position
    (its stable sort of (idx, src) by idx), so the sums are bitwise its
    own. On the card one `index_add_` into the bf16 buffer adds in no fixed
    order: a row of n entries differs by about 2^-8 x sqrt(n) of its
    magnitude."""
    buf = torch.zeros((rows, vals.shape[1]), dtype=torch.bfloat16, device=vals.device)
    if vals.device.type != "cpu":
        return buf.index_add_(0, idx, vals[src].to(torch.bfloat16))
    if idx.numel() == 0:
        return buf
    o = torch.sort(idx, stable=True).indices
    sidx, sv = idx[o], vals[src[o]].to(torch.bfloat16).float()
    pos = torch.arange(sidx.numel())
    head = torch.ones_like(sidx, dtype=torch.bool)
    head[1:] = sidx[1:] != sidx[:-1]
    rank = pos - torch.cummax(torch.where(head, pos, 0), 0).values
    for r in range(int(rank.max()) + 1):  # the r-th add of every row at once
        m = rank == r
        buf[sidx[m]] = (buf[sidx[m]].float() + sv[m]).to(torch.bfloat16)
    return buf


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
    step: int = 1,
    k_limit: int = 0,
    grad_dtype: torch.dtype = torch.float32,
) -> str:
    """One sparse update for (possibly duplicated) row gradients, in place
    (sparse_optimizer.py:343). idx [K] rows with the sentinel R for invalid
    keys; src [K] rows of dsrc [S, E]. A `k_limit` > 0 (the owner-partition
    capacity) keeps the first k_limit entries of the stable sort by row on
    the dense and sorted routes and drops the rest; SGD's scatter takes
    every entry (:403-410, :460-462, :515-518). The route is chosen on the
    whole K. `grad_dtype` bfloat16 gives the AdaGrad family's dense sweep a
    bf16 gradient buffer (`bf16_row_sums`); the other optimizers keep
    float32 and the exact touch count (:471-476). Returns the route it
    took."""
    kind = opt.optimizer
    rows = table.shape[0]
    route = update_route(rows, idx.shape[0], dense_rows, dense_ratio, kind)
    if route == "dense" and 0 < k_limit < idx.shape[0]:
        perm = torch.sort(idx, stable=True).indices[:k_limit]
        idx, src = idx[perm], src[perm]
    valid = idx < rows
    if route == "scatter":
        vidx = idx[valid]
        table.index_add_(0, vidx, -lr * dsrc.to(table.dtype)[src[valid]])
        return route
    if route == "dense":
        vidx = idx[valid]
        if grad_dtype == torch.bfloat16 and kind in ADAGRAD_FAMILY:
            grad = bf16_row_sums(vidx, src[valid], dsrc, rows)
        else:
            grad = torch.zeros((rows, dsrc.shape[1]), dtype=torch.float32, device=table.device)
            grad.index_add_(0, vidx, dsrc[src[valid]].float())
        if kind in ADAGRAD_FAMILY:
            touched = torch.any(grad != 0, dim=1)
        else:
            # a row is touched when a valid key lands on it, whatever its
            # summed gradient: the JAX package's touch-count column > 0
            touched = torch.zeros(rows, dtype=torch.bool, device=table.device)
            touched[vidx] = True
        apply_dense(opt, table, state, grad, touched, lr, step)
        return route
    sidx, summed, tail = dedup_rows(idx, src, dsrc.to(table.dtype), rows, k_limit)
    # only tails carry full sums; keeping them makes the rows unique
    _apply_rows(opt, table, state, lr, sidx[tail], summed[tail], step)
    return route
