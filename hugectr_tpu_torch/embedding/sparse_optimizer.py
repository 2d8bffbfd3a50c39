"""Sparse (per-touched-row) embedding optimizers.

Counterpart of hugectr_tpu/embedding/sparse_optimizer.py: SGD, MomentumSGD,
Nesterov, AdaGrad, RowWiseAdaGrad, RMSProp, Adam and FTRL on the update
routes of one device:

* SGD (`apply_sparse`, sparse_optimizer.py:403-410) is stateless: one
  drop-mode add of -lr x each key's gradient into the table
  (`ops/row_scatter.py::scatter_add_rows_`: the whole key list, the
  sentinel rows skipped, as mode="drop" skips them), no sort;
* the dense sweep (:428-505): small shards, or (AdaGrad family only) big
  shards whose key count reaches `dense_ratio` x rows, add their row
  gradients into a dense float32 [R, E] buffer with the drop-mode scatter
  (`ops/row_scatter.py`: the whole key list, the sentinel rows skipped, as
  mode="drop" skips them, :486) and run one element-wise pass
  (`apply_dense`, :254). The AdaGrad family is an exact no-op on a
  zero summed gradient, so its touched rows are those with a nonzero
  gradient; the others (Momentum and Adam decay the moments of a touched
  row, FTRL recomputes its weights from z) count touches exactly: a row
  is touched when a valid key lands on it (the JAX package's ones column,
  :464-504);
* the sorted route (:506-621): sort (row, grad-source) pairs; invalid
  keys carry the sentinel row and sort last (:607). For the AdaGrad family,
  FTRL and Adam (`COUNTED`, `_sorted_rows`) the step has a fixed shape and no
  host sync: the count of the valid prefix stays on the device, the
  segscan kernel sums the prefix's gradient rows in float32 (reading them
  through the sorted order itself) and stops at the count, and the
  drop-mode row update (`adagrad_rows`, `ftrl_rows`, `adam_rows`) updates
  each segment tail, the unique rows (`_apply_rows`, :752, :855-891), so
  the card does the valid keys' work and not the padding's. Momentum,
  Nesterov and RMSProp, the packed layouts and the drop mode keep the valid
  prefix on the host (`dedup_rows` scan contract, :127-149), gather it,
  sum it and update the tails with `index_add_` / `index_copy_`.

Tables may be bfloat16 and the state bfloat16: the update math runs in
float32 and each result is rounded once to its array's type, at the JAX
package's cast points (`sel(new.astype(old.dtype))`, :272-338; the row
route adds the delta rounded to the table's type or sets the new value,
:780-893). Adam's bias corrections are float32 scalars of the global step
(:311-318): the device scalars of the model's `StepScalars`, filled before
each step (`optim/params.py`), or the float32 values of an int step.

The unique-row windows (sparse_optimizer.py:238-251, :585-621, :645-659):
the JAX package runs the update on a static prefix of `ucap` unique rows
(a factor of the key list, or the cap `auto_unique_caps` measured) and on a
prefix of `valid_cap` sorted keys, each with a fallback to the whole list
when a batch overflows it, so both are exact and the port, whose shapes
follow the batch, updates every unique row of the valid prefix. The one
exception is the capacity-drop mode (`ucap_drop`, HCTR_TPU_UCAP_DROP,
:590-594, :650-651): the rows past the first `ucap` sorted unique rows lose
their gradients, the reference's comm-buffer semantics, and the port drops
them too. The route rule counts the measured valid keys where there is a
cap (`k_eff`, :440-447).

Packed table-and-state storage (`packed`, :412-421, :661-749): "full" is
AdaGrad's [R, 2E] (weights, then the accumulators), "rowwise"
RowWiseAdaGrad's [R, E + 1] (the scalar accumulator as column E). Such a
group takes the sorted route whatever its size (:447), and one add of the
weights' delta and the accumulator's increment, each rounded to the
table's type, updates the row: the stored accumulator is the table's type
and takes the increment rounded once more than separate state does.

The JAX package returns new arrays; the port updates tables and state in
place, which saves a table-sized copy per group and step. Every row a
formula reads is gathered before any row is written. Out-of-range indices
are skipped by the drop-mode kernels, or masked or compacted explicitly:
torch's index ops do not drop them the way XLA's "drop"/"fill" modes do.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.types import Optimizer_t
from ..ops.row_scatter import adagrad_rows, adam_rows, ftrl_rows, scatter_add_rows, scatter_add_rows_
from ..ops.segscan import segmented_sum_sorted
from ..optim.params import OptParams, bias_corrections

State = Dict[str, torch.Tensor]

# exact no-ops on a zero summed gradient (sparse_optimizer.py:471)
ADAGRAD_FAMILY = (Optimizer_t.AdaGrad, Optimizer_t.RowWiseAdaGrad)
# the optimizers whose sorted route is counted on the device (a fixed
# shape, no host sync): a drop-mode row update each
COUNTED = (*ADAGRAD_FAMILY, Optimizer_t.FTRL, Optimizer_t.Adam)
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
    opt: OptParams, w: torch.Tensor, st: State, g: torch.Tensor, lr: torch.Tensor, step=1
) -> Tuple[str, torch.Tensor, State]:
    """One update of rows `w` with state rows `st` and float32 gradient `g`,
    as the JAX package writes it (sparse_optimizer.py:278-338, :805-891).
    `step` gives Adam's bias corrections (`optim.params.bias_corrections`:
    a `StepScalars`, an int step, or the pair itself). Returns ("add",
    delta) or ("set", new value) for the table, and the new state rows;
    nothing is rounded or written here. bfloat16 state is read
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
        bc1, bc2 = bias_corrections(opt, step)
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
    step=1,
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
    step=1,
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


def unique_cap(k: int, factor: float = 0.0, min_k: int = 0) -> int:
    """The unique-row window of a k-key list (sparse_optimizer.py:238):
    k x factor rounded up to a multiple of 512, at most k; 0 (no window) for
    a factor outside (0, 1) or a list shorter than `min_k`."""
    if factor <= 0 or factor >= 1:
        return 0
    if min_k and k < min_k:
        return 0
    return min(k, ((int(k * factor) + 511) // 512) * 512)


def update_route(
    rows: int, k: int, dense_rows: int, dense_ratio: float,
    kind: Optimizer_t = Optimizer_t.RowWiseAdaGrad, valid_cap: int = 0, packed=False,
) -> str:
    """The route `apply_sparse` takes for `k` keys into `rows` rows:
    "scatter" for SGD; "dense" for shards of at most `dense_rows` rows or,
    for the AdaGrad family only, with at least `dense_ratio` x rows keys,
    counting the measured `valid_cap` where it is below k
    (sparse_optimizer.py:440-447); else "sorted", which a packed group
    always takes."""
    if kind == Optimizer_t.SGD:
        return "scatter"
    k_eff = valid_cap if 0 < valid_cap < k else k
    ratio_dense = (
        kind in ADAGRAD_FAMILY and dense_ratio > 0 and rows > 0 and k_eff >= rows * dense_ratio
    )
    return "dense" if not packed and ((0 < rows <= dense_rows) or ratio_dense) else "sorted"


def _apply_rows_packed(opt: OptParams, table: torch.Tensor, lr: torch.Tensor, uidx: torch.Tensor,
                       g: torch.Tensor) -> None:
    """AdaGrad on packed [R, 2E] rows (sparse_optimizer.py:711-749): the
    delta from the old accumulators plus g^2 in float32, and one add of
    (delta, g^2), each rounded to the table's type, into the rows."""
    if opt.optimizer != Optimizer_t.AdaGrad:
        raise ValueError("packed storage currently supports AdaGrad only")
    ev = table.shape[1] // 2
    gg = g * g
    accum = table[uidx, ev:].float() + gg
    delta_w = -lr * g / (torch.sqrt(accum) + opt.epsilon)
    table.index_add_(0, uidx, torch.cat([delta_w, gg], dim=1).to(table.dtype))


def _apply_rows_rowwise_packed(opt: OptParams, table: torch.Tensor, lr: torch.Tensor, uidx: torch.Tensor,
                               g: torch.Tensor) -> None:
    """RowWiseAdaGrad on packed [R, E + 1] rows (sparse_optimizer.py:661-708):
    the mean of g^2 over the row in float32, the delta from the old
    accumulator plus that mean, and one add of (delta, mean), each rounded
    to the table's type, into the rows."""
    if opt.optimizer != Optimizer_t.RowWiseAdaGrad:
        raise ValueError("rowwise-packed storage requires RowWiseAdaGrad")
    ev = table.shape[1] - 1
    g2 = torch.mean(torch.square(g.float()), dim=1, keepdim=True)
    accum = table[uidx, ev:].float() + g2
    delta_w = -lr * g / (torch.sqrt(accum).to(g.dtype) + opt.epsilon)
    table.index_add_(0, uidx, torch.cat([delta_w.to(table.dtype), g2.to(table.dtype)], dim=1))


def bf16_row_sums(idx: torch.Tensor, src: torch.Tensor, vals: torch.Tensor, rows: int) -> torch.Tensor:
    """[rows, E] bfloat16 sums of the rows vals[src] at rows idx ([K], the
    sentinel R and above dropped), each cast to bfloat16 and added with a
    rounding after every add (sparse_optimizer.py:476-489, the bf16
    dense-sweep buffer). On the CPU the adds go in the JAX package's order,
    by row and then by position (its stable sort of (idx, src) by idx), so
    the sums are bitwise its own; that order takes the valid keys out
    first and makes one pass per add of the busiest row, which shapes the
    work by the data and reads the pass count on the host. It stays so:
    no CPU op adds into bfloat16 with a rounding after every add (the
    CPU's `index_add_` sums a row's adds in float32 first), and no
    captured configuration takes this buffer. On the card the drop-mode
    scatter (`ops/row_scatter.py`) adds into the bf16 buffer in no fixed
    order, as `index_add_` does: a row of n entries differs by about 2^-8 x
    sqrt(n) of its magnitude."""
    if vals.device.type != "cpu":
        return scatter_add_rows(idx, src, vals, rows, torch.bfloat16)
    valid = idx < rows
    idx, src = idx[valid], src[valid]
    buf = torch.zeros((rows, vals.shape[1]), dtype=torch.bfloat16, device=vals.device)
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


def _sorted_rows(opt: OptParams, table: torch.Tensor, state: State, idx: torch.Tensor, src: torch.Tensor,
                 dsrc: torch.Tensor, lr: torch.Tensor, k_limit: int = 0, step=1) -> None:
    """The sorted route of a `COUNTED` optimizer at a fixed shape: the
    stable sort of the whole list (cut to `k_limit` entries, a static
    length), the count of its valid prefix kept on the device, the
    segmented sums of the sorted keys' gradient rows over that prefix only
    (segscan reads dsrc[src[perm]] in its loads), and the update of each
    segment tail among them by the drop-mode row update
    (`ops/row_scatter.py`: `adagrad_rows`, `ftrl_rows`, `adam_rows`, the
    last with `step`'s bias corrections as device scalars). The work past the
    count, the list's padding, is skipped on the card; no shape or host
    value depends on the batch, as in the JAX package's cond over the
    measured valid cap (:596-621), whose branches agree."""
    sidx, perm = torch.sort(idx, stable=True)
    if 0 < k_limit < sidx.shape[0]:
        sidx, perm = sidx[:k_limit], perm[:k_limit]
    count = torch.count_nonzero(sidx < table.shape[0])
    head = torch.ones(sidx.shape[0], dtype=torch.bool, device=idx.device)
    head[1:] = sidx[1:] != sidx[:-1]
    summed = segmented_sum_sorted(dsrc.to(table.dtype).contiguous(), head, torch.float32, count, src[perm])
    if opt.optimizer == Optimizer_t.FTRL:
        ftrl_rows(opt, table, state["z"], state["n"], sidx, summed, count, lr)
    elif opt.optimizer == Optimizer_t.Adam:
        bc1, bc2 = (torch.as_tensor(b, dtype=torch.float32, device=table.device)
                    for b in bias_corrections(opt, step))
        adam_rows(opt, table, state["m"], state["v"], sidx, summed, count, lr, bc1, bc2)
    else:
        adagrad_rows(opt, table, state["accum"], sidx, summed, count, lr)


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
    step=1,
    k_limit: int = 0,
    grad_dtype: torch.dtype = torch.float32,
    ucap_factor: float = 0.0,
    ucap_min_k: int = 0,
    ucap_drop: bool = False,
    ucap_cap: int = 0,
    valid_cap: int = 0,
    packed=False,
    stats: Optional[Dict[str, int]] = None,
) -> str:
    """One sparse update for (possibly duplicated) row gradients, in place
    (sparse_optimizer.py:343). idx [K] rows with the sentinel R for invalid
    keys; src [K] rows of dsrc [S, E]. A `k_limit` > 0 (the owner-partition
    capacity) keeps the first k_limit entries of the stable sort by row on
    the dense and sorted routes and drops the rest; SGD's scatter takes
    every entry (:403-410, :460-462, :515-518). The route is chosen on the
    whole K, or on the measured `valid_cap` below it. `grad_dtype` bfloat16
    gives the AdaGrad family's dense sweep a bf16 gradient buffer
    (`bf16_row_sums`); the other optimizers keep float32 and the exact
    touch count (:471-476). `ucap_factor` / `ucap_min_k` (a window of
    `unique_cap`) or a measured `ucap_cap`, with `ucap_drop`, keep only the
    first unique rows of the window on the sorted route; without
    `ucap_drop` the windows are exact and change nothing. `packed` "full"
    or "rowwise": `table` holds the state in its trailing columns and
    `state` is empty. `stats`, given, counts the rows the drop mode dropped
    under "ucap_dropped". Returns the route it took."""
    kind = opt.optimizer
    rows = table.shape[0]
    route = update_route(rows, idx.shape[0], dense_rows, dense_ratio, kind, valid_cap, packed)
    if route == "dense" and 0 < k_limit < idx.shape[0]:
        perm = torch.sort(idx, stable=True).indices[:k_limit]
        idx, src = idx[perm], src[perm]
    if route == "scatter":
        # the drop-mode add of every entry's -lr g into the table (:408)
        scatter_add_rows_(table, idx, src, -lr * dsrc.to(table.dtype))
        return route
    if route == "dense":
        # the drop-mode scatter skips the sentinel rows (mode="drop", :486)
        if grad_dtype == torch.bfloat16 and kind in ADAGRAD_FAMILY:
            grad = bf16_row_sums(idx, src, dsrc, rows)
        else:
            grad = scatter_add_rows(idx, src, dsrc, rows, torch.float32)
        if kind in ADAGRAD_FAMILY:
            touched = torch.any(grad != 0, dim=1)
        else:
            # a row is touched when a valid key lands on it, whatever its
            # summed gradient: the JAX package's touch-count column > 0;
            # the sentinel marks a spare row, dropped
            touched = torch.zeros(rows + 1, dtype=torch.bool, device=table.device)
            touched.index_fill_(0, torch.where(idx < rows, idx, rows), True)
            touched = touched[:rows]
        apply_dense(opt, table, state, grad, touched, lr, step)
        return route
    if kind in COUNTED and not packed and not ucap_drop:
        _sorted_rows(opt, table, state, idx, src, dsrc, lr, k_limit, step)
        return route
    sidx, summed, tail = dedup_rows(idx, src, dsrc.to(table.dtype), rows, k_limit)
    # only tails carry full sums; keeping them makes the rows unique
    uidx, g = sidx[tail], summed[tail]
    if ucap_drop:
        # the list the JAX package windows (:506-518, :585-594, :645-651):
        # below 2^24 rows the valid prefix when it fits the measured cap,
        # else the whole (k_limit-cut) list
        k = min(idx.shape[0], k_limit) if k_limit else idx.shape[0]
        kk = valid_cap if rows < (1 << 24) and 0 < valid_cap < k and sidx.shape[0] <= valid_cap else k
        ucap = min(kk, ucap_cap) if ucap_cap > 0 else unique_cap(kk, ucap_factor, ucap_min_k)
        if 0 < ucap < uidx.shape[0]:
            if stats is not None:
                stats["ucap_dropped"] = stats.get("ucap_dropped", 0) + uidx.shape[0] - ucap
            uidx, g = uidx[:ucap], g[:ucap]
    if packed == "rowwise":
        _apply_rows_rowwise_packed(opt, table, lr, uidx, g)
    elif packed:
        _apply_rows_packed(opt, table, lr, uidx, g)
    else:
        _apply_rows(opt, table, state, lr, uidx, g, step)
    return route
