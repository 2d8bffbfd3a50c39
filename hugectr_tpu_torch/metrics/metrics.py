"""Eval metrics: AUC, AverageLoss, HitRate, SMAPE, NDCG (counterpart of
hugectr_tpu/metrics/metrics.py).

Predictions and labels of an eval pass go into preallocated device buffers
of max_eval_batches x batch samples; each batch is one slice copy, and the
batch losses stay device scalars until `finalize`, so an eval pass makes no
host sync per batch. `finalize` computes each metric over the whole buffer,
padding masked by a `valid` buffer.

AUC is the Mann-Whitney rank sum with tied predictions given their average
rank (`auc_score`: one sort and two searchsorted). Above `auc_exact_max`
samples `auc_score_auto` takes the binned form (`auc_score_large`): the
float32 bits map in order onto 2^20 bins, two histogram adds and a closed
rank sum over the bins; it differs from the exact AUC only where one bin
holds positives and negatives of unequal predictions (< 1e-4 at 1M uniform
samples, tests/test_metrics.py:129). Sums are float32, as in the JAX
package.

Over W ranks each rank's buffers hold its block of every eval batch, and
`finalize` (called on every rank together) computes each metric over the
global eval set, as the JAX package does over its sharded buffers: the
exact AUC and the other metrics on the buffers all-gathered into the
global batch order, the binned AUC on all-reduced histograms, the choice
between them by the global sample count, and AverageLoss as the mean of
the global batch losses.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import torch

from ..core.mesh import all_gather, all_reduce
from ..core.types import Metric_t

AUC_EXACT_MAX = 8 * 1024 * 1024  # metrics.py:118
AUC_BINS_BITS = 20


def _flat(preds: torch.Tensor, labels: torch.Tensor, valid: Optional[torch.Tensor]):
    p = preds.reshape(-1).float()
    lab = labels.reshape(-1).float()
    v = torch.ones_like(p, dtype=torch.bool) if valid is None else valid.reshape(-1)
    return p, lab, v


def auc_score(preds: torch.Tensor, labels: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact ROC-AUC of labels in {0, 1}, ties at their average rank
    (metrics.py:29); invalid entries sort last and count for nothing."""
    p, lab, v = _flat(preds, labels, valid)
    p = torch.where(v, p, torch.inf)
    lab = torch.where(v, lab, 0.0)
    ps, order = torch.sort(p, stable=True)
    ls, vs = lab[order], v[order].float()
    first = torch.searchsorted(ps, ps, side="left").float() + 1.0
    last = torch.searchsorted(ps, ps, side="right").float()
    avg_rank = (first + last) * 0.5
    pos = torch.sum(ls * vs)
    neg = torch.sum((1.0 - ls) * vs)
    r_pos = torch.sum(avg_rank * ls * vs)
    auc = (r_pos - pos * (pos + 1.0) * 0.5) / torch.clamp(pos * neg, min=1.0)
    return torch.where((pos > 0) & (neg > 0), auc, 0.5)


def auc_score_large(
    preds: torch.Tensor, labels: torch.Tensor, valid: Optional[torch.Tensor] = None,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Binned rank-sum AUC (metrics.py:123): predictions tied within each of
    2^20 bins of the order-preserving map of their float32 bits. `reduce`
    sums the [2, bins] histograms over ranks (one all_reduce)."""
    p, lab, v = _flat(preds, labels, valid)
    b = p.view(torch.int32).long()
    # IEEE-754 order onto [0, 2^32): positive floats above negative ones
    key = torch.where(b >= 0, b + 2**31, torch.bitwise_not(b))
    bins = key >> (32 - AUC_BINS_BITS)
    n_bins = 1 << AUC_BINS_BITS
    lab = torch.where(v, lab, 0.0)
    vf = v.float()
    hist = torch.zeros((2, n_bins), device=p.device)
    hist[0].index_add_(0, bins, lab * vf)
    hist[1].index_add_(0, bins, (1.0 - lab) * vf)
    if reduce is not None:
        hist = reduce(hist)
    hist_pos, hist_neg = hist[0], hist[1]
    neg_below = torch.cumsum(hist_neg, 0) - hist_neg
    pos, neg = hist_pos.sum(), hist_neg.sum()
    r = torch.sum(hist_pos * (neg_below + 0.5 * hist_neg))
    auc = r / torch.clamp(pos * neg, min=1.0)
    return torch.where((pos > 0) & (neg > 0), auc, 0.5)


def auc_score_auto(preds, labels, valid=None, exact_max: int = AUC_EXACT_MAX) -> torch.Tensor:
    """The exact AUC up to `exact_max` samples, the binned one beyond
    (metrics.py:165)."""
    return (auc_score if preds.numel() <= exact_max else auc_score_large)(preds, labels, valid)


def ndcg_score(preds, labels, valid=None) -> torch.Tensor:
    """NDCG over the whole buffer (metrics.py:64): DCG of the labels in
    descending prediction order over the ideal DCG."""
    p, lab, v = _flat(preds, labels, valid)
    p = torch.where(v, p, -torch.inf)
    lab = torch.where(v, lab, 0.0)
    order = torch.sort(-p, stable=True).indices
    disc = 1.0 / torch.log2(torch.arange(p.numel(), dtype=torch.float32, device=p.device) + 2.0)
    dcg = torch.sum(lab[order] * disc)
    ideal = torch.sum(torch.sort(lab, descending=True).values * disc)
    return torch.where(ideal > 0, dcg / torch.clamp(ideal, min=1e-12), 0.0)


def hitrate_score(preds, labels, valid=None) -> torch.Tensor:
    """Share of predictions > 0.8 whose label is 1 (metrics.py:86)."""
    p, lab, v = _flat(preds, labels, valid)
    checked = (p > 0.8) & v
    c = checked.float().sum()
    hits = (checked & (lab == 1.0)).float().sum()
    return torch.where(c > 0, hits / torch.clamp(c, min=1.0), 0.0)


def smape_score(preds, labels, valid=None) -> torch.Tensor:
    """Symmetric mean absolute percentage error (metrics.py:103)."""
    p, lab, v = _flat(preds, labels, valid)
    avg = (p + lab) * 0.5
    err = torch.where(v, (p - lab).abs() / torch.where(avg == 0, 1.0, avg), 0.0)
    return err.sum() / torch.clamp(v.float().sum(), min=1.0)


_FINALIZERS = {
    Metric_t.NDCG: ndcg_score,
    Metric_t.HitRate: hitrate_score,
    Metric_t.SMAPE: smape_score,
}


class MetricAccumulator:
    """Eval predictions and labels in [max_batches x batch_size x label_dim]
    device buffers, finalized on demand (metrics.py:190). Over `world`
    ranks, `batch_size` is the rank's block of an eval batch, and the
    buffers are gathered and summed over `group` (the data axes)."""

    def __init__(
        self,
        metrics: Dict[Metric_t, float],
        batch_size: int,
        max_batches: int,
        device: torch.device,
        label_dim: int = 1,
        auc_exact_max: int = AUC_EXACT_MAX,
        world: int = 1,
        group=None,
    ):
        self.world = world
        self.group = group
        self.metrics = {Metric_t(k): v for k, v in metrics.items()}
        self.batch_size = batch_size
        self.max_batches = max_batches
        self.label_dim = max(1, int(label_dim))
        self.capacity = batch_size * self.label_dim * max_batches
        self.device = device
        self.auc_exact_max = auc_exact_max
        self._preds = torch.zeros(self.capacity, dtype=torch.float32, device=device)
        self._labels = torch.zeros(self.capacity, dtype=torch.float32, device=device)
        self._valid = torch.zeros(self.capacity, dtype=torch.bool, device=device)
        self.reset()

    def reset(self) -> None:
        self._valid.zero_()
        self._nb = 0
        self._loss_vals: List[torch.Tensor] = []  # device scalars: no sync per batch

    def update(self, preds: torch.Tensor, labels: torch.Tensor, loss=None) -> None:
        """One eval batch: a slice copy into each buffer."""
        if self._nb >= self.max_batches:
            return  # the buffers hold max_batches batches, as in the JAX package
        p, lab = preds.reshape(-1), labels.reshape(-1)
        off = self._nb * self.batch_size * self.label_dim
        self._preds[off : off + p.numel()].copy_(p)
        self._labels[off : off + lab.numel()].copy_(lab)
        self._valid[off : off + p.numel()] = True
        self._nb += 1
        if loss is not None:
            self._loss_vals.append(torch.as_tensor(loss, dtype=torch.float32, device=self.device))

    def _global(self, t: torch.Tensor) -> torch.Tensor:
        """A buffer of every rank, in the global eval batches' order: batch
        i's blocks of ranks 0..W-1, then batch i + 1's."""
        if self.world == 1:
            return t
        g = all_gather(t.to(torch.uint8) if t.dtype == torch.bool else t, self.group)
        g = g.reshape(self.world, self.max_batches, -1).transpose(0, 1).reshape(-1)
        return g.bool() if t.dtype == torch.bool else g

    def finalize(self) -> Dict[str, float]:
        """The metrics over the global eval set; over W ranks every rank
        calls this together (collectives)."""
        out: Dict[str, float] = {}
        buffers = None
        for m in self.metrics:
            if m == Metric_t.AverageLoss:
                if self._loss_vals:
                    losses = all_reduce(torch.stack([v.reshape(()) for v in self._loss_vals]), self.group)
                    out[m.value] = float(losses.mean() / self.world)
                else:
                    out[m.value] = 0.0
                continue
            if m == Metric_t.AUC and self.capacity * self.world > self.auc_exact_max:
                out[m.value] = float(auc_score_large(self._preds, self._labels, self._valid,
                                                     functools.partial(all_reduce, group=self.group)))
                continue
            if buffers is None:
                buffers = [self._global(t) for t in (self._preds, self._labels, self._valid)]
            fn = auc_score if m == Metric_t.AUC else _FINALIZERS[m]
            out[m.value] = float(fn(*buffers))
        return out

    def check_earlystop(self, values: Dict[str, float]) -> bool:
        """True when AUC, HitRate or NDCG passes a threshold below 1
        (metrics.py:307)."""
        return any(
            m in (Metric_t.AUC, Metric_t.HitRate, Metric_t.NDCG) and thr < 1.0
            and values.get(m.value, 0.0) > thr
            for m, thr in self.metrics.items()
        )
