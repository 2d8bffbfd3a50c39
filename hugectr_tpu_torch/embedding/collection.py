"""Embedding collection on one device (counterpart of
hugectr_tpu/embedding/collection.py, single-device paths).

Each plan group owns one [R, E] storage tensor. Per group:

* "onehot" groups (small tables): the forward pools each lookup with the
  one-hot forward kernel (`_onehot_fwd`, collection.py:1311-1337); the
  backward builds the dense gradient and touch counts with the one-hot
  backward kernel (`_onehot_grad_pallas`, :1407-1435) and runs the dense
  optimizer sweep over touched rows (`_onehot_bwd_local`, :1437-1452);
* "rowop" groups: the forward gathers and pools (`_dp_fwd`, :1474-1485 and
  `_pool`, :596); the backward builds (row, grad-source) pairs
  (`_row_grads`, :1801, `_grad_source`, :616) and hands them to
  `sparse_optimizer.apply_sparse`, which takes the dense sweep or the sorted
  segscan route (`_bwd_single`, :1942).

The embedding backward is not autograd, as in the JAX package: the dense
network's gradient with respect to the embedding outputs is taken first and
`backward_and_update` applies the fused update, in place.

`route_counts` counts, per route ("onehot", "dense", "sorted"), the groups
updated since the collection was built; `group_routes` holds each group's
route in the last backward.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.mesh import ResourceManager
from ..core.types import Combiner_t, INVALID_KEY
from ..ops.onehot_matmul import onehot_matmul_bwd, onehot_matmul_fwd
from ..optim.params import OptParams
from ..parallel.plan import CompiledEmbeddingPlan, GroupPlan
from . import sparse_optimizer

Tables = Dict[str, torch.Tensor]


class _GroupMeta:
    """Device-side constants of one group."""

    def __init__(self, g: GroupPlan, device: torch.device):
        if g.num_shards != 1 or g.mesh_size != 1:
            raise NotImplementedError("multi-GPU groups are not ported yet (ROADMAP Queue 1)")
        self.plan = g
        self.slot_local_offset = torch.as_tensor(g.slot_local_offset, dtype=torch.int64, device=device)
        self.slot_vocab = torch.as_tensor(g.slot_vocab, dtype=torch.int64, device=device)
        self.gsrc = torch.as_tensor(_fwd_gsrc(g), dtype=torch.int64, device=device)


def _fwd_gsrc(g: GroupPlan) -> np.ndarray:
    """Per-slot gradient-source slot (collection.py:1197): one per sum/mean
    lookup, one per slot of a concat lookup."""
    gsrc = np.zeros(g.hotness_total, dtype=np.int64)
    cursor = 0
    for lm in g.lookups:
        h = lm.slot_end - lm.slot_begin
        if lm.combiner == Combiner_t.Concat:
            gsrc[lm.slot_begin : lm.slot_end] = cursor + np.arange(h)
            cursor += h
        else:
            gsrc[lm.slot_begin : lm.slot_end] = cursor
            cursor += 1
    return gsrc


class EmbeddingCollection:
    """Owns the compiled plan and runs the forward and the fused update."""

    def __init__(
        self,
        plan: CompiledEmbeddingPlan,
        rm: ResourceManager,
        opt: OptParams,
        dtype=torch.float32,
        dense_update_rows: int = 262144,
        dense_key_ratio: float = 0.3,
    ):
        if dtype != torch.float32:
            raise NotImplementedError("bf16 tables are not ported yet (ROADMAP Queue 1 item 2)")
        self.plan = plan
        self.rm = rm
        self.device = rm.device
        self.opt = opt
        self.dtype = dtype
        self.state_dtype = torch.float32
        self.dense_update_rows = dense_update_rows
        self.dense_key_ratio = dense_key_ratio
        self._meta = {g.name: _GroupMeta(g, self.device) for g in plan.groups}
        self.group_opt: Dict[str, OptParams] = {}
        for g in plan.groups:
            opts = {id(t.opt_params): t.opt_params for t in g.tables if t.opt_params}
            if len(opts) > 1:
                raise ValueError(
                    f"group {g.name}: tables with different opt_params must not share a group"
                )
            self.group_opt[g.name] = next(iter(opts.values())) if opts else opt
        self.route_counts: Dict[str, int] = collections.Counter()
        self.group_routes: Dict[str, str] = {}

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> Tables:
        """Uniform(-1, 1) rows scaled per table (default 1/sqrt(ev)), as the
        JAX package draws them (collection.py:289); distributions match,
        bits do not."""
        tables = {}
        for g in self.plan.groups:
            t = torch.empty((g.total_storage_rows, g.ev_size), dtype=self.dtype, device=self.device)
            t.uniform_(-1.0, 1.0, generator=generator)
            scales = torch.as_tensor(self._row_init_scales(g), device=self.device)
            tables[g.name] = t.mul_(scales.unsqueeze(1).to(self.dtype))
        return tables

    def _row_init_scales(self, g: GroupPlan) -> np.ndarray:
        """Per-row init scale (collection.py:344)."""
        scales = np.zeros(g.total_storage_rows, dtype=np.float32)
        for ti, t in enumerate(g.tables):
            s = t.init_scale if t.init_scale is not None else 1.0 / np.sqrt(t.ev_size)
            off = int(g.local_offsets[ti])
            scales[off : off + int(g.rows_per_shard[ti])] = s
        return scales

    def init_optimizer(self, tables: Tables) -> Dict[str, Dict[str, torch.Tensor]]:
        return {
            g.name: sparse_optimizer.init_state(
                self.group_opt[g.name], g.total_storage_rows, g.ev_size,
                self.state_dtype, self.device,
            )
            for g in self.plan.groups
        }

    # ------------------------------------------------------------- helpers
    def _group_keys(self, g: GroupPlan, feature_keys: Dict[str, torch.Tensor]) -> torch.Tensor:
        cols = []
        for lm in g.lookups:
            k = feature_keys[lm.bottom_name]
            if k.dim() == 1:
                k = k.unsqueeze(1)
            if k.shape[1] != lm.hotness:
                raise ValueError(
                    f"feature {lm.bottom_name}: hotness {k.shape[1]} != lookup max_hotness {lm.hotness}"
                )
            cols.append(k)
        return torch.cat(cols, dim=1).long()

    def _slot_placement(self, gname: str, keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(valid, local storage row) of [B, H] keys (collection.py:427);
        out-of-range static keys wrap, as there."""
        meta = self._meta[gname]
        valid = keys != INVALID_KEY
        k = torch.where(valid, keys % meta.slot_vocab.unsqueeze(0), 0)
        return valid, k + meta.slot_local_offset.unsqueeze(0)

    @staticmethod
    def _count(valid: torch.Tensor, dtype) -> torch.Tensor:
        return torch.clamp(valid.to(dtype).sum(dim=1, keepdim=True), min=1.0)

    # ------------------------------------------------------------- forward
    def forward(self, tables: Tables, feature_keys: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """{bottom_name: [B, hotness] keys} -> {top_name: [B, out_width]}
        (collection.py:647)."""
        outs: Dict[str, torch.Tensor] = {}
        for g in self.plan.groups:
            keys = self._group_keys(g, feature_keys)
            if g.compute_kind == "onehot":
                go = self._onehot_fwd(g.name, tables[g.name], keys)
            else:
                go = self._dp_fwd(g.name, tables[g.name], keys)
            for lm in g.lookups:
                outs[lm.top_name] = go[:, lm.out_begin : lm.out_end]
        return outs

    def _onehot_local_keys(self, g: GroupPlan, lm, valid, local_row) -> torch.Tensor:
        """Table-local int32 rows of one lookup, -1 for padding
        (collection.py:1303)."""
        off = int(g.local_offsets[lm.table_index])
        k = local_row[:, lm.slot_begin : lm.slot_end] - off
        return torch.where(valid[:, lm.slot_begin : lm.slot_end], k, -1).to(torch.int32).contiguous()

    def _onehot_fwd(self, gname: str, table: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        g = self._meta[gname].plan
        valid, local_row = self._slot_placement(gname, keys)
        outs: List[torch.Tensor] = []
        for lm in g.lookups:
            off = int(g.local_offsets[lm.table_index])
            v = int(g.table_vocab[lm.table_index])
            k_rel = self._onehot_local_keys(g, lm, valid, local_row)
            o = onehot_matmul_fwd(k_rel, table[off : off + v])
            if lm.combiner == Combiner_t.Mean:
                o = o / self._count(valid[:, lm.slot_begin : lm.slot_end], o.dtype)
            outs.append(o)
        return torch.cat(outs, dim=1)

    def _dp_fwd(self, gname: str, table: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        """Masked gather + per-lookup pooling (collection.py:1474-1485, :596);
        each lookup gathers its own slots, so no [B, H, E] temp of the whole
        group is built."""
        g = self._meta[gname].plan
        valid, local_row = self._slot_placement(gname, keys)
        safe = torch.where(valid, local_row, 0)
        b = keys.shape[0]
        outs: List[torch.Tensor] = []
        for lm in g.lookups:
            sl = slice(lm.slot_begin, lm.slot_end)
            rows = table[safe[:, sl]] * valid[:, sl].unsqueeze(-1).to(table.dtype)
            if lm.combiner == Combiner_t.Concat:
                outs.append(rows.reshape(b, -1))
                continue
            s = rows.sum(dim=1)
            if lm.combiner == Combiner_t.Mean:
                s = s / self._count(valid[:, sl], s.dtype)
            outs.append(s)
        return torch.cat(outs, dim=1)

    # ------------------------------------------------- backward + update
    def backward_and_update(
        self,
        tables: Tables,
        opt_state: Dict[str, Dict[str, torch.Tensor]],
        feature_keys: Dict[str, torch.Tensor],
        d_outs: Dict[str, torch.Tensor],
        lr: torch.Tensor,
        step: int = 0,
    ) -> Tuple[Tables, Dict[str, Dict[str, torch.Tensor]]]:
        """Fused embedding backward + sparse optimizer update, in place
        (collection.py:1567). d_outs: {top_name: [B, out_width]} cotangents
        from the dense network. Returns the (updated) inputs."""
        lr = torch.as_tensor(lr, dtype=self.dtype, device=self.device)
        for g in self.plan.groups:
            keys = self._group_keys(g, feature_keys)
            d_group = torch.cat([d_outs[lm.top_name].to(self.dtype) for lm in g.lookups], dim=1)
            opt = self.group_opt[g.name]
            if g.compute_kind == "onehot":
                grad, colsum = self._onehot_grad(g.name, tables[g.name].dtype, keys, d_group)
                sparse_optimizer.apply_dense(
                    opt, tables[g.name], opt_state[g.name], grad, colsum > 0, lr
                )
                route = "onehot"
            else:
                idx, src, dsrc = self._row_grads(g.name, keys, d_group)
                route = sparse_optimizer.apply_sparse(
                    opt, tables[g.name], opt_state[g.name], idx, src, dsrc, lr,
                    dense_rows=self.dense_update_rows, dense_ratio=self.dense_key_ratio,
                )
            self.route_counts[route] += 1
            self.group_routes[g.name] = route
        return tables, opt_state

    def _onehot_grad(
        self, gname: str, table_dtype, keys: torch.Tensor, d_group: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense [R, E] gradient + [R] touch counts (collection.py:1407).
        Each table's kernel adds into its rows of the group's float32
        buffers, which are zeroed once per group."""
        g = self._meta[gname].plan
        valid, local_row = self._slot_placement(gname, keys)
        grad = torch.zeros((g.total_local_rows, g.ev_size), dtype=torch.float32, device=self.device)
        colsum = torch.zeros((g.total_local_rows,), dtype=torch.float32, device=self.device)
        for lm in g.lookups:
            off = int(g.local_offsets[lm.table_index])
            v = int(g.table_vocab[lm.table_index])
            k_rel = self._onehot_local_keys(g, lm, valid, local_row)
            d = d_group[:, lm.out_begin : lm.out_end].to(table_dtype)
            if lm.combiner == Combiner_t.Mean:
                d = d / self._count(valid[:, lm.slot_begin : lm.slot_end], d.dtype)
            onehot_matmul_bwd(
                k_rel, d.contiguous(), v, torch.float32,
                out=grad[off : off + v], cnt_out=colsum[off : off + v],
            )
        return grad.to(table_dtype), colsum

    def _grad_source(self, g: GroupPlan, d_out: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """[B, W] output grads -> compact gradient source [B*S, E]: one row
        per sample for each sum/mean lookup (collection.py:616)."""
        b = d_out.shape[0]
        parts = []
        for lm in g.lookups:
            d = d_out[:, lm.out_begin : lm.out_end]
            h = lm.slot_end - lm.slot_begin
            if lm.combiner == Combiner_t.Concat:
                parts.append(d.reshape(b, h, g.ev_size))
                continue
            d = d.reshape(b, 1, g.ev_size)
            if lm.combiner == Combiner_t.Mean:
                d = d / self._count(valid[:, lm.slot_begin : lm.slot_end], d.dtype).unsqueeze(-1)
            parts.append(d)
        return torch.cat(parts, dim=1).reshape(-1, g.ev_size)

    def _row_grads(
        self, gname: str, keys: torch.Tensor, d_group: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(flat row ids with sentinel R, grad-source rows, compact grad
        source) (collection.py:1801)."""
        meta = self._meta[gname]
        g = meta.plan
        valid, local_row = self._slot_placement(gname, keys)
        dsrc = self._grad_source(g, d_group, valid)
        b = keys.shape[0]
        idx = torch.where(valid, local_row, g.total_local_rows).reshape(-1)
        src = (
            torch.arange(b, device=self.device).unsqueeze(1) * g.grad_src_slots
            + meta.gsrc.unsqueeze(0)
        ).reshape(-1)
        return idx, src, dsrc

    # ------------------------------------------------------------- IO
    def _find_table(self, name: str) -> Tuple[GroupPlan, int]:
        for g in self.plan.groups:
            for ti, t in enumerate(g.tables):
                if t.name == name:
                    return g, ti
        raise KeyError(name)

    def export_table(self, tables: Tables, table_name: str) -> np.ndarray:
        """One table as a [vocab, ev] host array (collection.py:2101)."""
        g, ti = self._find_table(table_name)
        off, vocab = int(g.local_offsets[ti]), int(g.table_vocab[ti])
        return tables[g.name][off : off + vocab].detach().cpu().numpy()

    def import_table(self, tables: Tables, table_name: str, values: np.ndarray) -> Tables:
        """Write one table from a [vocab, ev] array (collection.py:2124)."""
        g, ti = self._find_table(table_name)
        off, vocab = int(g.local_offsets[ti]), int(g.table_vocab[ti])
        if values.shape != (vocab, g.ev_size):
            raise ValueError(
                f"table {table_name}: expected {(vocab, g.ev_size)}, got {values.shape}"
            )
        with torch.no_grad():
            tables[g.name][off : off + vocab].copy_(torch.as_tensor(np.asarray(values)))
        return tables
