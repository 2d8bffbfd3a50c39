"""Embedding collection on one device (counterpart of
hugectr_tpu/embedding/collection.py, single-device paths).

Each plan group owns one [R, E] storage tensor. Per group:

* "onehot" groups (small tables): the forward pools every lookup of the
  group in one launch of the one-hot forward kernel, placement included
  (`_onehot_fwd`, collection.py:1311-1337); the
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

Split tables (the plan's hot/cold tiers): each tier lookup reads the raw
keys through its window [key_lo, key_hi) (`_group_keys`, collection.py:741;
in the one-hot kernel for the superhot tier), the forward sums the tiers'
outputs into the user's top and a Mean merge divides by the count of the
raw valid keys (`_merge_outputs`, :768); the backward hands the user's
cotangent to every tier (`_expand_d_outs`, :788). Each tier group sorts its
own keys: the JAX package's shared sort of a split table's raw keys
(`_tier_sorted_rows`, :1758) lets XLA merge identical sorts and gives the
same rows.

Tables are float32 or bfloat16 and the optimizer state float32 or bfloat16
(`state_dtype`, collection.py:130); the optimizers compute in float32 and
round once to each array's type.

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
from ..core.types import INVALID_KEY, Combiner_t
from ..ops.onehot_matmul import (
    GroupLookup,
    onehot_fwd_group,
    onehot_matmul_bwd,
    place_keys,
    window_keys,
)
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
        self.fwd_lookups = onehot_fwd_lookups(g)


def onehot_fwd_lookups(g: GroupPlan) -> List[GroupLookup]:
    """Descriptors of a one-hot group's forward, one per lookup (the split
    shifts a window by its key_lo)."""
    return [
        GroupLookup(
            int(g.local_offsets[lm.table_index]), int(g.table_vocab[lm.table_index]),
            lm.out_begin, lm.combiner == Combiner_t.Mean, lm.key_lo, lm.key_hi,
        )
        for lm in g.lookups
    ]


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
        state_dtype=torch.float32,
    ):
        for what, dt in (("tables", dtype), ("optimizer state", state_dtype)):
            if dt not in (torch.float32, torch.bfloat16):
                raise ValueError(f"{what} must be float32 or bfloat16, got {dt}")
        self.plan = plan
        self.rm = rm
        self.device = rm.device
        self.opt = opt
        self.dtype = dtype
        self.state_dtype = state_dtype
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
    @staticmethod
    def _lookup_keys(g: GroupPlan, feature_keys: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """Each lookup's [B, hotness] keys, as given (views, any int type)."""
        out = []
        for lm in g.lookups:
            k = feature_keys[lm.bottom_name]
            if k.dim() == 1:
                k = k.unsqueeze(1)
            if k.shape[1] != lm.hotness:
                raise ValueError(
                    f"feature {lm.bottom_name}: hotness {k.shape[1]} != lookup max_hotness {lm.hotness}"
                )
            out.append(k)
        return out

    def _group_keys(self, g: GroupPlan, feature_keys: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[B, H] int32 keys of the group, each lookup's through its window
        (collection.py:730-747)."""
        return torch.cat(
            [window_keys(k, lm.key_lo, lm.key_hi)
             for k, lm in zip(self._lookup_keys(g, feature_keys), g.lookups)],
            dim=1,
        )

    def _slot_placement(self, gname: str, keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(valid, local storage row) of [B, H] keys (collection.py:427):
        keys are cut to int32 first, as there (`keys.astype(jnp.int32)`,
        JAX without x64), then -1 is padding and other keys wrap by floor
        modulo."""
        meta = self._meta[gname]
        valid, k = place_keys(keys, meta.slot_vocab.unsqueeze(0))
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
            if g.compute_kind == "onehot":
                go = self._onehot_fwd(g.name, tables[g.name], self._lookup_keys(g, feature_keys))
            else:
                go = self._dp_fwd(g.name, tables[g.name], self._group_keys(g, feature_keys))
            for lm in g.lookups:
                outs[lm.top_name] = go[:, lm.out_begin : lm.out_end]
        return self._merge_outputs(outs, feature_keys)

    def _merge_denom(self, m, feature_keys: Dict[str, torch.Tensor], dtype) -> torch.Tensor:
        """[B, 1] count of a split lookup's raw valid keys, at least 1
        (collection.py:749)."""
        k = feature_keys[m.bottom_name]
        if k.dim() == 1:
            k = k.unsqueeze(1)
        return self._count(k.to(torch.int32) != INVALID_KEY, dtype)

    def _merge_outputs(self, outs, feature_keys) -> Dict[str, torch.Tensor]:
        """Each split lookup's top is the sum of its tiers' tops; Mean
        divides by the raw valid count (collection.py:768)."""
        for m in self.plan.merges:
            o = outs.pop(m.sub_tops[0])
            for sub in m.sub_tops[1:]:
                o = o + outs.pop(sub)
            if m.combiner == Combiner_t.Mean:
                o = o / self._merge_denom(m, feature_keys, o.dtype)
            outs[m.top_name] = o
        return outs

    def _expand_d_outs(self, d_outs, feature_keys) -> Dict[str, torch.Tensor]:
        """The user top's cotangent to each tier's top; Mean divides it by
        the raw valid count (collection.py:788)."""
        if not self.plan.merges:
            return d_outs
        d_outs = dict(d_outs)
        for m in self.plan.merges:
            d = d_outs.pop(m.top_name)
            if m.combiner == Combiner_t.Mean:
                d = d / self._merge_denom(m, feature_keys, d.dtype)
            for sub in m.sub_tops:
                d_outs[sub] = d
        return d_outs

    def _onehot_local_keys(self, g: GroupPlan, lm, valid, local_row) -> torch.Tensor:
        """Table-local int32 rows of one lookup, -1 for padding
        (collection.py:1303)."""
        off = int(g.local_offsets[lm.table_index])
        k = local_row[:, lm.slot_begin : lm.slot_end] - off
        return torch.where(valid[:, lm.slot_begin : lm.slot_end], k, -1).to(torch.int32).contiguous()

    def _onehot_fwd(self, gname: str, table: torch.Tensor, keys: List[torch.Tensor]) -> torch.Tensor:
        """Every lookup of the group in one call on the raw feature keys
        (collection.py:1311-1337): the kernel does the placement, the Mean
        division and writes each lookup into its output columns."""
        g = self._meta[gname].plan
        return onehot_fwd_group(keys, self._meta[gname].fwd_lookups, table, g.out_width)

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
        d_outs = self._expand_d_outs(d_outs, feature_keys)
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
                # the key-ratio rule counts valid keys; a tier's key list is
                # mostly padding, and without a measured count the JAX
                # package turns the rule off for it (collection.py:1970)
                windowed = any(lm.windowed for lm in g.lookups)
                route = sparse_optimizer.apply_sparse(
                    opt, tables[g.name], opt_state[g.name], idx, src, dsrc, lr,
                    dense_rows=self.dense_update_rows,
                    dense_ratio=0.0 if windowed else self.dense_key_ratio,
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
        """One table as a [vocab, ev] host array, a split table put back
        together from its tiers (collection.py:2101); float32 for bfloat16
        tables (numpy has no bfloat16)."""
        if table_name in self.plan.table_splits:
            return np.concatenate(
                [self.export_table(tables, sub) for sub, _off in self.plan.table_splits[table_name]]
            )
        g, ti = self._find_table(table_name)
        off, vocab = int(g.local_offsets[ti]), int(g.table_vocab[ti])
        return tables[g.name][off : off + vocab].detach().float().cpu().numpy()

    def import_table(self, tables: Tables, table_name: str, values: np.ndarray) -> Tables:
        """Write one table from a [vocab, ev] array, a split table's rows
        into its tiers (collection.py:2124)."""
        if table_name in self.plan.table_splits:
            subs = self.plan.table_splits[table_name]
            for i, (sub, off) in enumerate(subs):
                end = subs[i + 1][1] if i + 1 < len(subs) else values.shape[0]
                self.import_table(tables, sub, values[off:end])
            return tables
        g, ti = self._find_table(table_name)
        off, vocab = int(g.local_offsets[ti]), int(g.table_vocab[ti])
        if values.shape != (vocab, g.ev_size):
            raise ValueError(
                f"table {table_name}: expected {(vocab, g.ev_size)}, got {values.shape}"
            )
        with torch.no_grad():
            tables[g.name][off : off + vocab].copy_(torch.as_tensor(np.asarray(values, np.float32)))
        return tables
