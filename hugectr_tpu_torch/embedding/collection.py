"""Embedding collection on one device or over W ranks (counterpart of
hugectr_tpu/embedding/collection.py).

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

Dynamic tables (`max_vocabulary_size` -1, collection.py:465-535): each
rowop group holding one keeps an exact key store `"{group}#keys"` in the
tables dict, int32 [R] and row-aligned with the storage, EMPTY (2^31 - 1)
where no key lives. A key probes NUM_PROBES consecutive rows of its table
from the murmur3 finalizer's hash; the forward reads a key that was not
found as padding, and the backward first inserts the batch's unplaced keys
(scatter-min arbitration per probe round), then updates their rows. Keys
still unplaced after NUM_PROBES rounds are dropped for the step. Eviction,
capacity growth and key-store export are not ported (ROADMAP Queue 1).

Over W ranks (`rm.data_parallel_size` > 1, one process per device), each
rank holds the batch's block of B/W samples (hybrid parallelism,
collection.py:668-721, :1567-1726):

* one-hot groups are replicated: the forward kernel runs on the rank's
  rows; the backward kernels write the group's float32 gradient and touch
  counts from the rank's rows, the gradient is rounded once to the table's
  type and one `all_reduce` of each gives every rank the same update
  (`_onehot_bwd_local`, :1437);
* model-parallel rowop groups are row-sharded over the group's f shards
  (f = W, or fewer for a partial placement, `shard_matrix`): key k of a
  static table on shard (k' + rot) % f at local row k' // f (k' = k %
  vocab, `_slot_placement`, :427), a dynamic key on shard h % f of its
  hash h, probing from row (h // f) % rows of that shard's key store
  (`_dynamic_probe`, :468-495). Rank r holds shard r % f, so each shard has
  W / f replicas, drawn from one stream and kept equal. The forward
  all-gathers the keys, pools the rows of this rank's shard with the masked
  gather of `_dp_fwd` (other shards' keys read as padding; a replica
  serves only its block r // f of the gathered batch, so the ranks'
  contributions are disjoint) and reduce-scatters the pools over the batch
  (`_mp_fwd_local`, :808-865; the owner-partitioned gather of the sorted
  owned prefix, `_mp_fwd_partitioned`, :867-936, the JAX package's default
  at W > 1, is not ported: ROADMAP Queue 1 item 1f2); the backward
  all-gathers the keys and the cotangents, inserts a dynamic group's new
  keys of this rank's shard, and every replica applies the whole update of
  its shard (`_mp_bwd_local`, :1844-1894), whose key-ratio rule asks f x the
  keys (`_opt_knobs`, :1976);
* data-parallel rowop groups are replicated: the forward is local, the
  backward all-gathers keys and cotangents and every rank applies the
  update (`_dp_bwd_local`, :1896).

On the card `index_add_` sums with atomics, in an order that differs from
rank to rank: after an update on the dense sweep or the scatter route
(`sparse_optimizer.ATOMIC_ROUTES`) a group held by several ranks takes the
table and state of the lowest of them by a `broadcast` in its replica
group (`core/mesh.py::replica_group`), so replicas stay bitwise equal. The
sorted route is deterministic and needs none.

The dtype each collective carries: the forward's all_gather of keys int32,
its reduce_scatter of pools the table's type (float32 sums rounded once);
the backward's all_gather of keys int32 and of cotangents the table's type
(the JAX package's `d_outs.astype(self.dtype)`); the one-hot all_reduce of
the gradient the table's type and of the touch counts float32; the replica
broadcasts each array's own type (tables, float32 or bfloat16 state).
`Model` adds one float32 all_reduce of the dense gradients and the loss.

The collectives are `core/mesh.py`'s. `export_table` and `import_table`
read and write a table (or any per-row array laid out as the storage, such
as a state) in key order whatever W and f are (collectives on every rank).
Not ported over W > 1 ranks (ROADMAP Queue 1 item 1): hierarchical
communication (1g), which raises, and the unique-key dense exchange (1f):
the JAX package takes it only for all-Concat groups with caps measured and
set in HCTR_TPU_DENSE_EXCHANGE_CAP (`_dense_exchange_ok`, :953), and the
port has no such setting yet, so every group takes the exact path above.

`route_counts` counts, per route ("onehot", "dense", "sorted", "scatter"),
the groups updated since the collection was built; `group_routes` holds
each group's route in the last backward.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.mesh import ResourceManager, all_gather, all_reduce, broadcast, reduce_scatter, replica_group
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

NUM_PROBES = 8  # probe depth of the dynamic key store (collection.py:465)
EMPTY_KEY = 2**31 - 1  # a free row of the key store (collection.py:466)
_U32 = 0xFFFFFFFF


def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """h * c mod 2^32 for h in [0, 2^32) held in int64, without overflow:
    c is split into 16-bit halves so every product stays below 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _U32


def hash_mix(k: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer of int32 keys as uint32 values, held in int64
    (collection.py:53 `_hash_mix`; torch has few uint32 ops on the card)."""
    h = k.to(torch.int64) & _U32
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul_u32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def fold_reserved_key(k32: torch.Tensor) -> torch.Tensor:
    """The int32 key 2^31 - 1 is the store's EMPTY marker: it behaves as
    2^31 - 2 (collection.py:76)."""
    return torch.where(k32 == EMPTY_KEY, EMPTY_KEY - 1, k32)


class _GroupMeta:
    """Device-side constants of one group, and this rank's place in it: a
    model-parallel group over f shards puts shard r % f on rank r, so W / f
    ranks (its replicas) hold each shard."""

    def __init__(self, g: GroupPlan, device: torch.device, rank: int):
        self.plan = g
        self.num_shards = g.num_shards if g.is_model_parallel else 1
        self.shard = rank % self.num_shards
        self.slot_rotation = torch.as_tensor(
            g.slot_rotation % self.num_shards, dtype=torch.int64, device=device
        )
        self.slot_local_offset = torch.as_tensor(g.slot_local_offset, dtype=torch.int64, device=device)
        self.slot_vocab = torch.as_tensor(g.slot_vocab, dtype=torch.int64, device=device)
        self.slot_rows = torch.as_tensor(g.rows_per_shard[g.slot_table], dtype=torch.int64, device=device)
        self.slot_dynamic = torch.as_tensor(g.slot_is_dynamic, device=device)
        self.any_dynamic = bool(g.slot_is_dynamic.any())
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
        self.world = rm.data_parallel_size
        self.rank = rm.rank
        self.opt = opt
        self.dtype = dtype
        self.state_dtype = state_dtype
        self.dense_update_rows = dense_update_rows
        self.dense_key_ratio = dense_key_ratio
        self._meta = {g.name: _GroupMeta(g, self.device, self.rank) for g in plan.groups}
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
        bits do not. Over W ranks a model-parallel group's storage is the
        rank's shard ([total_local_rows, E]), drawn from a stream of that
        shard's own, so every replica of a shard holds the same rows (JAX
        tiles the f shards' base rows over the replicas, :305-318);
        replicated groups come from `generator`, alike on every rank. A
        group with dynamic tables also gets its empty key store
        `"{group}#keys"` (collection.py:329-341)."""
        seed = None
        if self.world > 1:
            seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))
        tables = {}
        for gi, g in enumerate(self.plan.groups):
            gen = generator
            if seed is not None and g.is_model_parallel:
                shard_seed = seed + gi * self.world + self._meta[g.name].shard
                gen = torch.Generator(device=self.device).manual_seed(shard_seed)
            t = torch.empty((g.total_local_rows, g.ev_size), dtype=self.dtype, device=self.device)
            t.uniform_(-1.0, 1.0, generator=gen)
            scales = torch.as_tensor(self._row_init_scales(g), device=self.device)
            tables[g.name] = t.mul_(scales.unsqueeze(1).to(self.dtype))
            if self._meta[g.name].any_dynamic:
                tables[f"{g.name}#keys"] = torch.full(
                    (g.total_local_rows,), EMPTY_KEY, dtype=torch.int32, device=self.device
                )
        return tables

    def _row_init_scales(self, g: GroupPlan) -> np.ndarray:
        """Per-row init scale of the rank's storage (collection.py:344)."""
        scales = np.zeros(g.total_local_rows, dtype=np.float32)
        for ti, t in enumerate(g.tables):
            s = t.init_scale if t.init_scale is not None else 1.0 / np.sqrt(t.ev_size)
            off = int(g.local_offsets[ti])
            scales[off : off + int(g.rows_per_shard[ti])] = s
        return scales

    def init_optimizer(self, tables: Tables) -> Dict[str, Dict[str, torch.Tensor]]:
        return {
            g.name: sparse_optimizer.init_state(
                self.group_opt[g.name], g.total_local_rows, g.ev_size,
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

    def _slot_placement(
        self, gname: str, keys: torch.Tensor, key_store=None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        """(valid, owner shard, local storage row) of [B, H] keys
        (collection.py:427): keys are cut to int32 first, as there
        (`keys.astype(jnp.int32)`, JAX without x64), then -1 is padding and
        other keys wrap by floor modulo into k'. Over f shards (a
        model-parallel group) k' lives on shard (k' + rot) % f at row
        k' // f; on one shard every key is local and the owner is None. A
        dynamic slot's key lives on shard h % f of its hash h and takes the
        row where that shard's store holds it; it is padding where the
        store (this rank's shard of it) holds it nowhere (:441-454)."""
        meta = self._meta[gname]
        valid, k = place_keys(keys, meta.slot_vocab.unsqueeze(0))
        f = meta.num_shards
        owner = None
        if f > 1:
            owner = torch.remainder(k + meta.slot_rotation.unsqueeze(0), f)
            k = torch.div(k, f, rounding_mode="floor")
        if meta.any_dynamic:
            dyn = meta.slot_dynamic.unsqueeze(0)
            owner_d, row, found = self._dynamic_probe(meta, keys, key_store)
            k = torch.where(dyn, row, k)
            if owner is not None:
                owner = torch.where(dyn, owner_d, owner)
            valid = valid & (~dyn | found)
        return valid, owner, k + meta.slot_local_offset.unsqueeze(0)

    # ----------------------------------------------- exact dynamic tables
    @staticmethod
    def _probe_base(meta: _GroupMeta, keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(int32 key as stored, owner shard, first probed table row) of
        [B, H] keys: over f shards the hash h gives shard h % f and row
        (h // f) % rows (collection.py:481-483)."""
        k32 = fold_reserved_key(keys.to(torch.int32))
        h = hash_mix(k32)
        f = meta.num_shards
        return k32, h % f, torch.div(h, f, rounding_mode="floor") % meta.slot_rows.unsqueeze(0)

    def _dynamic_probe(
        self, meta: _GroupMeta, keys: torch.Tensor, key_store: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(owner shard, table row, found) of [B, H] keys: the first of
        NUM_PROBES consecutive rows (mod the table's rows) of this rank's
        store whose stored key equals the key (collection.py:468-495). A
        key of another shard is never in this rank's store."""
        k32, owner, base = self._probe_base(meta, keys)
        rows_t = meta.slot_rows.unsqueeze(0)
        off = meta.slot_local_offset.unsqueeze(0)
        row = base
        found = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
        for j in range(NUM_PROBES):
            cand = (base + j) % rows_t
            hit = ~found & (key_store[cand + off] == k32)
            row = torch.where(hit, cand, row)
            found = found | hit
        return owner, row, found

    def _dynamic_insert(self, meta: _GroupMeta, key_store: torch.Tensor, keys: torch.Tensor) -> None:
        """Claim store rows for the batch's valid dynamic keys of this
        rank's shard that are not in the store yet, in place
        (collection.py:497-535): a full probe first, then per probe round
        each unplaced key writes itself into its candidate row if that row
        was empty, with `amin` arbitration (the smallest contending key
        wins, whatever the order), re-reads, and the losers probe on. The
        writes go to a copy one row longer whose last row takes the keys
        that write nowhere. The shard comes from the probe's hash of the
        reserved-key-folded key (:1862-1871), so insert and lookup agree,
        and every replica of a shard inserts the same keys."""
        k32, _owner, base = self._probe_base(meta, keys)
        rows_t = meta.slot_rows.unsqueeze(0)
        off = meta.slot_local_offset.unsqueeze(0)
        owner, _row, already = self._dynamic_probe(meta, keys, key_store)
        need = (keys.to(torch.int32) != INVALID_KEY) & meta.slot_dynamic.unsqueeze(0) & ~already
        if meta.num_shards > 1:
            need = need & (owner == meta.shard)
        sentinel = key_store.shape[0]
        ext = torch.cat([key_store, key_store.new_full((1,), EMPTY_KEY)])
        flat_keys = k32.reshape(-1)
        for j in range(NUM_PROBES):
            slot = (base + j) % rows_t + off
            stored = ext[slot]
            need = need & (stored != k32)  # already resident here
            tryslot = torch.where(need & (stored == EMPTY_KEY), slot, sentinel).reshape(-1)
            ext.scatter_reduce_(0, tryslot, flat_keys, "amin")
            need = need & (ext[slot] != k32)
        key_store.copy_(ext[:-1])

    def dynamic_stats(self, tables: Tables, feature_keys: Dict[str, torch.Tensor]) -> Dict[str, Tuple[int, int]]:
        """{group: (filled rows of this rank's store, distinct valid keys of
        this rank's shard in the batch that the store does not hold)} of
        every group with dynamic tables; `feature_keys` is the rank's block
        of a batch (all-gathered over W ranks: every rank calls this
        together). After a step on that batch, the second count is the keys
        the insert dropped (capacity pressure)."""
        out = {}
        for g in self.plan.groups:
            meta = self._meta[g.name]
            if not meta.any_dynamic:
                continue
            store = tables[f"{g.name}#keys"]
            keys = self._group_keys(g, feature_keys)
            if self.world > 1:
                keys = all_gather(keys)
            owner, _row, found = self._dynamic_probe(meta, keys, store)
            miss = (keys != INVALID_KEY) & meta.slot_dynamic.unsqueeze(0) & (owner == meta.shard) & ~found
            out[g.name] = (int((store != EMPTY_KEY).sum()), int(torch.unique(keys[miss]).numel()))
        return out

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
            elif g.is_model_parallel and self.world > 1:
                # the batch's keys; the rows of this rank's keys pooled with
                # float32 sums rounded once to the table's type; the pools
                # summed over the ranks in that type and scattered
                keys = all_gather(self._group_keys(g, feature_keys))
                go = reduce_scatter(self._dp_fwd(g.name, tables[g.name], keys, tables.get(f"{g.name}#keys")))
            else:
                go = self._dp_fwd(g.name, tables[g.name], self._group_keys(g, feature_keys),
                                  tables.get(f"{g.name}#keys"))
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

    def _dp_fwd(self, gname: str, table: torch.Tensor, keys: torch.Tensor, key_store=None) -> torch.Tensor:
        """Masked gather + per-lookup pooling (collection.py:1474-1485, :596);
        each lookup gathers its own slots, so no [B, H, E] temp of the whole
        group is built; sums in float32, rounded once to the table's type.
        Mean divides by the count of the raw valid keys, a dynamic key
        missing from the store included (:1484). Over W ranks (a
        model-parallel group's all-gathered keys, `_mp_fwd_local`,
        :808-865) the rank pools its shard's keys only, the others read as
        padding, and Mean still divides by every raw valid key; with
        replicas (f < W shards) the replica r // f of a shard serves only
        block r // f of the gathered batch, so the ranks' pools are
        disjoint and their sum is the batch's (:829-837)."""
        meta = self._meta[gname]
        g = meta.plan
        valid, owner, local_row = self._slot_placement(gname, keys, key_store)
        if self.world > 1 and g.is_model_parallel:
            if owner is not None:
                valid = valid & (owner == meta.shard)
            if g.num_replicas > 1:
                block = keys.shape[0] // g.num_replicas
                mine = torch.arange(keys.shape[0], device=keys.device) // block == self.rank // meta.num_shards
                valid = valid & mine.unsqueeze(1)
        raw_valid = keys != INVALID_KEY
        safe = torch.where(valid, local_row, 0)
        b = keys.shape[0]
        outs: List[torch.Tensor] = []
        for lm in g.lookups:
            sl = slice(lm.slot_begin, lm.slot_end)
            rows = table[safe[:, sl]] * valid[:, sl].unsqueeze(-1).to(table.dtype)
            if lm.combiner == Combiner_t.Concat:
                outs.append(rows.reshape(b, -1))
                continue
            s = rows.sum(dim=1, dtype=torch.float32).to(table.dtype)
            if lm.combiner == Combiner_t.Mean:
                s = s / self._count(raw_valid[:, sl], s.dtype)
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
        step: int = 1,
    ) -> Tuple[Tables, Dict[str, Dict[str, torch.Tensor]]]:
        """Fused embedding backward + sparse optimizer update, in place
        (collection.py:1567). d_outs: {top_name: [B, out_width]} cotangents
        from the dense network; `step` is the 1-based global step (Adam's
        bias corrections). A dynamic group inserts the batch's new keys into
        its key store before its rows are updated (`_bwd_single`, :1942).
        Over W ranks, `feature_keys` and `d_outs` are the rank's block of
        the batch, the cotangents of the global-batch loss; every rank
        calls this together (collectives). Returns the (updated) inputs."""
        lr = torch.as_tensor(lr, dtype=self.dtype, device=self.device)
        d_outs = self._expand_d_outs(d_outs, feature_keys)
        for g in self.plan.groups:
            keys = self._group_keys(g, feature_keys)
            d_group = torch.cat([d_outs[lm.top_name].to(self.dtype) for lm in g.lookups], dim=1)
            opt = self.group_opt[g.name]
            if g.compute_kind == "onehot":
                grad, colsum = self._onehot_grad(g.name, tables[g.name].dtype, keys, d_group)
                # the ranks' rows summed: the gradient rounded once to the
                # table's type, then one all_reduce of it in that type; the
                # touch counts in float32 (`_onehot_bwd_local`, :1437-1446)
                grad = all_reduce(grad.to(tables[g.name].dtype))
                all_reduce(colsum)
                # every row a valid key lands on is touched, for every
                # optimizer (`_onehot_bwd_local`, collection.py:1437-1452)
                sparse_optimizer.apply_dense(
                    opt, tables[g.name], opt_state[g.name], grad, colsum > 0, lr, step,
                )
                route = "onehot"
            else:
                if self.world > 1:
                    # model-parallel: the update of this rank's shard for the
                    # whole global batch (every replica of a shard the same,
                    # `_mp_bwd_local`, :1844-1894); data-parallel: every
                    # rank the same update (`_dp_bwd_local`, :1896)
                    keys, d_group = all_gather(keys), all_gather(d_group)
                key_store = tables.get(f"{g.name}#keys")
                if key_store is not None:
                    self._dynamic_insert(self._meta[g.name], key_store, keys)
                idx, src, dsrc = self._row_grads(g.name, keys, d_group, key_store)
                route = sparse_optimizer.apply_sparse(
                    opt, tables[g.name], opt_state[g.name], idx, src, dsrc, lr,
                    dense_rows=self.dense_update_rows, dense_ratio=self._dense_ratio(g), step=step,
                )
                if route in sparse_optimizer.ATOMIC_ROUTES and self._replicated(g):
                    # atomic sums differ in their last bits from rank to
                    # rank: the lowest replica's update is every replica's
                    src_rank, group = replica_group(self._meta[g.name].num_shards)
                    for t in (tables[g.name], *opt_state[g.name].values()):
                        broadcast(t, src_rank, group)
            self.route_counts[route] += 1
            self.group_routes[g.name] = route
        return tables, opt_state

    def _replicated(self, g: GroupPlan) -> bool:
        """Whether more than one rank holds the group's storage (or a shard
        of it): a data-parallel rowop group over W ranks, or a model-parallel
        group over fewer shards than ranks."""
        if self.world == 1 or g.compute_kind == "onehot":
            return False
        return not g.is_model_parallel or g.num_replicas > 1

    def _dense_ratio(self, g: GroupPlan) -> float:
        """The key-ratio rule's ratio for a rowop group (`_opt_knobs`,
        collection.py:1962-1980): off for a windowed group, whose key list
        is mostly padding; a model-parallel group over f shards sees the
        global key list but owns about 1/f of it, so it asks f x the keys."""
        if any(lm.windowed for lm in g.lookups):
            return 0.0
        return self.dense_key_ratio * self._meta[g.name].num_shards

    def _onehot_grad(
        self, gname: str, table_dtype, keys: torch.Tensor, d_group: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense float32 [R, E] gradient + [R] touch counts of the rank's
        rows (collection.py:1407). Each table's kernel adds into its rows of
        the group's float32 buffers, which are zeroed once per group; `d`
        enters in the table's type."""
        g = self._meta[gname].plan
        valid, _owner, local_row = self._slot_placement(gname, keys)
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
        return grad, colsum

    def _grad_source(self, g: GroupPlan, d_out: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """[B, W] output grads -> compact gradient source [B*S, E]: one row
        per sample for each sum/mean lookup (collection.py:616); Mean
        divides by the count of `valid`, the raw valid keys (:1827)."""
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
        self, gname: str, keys: torch.Tensor, d_group: torch.Tensor, key_store=None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(flat row ids with sentinel R, grad-source rows, compact grad
        source) (collection.py:1801); over f shards the keys of the other
        shards take the sentinel too."""
        meta = self._meta[gname]
        g = meta.plan
        valid, owner, local_row = self._slot_placement(gname, keys, key_store)
        if owner is not None:
            valid = valid & (owner == meta.shard)
        dsrc = self._grad_source(g, d_group, keys != INVALID_KEY)
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

    def _sharded_rows(self, g: GroupPlan, ti: int) -> Tuple[np.ndarray, np.ndarray]:
        """(owner shard, row in the shard's block of the table) of each key
        of a model-parallel table, in key order (`_table_storage_rows`,
        collection.py:2729)."""
        f = self._meta[g.name].num_shards
        keys = np.arange(int(g.table_vocab[ti]), dtype=np.int64)
        return (keys + int(g.table_rotation[ti]) % f) % f, keys // f

    def export_table(self, tables: Tables, table_name: str) -> np.ndarray:
        """One table as a [vocab, ...] host array in key order, a split table
        put back together from its tiers (collection.py:2101); float32 for
        bfloat16 tables (numpy has no bfloat16). `tables` may be any
        {group: [rows, ...]} arrays laid out as the storage, such as one
        kind of optimizer state. A sharded table is all-gathered: every
        rank calls this together; ranks 0..f-1 hold its f shards."""
        if table_name in self.plan.table_splits:
            return np.concatenate(
                [self.export_table(tables, sub) for sub, _off in self.plan.table_splits[table_name]]
            )
        g, ti = self._find_table(table_name)
        off, vocab = int(g.local_offsets[ti]), int(g.table_vocab[ti])
        if self._meta[g.name].num_shards > 1:
            rps = int(g.rows_per_shard[ti])
            shards = all_gather(tables[g.name][off : off + rps].detach().float()).cpu().numpy()
            shard, row = self._sharded_rows(g, ti)
            return shards[shard * rps + row]
        return tables[g.name][off : off + vocab].detach().float().cpu().numpy()

    def import_table(self, tables: Tables, table_name: str, values: np.ndarray) -> Tables:
        """Write one table from a [vocab, ...] array, a split table's rows
        into its tiers (collection.py:2124); `tables` as for `export_table`.
        A sharded table's rank writes its shard's keys: every replica of a
        shard the same rows (:2142-2148)."""
        if table_name in self.plan.table_splits:
            subs = self.plan.table_splits[table_name]
            for i, (sub, off) in enumerate(subs):
                end = subs[i + 1][1] if i + 1 < len(subs) else values.shape[0]
                self.import_table(tables, sub, values[off:end])
            return tables
        g, ti = self._find_table(table_name)
        off, vocab = int(g.local_offsets[ti]), int(g.table_vocab[ti])
        dst = tables[g.name]
        if values.shape != (vocab, *dst.shape[1:]):
            raise ValueError(
                f"table {table_name}: expected {(vocab, *dst.shape[1:])}, got {values.shape}"
            )
        values = np.asarray(values, np.float32)
        with torch.no_grad():
            meta = self._meta[g.name]
            if meta.num_shards > 1:  # this rank's shard's keys only
                shard, row = self._sharded_rows(g, ti)
                mine = shard == meta.shard
                rows = torch.as_tensor(off + row[mine], device=self.device)
                dst[rows] = torch.as_tensor(values[mine]).to(self.device, dst.dtype)
            else:
                dst[off : off + vocab].copy_(torch.as_tensor(values))
        return tables

    # ------------------------------------- dynamic-table upkeep, not ported
    @staticmethod
    def _dynamic_upkeep(what: str):
        raise NotImplementedError(f"{what} of dynamic tables is not ported yet (ROADMAP Queue 1 item 5)")

    def export_key_store(self, tables: Tables, table_name: str):
        """collection.py:2164; not ported."""
        self._dynamic_upkeep("key-store export")

    def import_key_store(self, tables: Tables, table_name: str, keys):
        """collection.py:2184; not ported."""
        self._dynamic_upkeep("key-store import")

    def evict(self, tables: Tables, opt_state, table_name: str, keys):
        """collection.py:2220; not ported."""
        self._dynamic_upkeep("eviction")

    def grow_dynamic_capacity(self, tables: Tables, opt_state, table_name: str, new_capacity: int):
        """collection.py:2495; not ported."""
        self._dynamic_upkeep("capacity growth")
