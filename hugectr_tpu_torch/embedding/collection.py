"""Embedding collection on one device or over W ranks (counterpart of
hugectr_tpu/embedding/collection.py).

Each plan group owns one [R, E] storage tensor. Per group:

* "onehot" groups (small tables): the forward pools every lookup of the
  group in one launch of the one-hot forward kernel, placement included
  (`_onehot_fwd`, collection.py:1311-1337); the backward builds the dense
  gradient and touch counts of every lookup in one launch of the one-hot
  backward kernel, placement and Mean included (`_onehot_grad`; JAX's
  `_onehot_grad_pallas`, :1407-1435, one kernel a table), and runs the
  dense optimizer sweep over touched rows (`_onehot_bwd_local`, :1437-1452);
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
still unplaced after NUM_PROBES rounds are dropped for the step. The key
store is written and read beside a table's rows (`export_key_store`,
`import_key_store`). `evict` zeroes the rows and state of given keys and
frees their store rows (a static table's rows are zeroed); `grow_dynamic_capacity`
recompiles the plan with a larger capacity and carries every table's rows,
state and store over, re-inserting each dynamic table's resident keys one by
one in the JAX package's order (collection.py:2220-2672). Both work between
steps on the host (the rank's own shard over W ranks; every rank calls them
together).

Frozen tables (`frozen_tables`, collection.py:247-248; a split table's
user name freezes its tiers, `_is_frozen`, :2095-2099) take no update: a
one-hot group launches no backward for a frozen lookup (:1373-1375,
:1420-1422), and a rowop group masks the frozen slots out of its row list
before the sort (:1818-1825), so the sorted route scans fewer keys.

Weighted lookups (a lookup's `sp_weight_name`, collection.py:538-615,
:1236-1400, :1801-1837): `forward` and `backward_and_update` take
`feature_weights` {name: [B, hotness] float}; the slots of a weighted
group's unweighted lookups weigh 1, and padding 0. A Sum pools w x row in
the table's type, a Mean divides by the sum of its weights (1 where that is
0; a split lookup's merge by the raw keys' sum). The one-hot kernels take
each weighted lookup's weights (w x d into the gradient, each sample's
|summed w| on a row into the touch counts), the partitioned forward's sort carries them to the ordered pool,
and a rowop group's backward expands to one gradient row per key, w times
its slot's cotangent (K = B x H rows for the update).

Over W ranks (one process per device), each rank holds the block of its
data index of the batch (hybrid parallelism, collection.py:668-721,
:1567-1726): on the flat and hierarchical meshes rank r holds block r of
W; on the ("data", "ev") mesh of ev_parallelism e the W / e blocks are
split over "data" and each is replicated over the e ranks of "ev". Below,
W is the data-parallel size and a rank's "rank" its data index; every
collective runs over the rank's data group (`rm.data_group`):

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
  all-gathers the keys; the rank pools the keys of its shard (a replica
  serves only its block r // f of the gathered batch, so the ranks'
  contributions are disjoint) and the pools are reduce-scattered over the
  batch (`_mp_fwd_local`, :808-865). By default (`fwd_partition`, the JAX
  package's HCTR_TPU_FWD_PARTITION=1) it pools them by the
  owner-partitioned forward (`_mp_fwd_partitioned`, :867-936): only the
  owned rows are gathered, pooled by the ordered-pool kernel, each slot's
  rows in ascending row order with a rounding to the table's type after
  every add, as XLA's scatter-add sums the row-sorted owned prefix
  (`ops/ordered_pool.py`); a `capacity_factor` > 0 cuts the row-sorted
  list at `capacity(K, factor, W)` and drops the rest. With
  `fwd_partition` off it takes the masked gather of `_dp_fwd` (float32 sums
  rounded once). The backward all-gathers the keys and the cotangents,
  inserts a dynamic group's new keys of this rank's shard, and every
  replica applies the whole update of its shard (`_mp_bwd_local`,
  :1844-1894), whose key-ratio rule asks f x the keys (`_opt_knobs`,
  :1976); a `capacity_factor` > 0 keeps the first `capacity(K, factor, f)`
  entries of the sorted list (`sparse_optimizer.apply_sparse`'s
  `k_limit`);
* the unique-key dense exchange (HugeCTR's DenseModelParallelEmbedding,
  collection.py:953-1195) takes a static all-Concat model-parallel group
  at full placement, not packed and with no frozen table, whose list
  length C is set: explicitly (`dense_exchange_cap`, the JAX package's
  HCTR_TPU_DENSE_EXCHANGE_CAP) or by the measured caps
  (`dense_exchange_caps`) (`_dense_exchange_ok`): every rank derives the same sorted-unique row
  lists of each (batch block, owner shard) from the gathered keys; the
  forward's owner gathers its rows of every list and `all_to_all` hands
  each block its vectors, placed by a `searchsorted`; the backward sums
  the block's float32 gradients per list entry, `all_to_all` hands them
  to the owners, and the update runs over the lists with the key-ratio
  rule off. A list longer than the cap on any rank (the flag is summed
  over the ranks, one host sync per group and pass) sends the group to the
  exact paths: the masked gather forward and the full update;
* data-parallel rowop groups are replicated: the forward is local, the
  backward all-gathers keys and cotangents and every rank applies the
  update (`_dp_bwd_local`, :1896).

On the card `index_add_` sums with atomics, in an order that differs from
rank to rank: after an update on the dense sweep or the scatter route
(`sparse_optimizer.ATOMIC_ROUTES`) a group held by several ranks (a
partial placement's replicas, a data-parallel group, and on the ("data",
"ev") mesh every group's ev replicas) takes the table and state of the
lowest of them by a `broadcast` in its replica group
(`ResourceManager.replica_group`), so replicas stay bitwise equal. The
sorted route is deterministic and needs none. On the ("data", "ev") mesh
the one-hot group's summed gradient (from the backward kernel's atomics)
is broadcast over the ev group before the update.

With `CommunicationStrategy.Hierarchical` on a hierarchical ("dcn", "ici")
mesh the pooled partials are reduce-scattered in two levels, over the ICI
group and then over the DCN group, which carries 1 / I of the volume
(`_psum_scatter_batch`, collection.py:391-423; `core/mesh.py`
`hier_reduce_scatter`), and the backward gathers the cotangents by the
transpose (DCN, then ICI). Uniform, and every other collective, runs over
all W ranks. The dense exchange is shut on the hierarchical and ev meshes
(:969).

The dtype each collective carries: the forward's all_gather of keys int32,
its reduce_scatter of pools the table's type; the backward's all_gather of
keys int32 and of cotangents the table's type (the JAX package's
`d_outs.astype(self.dtype)`); the dense exchange's all_to_all of rows the
table's type and of gradient sums float32, its all_reduce of the overflow
flag int32; the one-hot all_reduce of the gradient the table's type (a
16-bit sum over ranks is taken in float32 and rounded once, `core/mesh.py`)
and of the touch counts float32; the replica broadcasts each array's own type
(tables, float32 or bfloat16 state). `Model` adds one float32 all_reduce
of the dense gradients and the loss.

The collectives are `core/mesh.py`'s. `export_table` and `import_table`
read and write a table (or any per-row array laid out as the storage, such
as a state, or a key store) in key order whatever W and f are (collectives
on every rank); `export_rows` keeps the storage's dtype (bfloat16 tables
in snapshots).
The measured caps (HCTR_TPU_UCAP_FACTOR=auto, `unique_cap_factor="auto"`;
`auto_unique_caps`, collection.py:1996-2092), taken once on the first batch
the model sees: `unique_caps` and `valid_caps` window the update (exact,
except in the drop mode: `sparse_optimizer.apply_sparse`), a valid cap
turns the key-ratio rule on for a windowed group and counts the measured
keys (`_opt_knobs`, :1962-1994), sends a group's forward to the compact
form (the ordered pool of its valid keys, :1454-1564), and over W ranks
`dense_exchange_caps` open the dense exchange. Over W ranks the model
gathers the ranks' first batches with one collective and every rank
measures the whole batch, as the JAX package's one process over a mesh of
W devices does; its multi-process run measures each process's share and
scales the global counts by the process count P (:2056-2076), bounds that
the one-process measurement does not need.

Packed table-and-state storage (`packed_state`: AdaGrad's [R, 2E];
`rowwise_pack`: RowWiseAdaGrad's [R, E + 1], groups of more than
`dense_update_rows` rows; collection.py:254-286): a group's table holds its
accumulators in trailing columns and its `opt_state` entry is empty. The
forward reads the first E columns (`_weights`), the update takes the
sorted route (`sparse_optimizer`), the dense exchange is shut (:971), and
`export_rows` / `import_table` read and write the weights and keep the
accumulators.

`route_counts` counts, per route ("onehot", "dense", "sorted", "scatter"),
the groups updated since the collection was built; `group_routes` holds
each group's route in the last backward.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.mesh import (
    ResourceManager,
    all_gather,
    all_reduce,
    all_to_all,
    broadcast,
    group_size,
    hier_all_gather,
    hier_reduce_scatter,
    reduce_scatter,
)
from ..core.types import INVALID_KEY, Combiner_t, CommunicationStrategy, Optimizer_t
from ..ops.onehot_matmul import (
    MAX_GROUP_LOOKUPS,
    GroupLookup,
    onehot_bwd_chunked,
    onehot_fwd_chunked,
    place_keys,
    window_keys,
)
from ..ops.ordered_pool import ordered_pool, segments
from ..optim.params import OptParams
from ..parallel.plan import CompiledEmbeddingPlan, GroupPlan, ShardingPlan, compile_plan
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


def fold_reserved_key(k32):
    """The int32 key 2^31 - 1 is the store's EMPTY marker: it behaves as
    2^31 - 2 (collection.py:76); a tensor or a numpy array."""
    if isinstance(k32, np.ndarray):
        return np.where(k32 == EMPTY_KEY, np.int32(EMPTY_KEY - 1), k32)
    return torch.where(k32 == EMPTY_KEY, EMPTY_KEY - 1, k32)


def hash_mix_np(k: np.ndarray) -> np.ndarray:
    """`hash_mix` on the host: the murmur3 finalizer of int32 keys as uint32
    (collection.py:64 `_hash_mix_np`, bit for bit the same)."""
    h = k.astype(np.uint32)
    h = h ^ (h >> 16)
    h = (h * np.uint32(0x85EBCA6B)) & np.uint32(0xFFFFFFFF)
    h = h ^ (h >> 13)
    h = (h * np.uint32(0xC2B2AE35)) & np.uint32(0xFFFFFFFF)
    return h ^ (h >> 16)


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
        gsrc = _fwd_gsrc(g)
        self.gsrc = torch.as_tensor(gsrc, dtype=torch.int64, device=device)
        # the first key column of each pool slot (gsrc does not decrease
        # along the columns), and whether a slot pools more than one key
        self.slot_start = torch.as_tensor(
            np.searchsorted(gsrc, np.arange(g.grad_src_slots)), dtype=torch.int64, device=device
        )
        self.multi_key_slots = g.hotness_total > g.grad_src_slots
        # the most key columns a pool slot has (the plan's, whatever the keys)
        self.max_slot = int(np.bincount(gsrc).max()) if gsrc.size else 0
        # (gathered batch, sentinel) -> (each key's slot x (sentinel + 1),
        # the pool's slot offsets): fixed by the plan, made once
        self.pool_layout: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
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


def capacity(k: int, factor: float, n: int) -> int:
    """The owner-partition capacity of a sorted list of k keys over n
    shards: k x factor / n rounded up to a multiple of 512, at most k
    (collection.py:904-916, :1884-1891)."""
    return min(k, ((int(k * factor / n) + 511) // 512) * 512)


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

    NUM_PROBES = NUM_PROBES
    EMPTY_KEY = EMPTY_KEY

    def __init__(
        self,
        plan: CompiledEmbeddingPlan,
        rm: ResourceManager,
        opt: OptParams,
        dtype=torch.float32,
        dense_update_rows: int = 262144,
        dense_key_ratio: float = 0.3,
        dense_grad_dtype=torch.float32,
        state_dtype=torch.float32,
        fwd_partition: bool = True,
        capacity_factor: float = 0.0,
        dense_exchange_cap: int = 0,
        comm_strategy: CommunicationStrategy = CommunicationStrategy.Uniform,
        dense_exchange: bool = True,
        unique_cap_factor=0.0,
        ucap_headroom: float = 1.25,
        ucap_min_k: int = 0,
        ucap_drop: bool = False,
        packed_state: bool = False,
        rowwise_pack: bool = False,
    ):
        for what, dt in (("tables", dtype), ("optimizer state", state_dtype), ("the dense gradient", dense_grad_dtype)):
            if dt not in (torch.float32, torch.bfloat16):
                raise ValueError(f"{what} must be float32 or bfloat16, got {dt}")
        self.plan = plan
        self.rm = rm
        self.device = rm.device
        # the batch blocks and this rank's: the data axes of the mesh
        self.world = rm.data_parallel_size
        self.rank = rm.data_index
        self.ev = rm.ev_parallel_size
        # the collectives over the data axes: the rank's data group
        dg = rm.data_group
        self._all_gather = functools.partial(all_gather, group=dg)
        self._reduce_scatter = functools.partial(reduce_scatter, group=dg)
        self._all_to_all = functools.partial(all_to_all, group=dg)
        self._all_reduce = functools.partial(all_reduce, group=dg)
        # the two-level exchange of a hierarchical mesh (collection.py:391-423)
        self.hierarchical = (CommunicationStrategy(comm_strategy or CommunicationStrategy.Uniform)
                             == CommunicationStrategy.Hierarchical and rm.is_hierarchical)
        self.opt = opt
        self.dtype = dtype
        self.state_dtype = state_dtype
        self.dense_update_rows = dense_update_rows
        self.dense_key_ratio = dense_key_ratio
        # the dense sweep's gradient buffer (JAX: HCTR_TPU_DENSE_GRAD_DTYPE)
        self.dense_grad_dtype = dense_grad_dtype
        # the exchanges over W > 1 ranks (`Solver` fields; the JAX package's
        # HCTR_TPU_FWD_PARTITION, _MP_CAPACITY_FACTOR and
        # _DENSE_EXCHANGE_CAP, collection.py:141-144, :203-208; a cap of 0
        # is the exchange off, as HCTR_TPU_DENSE_EXCHANGE=0)
        self.fwd_partition = fwd_partition
        self.capacity_factor = capacity_factor
        self.dense_exchange = dense_exchange
        self.dense_exchange_cap = dense_exchange_cap
        # the unique-row windows (HCTR_TPU_UCAP_FACTOR, _HEADROOM, _MIN_K and
        # _DROP, collection.py:146-168): "auto" measures the caps on the
        # first batch (`auto_unique_caps`), a factor in (0, 1) sizes the
        # window from the key list
        self.ucap_auto = unique_cap_factor == "auto"
        self.ucap_factor = 0.0 if self.ucap_auto else float(unique_cap_factor or 0.0)
        self.ucap_headroom = float(ucap_headroom)
        self.ucap_min_k = int(ucap_min_k)
        self.ucap_drop = bool(ucap_drop)
        self.unique_caps: Dict[str, int] = {}
        self.valid_caps: Dict[str, int] = {}
        self.dense_exchange_caps: Dict[str, int] = {}
        # set once `auto_unique_caps` ran, even when it measured no cap
        self.ucap_measured = False
        # the rows the drop mode dropped since the collection was built
        self.ucap_stats: Dict[str, int] = collections.Counter()
        self.packed_state = bool(packed_state)
        self.rowwise_pack = bool(rowwise_pack)
        # what a recompile (`grow_dynamic_capacity`) builds the new collection with
        self._settings = dict(dtype=dtype, dense_update_rows=dense_update_rows, dense_key_ratio=dense_key_ratio,
                              dense_grad_dtype=dense_grad_dtype,
                              state_dtype=state_dtype, fwd_partition=fwd_partition,
                              capacity_factor=capacity_factor, dense_exchange_cap=dense_exchange_cap,
                              comm_strategy=comm_strategy, dense_exchange=dense_exchange,
                              unique_cap_factor=unique_cap_factor, ucap_headroom=ucap_headroom,
                              ucap_min_k=ucap_min_k, ucap_drop=ucap_drop, packed_state=packed_state,
                              rowwise_pack=rowwise_pack)
        self._meta = {g.name: _GroupMeta(g, self.device, self.rank) for g in plan.groups}
        self.group_opt: Dict[str, OptParams] = {}
        for g in plan.groups:
            opts = {id(t.opt_params): t.opt_params for t in g.tables if t.opt_params}
            if len(opts) > 1:
                raise ValueError(
                    f"group {g.name}: tables with different opt_params must not share a group"
                )
            self.group_opt[g.name] = next(iter(opts.values())) if opts else opt
        self.packed_kind = self._compute_packed_kind(plan)
        self.packed_groups = set(self.packed_kind)
        self.route_counts: Dict[str, int] = collections.Counter()
        self.group_routes: Dict[str, str] = {}
        # tables that take no update (`Model.freeze_embedding`)
        self.frozen_tables: set = set()
        if group_size() > 1:  # every rank makes the replica groups, in plan order
            for g in plan.groups:
                if self._replicated(g):
                    rm.replica_group(self._meta[g.name].num_shards)

    def _compute_packed_kind(self, plan: CompiledEmbeddingPlan) -> Dict[str, str]:
        """{group: "full" | "rowwise"}: the groups whose optimizer state
        lives in trailing columns of the table (collection.py:254-286).
        "full" ([R, 2E], `packed_state`): every AdaGrad rowop group;
        "rowwise" ([R, E + 1], `rowwise_pack`): every static RowWiseAdaGrad
        rowop group of more than `dense_update_rows` rows."""
        out: Dict[str, str] = {}
        for g in plan.groups:
            if g.compute_kind != "rowop":
                continue
            kind = self.group_opt[g.name].optimizer
            if self.packed_state and kind == Optimizer_t.AdaGrad:
                out[g.name] = "full"
            elif (self.rowwise_pack and kind == Optimizer_t.RowWiseAdaGrad
                  and not bool(g.slot_is_dynamic.any()) and g.total_local_rows > self.dense_update_rows):
                out[g.name] = "rowwise"
        return out

    def _weights(self, gname: str, table: torch.Tensor) -> torch.Tensor:
        """The [R, E] weights of a group's storage: a view of the first E
        columns of a packed group's (`_weights_view`, collection.py:383)."""
        return table[:, : self._meta[gname].plan.ev_size] if gname in self.packed_groups else table

    def _is_frozen(self, table_name: str) -> bool:
        """A frozen table, or a tier `name::tier` of a frozen split table
        (collection.py:2095-2099)."""
        return table_name in self.frozen_tables or table_name.split("::", 1)[0] in self.frozen_tables

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
        `"{group}#keys"` (collection.py:329-341). A packed group's storage
        carries its accumulators, at the optimizer's initial value, in E or
        1 more columns (:320-326)."""
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
            packed = self.packed_kind.get(g.name)
            if packed:
                accu0 = float(self.group_opt[g.name].initial_accu_value)
                acc = t.new_full((t.shape[0], g.ev_size if packed == "full" else 1), accu0)
                tables[g.name] = torch.cat([t, acc], dim=1)
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
        """Each group's optimizer state (collection.py:355); none for a
        packed group, whose table holds it."""
        return {
            g.name: {} if g.name in self.packed_groups else sparse_optimizer.init_state(
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

    def onehot_fwd_calls(self) -> int:
        """The one-hot forward's calls a forward: ceil(n / 48) for a group
        of n lookups (`_onehot_fwd`)."""
        return sum(-(-len(g.lookups) // MAX_GROUP_LOOKUPS) for g in self.plan.groups if g.compute_kind == "onehot")

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
                keys = self._all_gather(keys)
            owner, _row, found = self._dynamic_probe(meta, keys, store)
            miss = (keys != INVALID_KEY) & meta.slot_dynamic.unsqueeze(0) & (owner == meta.shard) & ~found
            out[g.name] = (int((store != EMPTY_KEY).sum()), int(torch.unique(keys[miss]).numel()))
        return out

    @staticmethod
    def _count(valid: torch.Tensor, dtype) -> torch.Tensor:
        return torch.clamp(valid.to(dtype).sum(dim=1, keepdim=True), min=1.0)

    @staticmethod
    def _weight_sum(w: torch.Tensor, dtype) -> torch.Tensor:
        """[B, 1] sum of (masked) weights, each first rounded to `dtype`, as
        the JAX package casts them (collection.py:542-548), summed in
        float32 and rounded to `dtype`; 1 where it is 0."""
        sw = w.to(dtype).float().sum(dim=1, keepdim=True).to(dtype)
        return torch.where(sw == 0, torch.ones((), dtype=dtype, device=sw.device), sw)

    def _mean_denom(self, lm, valid: torch.Tensor, weights: Optional[torch.Tensor], dtype) -> torch.Tensor:
        """[B, 1] Mean divisor of one lookup (collection.py:538): the count of
        `valid` keys (at least 1), or for a weighted lookup the sum of its
        weights (masked by the keys' validity), 1 where that sum is 0."""
        sl = slice(lm.slot_begin, lm.slot_end)
        if weights is not None and lm.sp_weight_name:
            return self._weight_sum(weights[:, sl], dtype)
        return self._count(valid[:, sl], dtype)

    @staticmethod
    def _lookup_weights(g: GroupPlan, feature_weights) -> Optional[List[Optional[torch.Tensor]]]:
        """Each lookup's [B, hotness] float32 weights (None for an
        unweighted lookup), or None for a group without weighted lookups
        (collection.py:556-595, with its errors)."""
        if not g.has_weights:
            return None
        if feature_weights is None:
            raise ValueError(f"group {g.name} has weighted lookups; pass feature_weights to "
                             "forward/backward_and_update")
        out: List[Optional[torch.Tensor]] = []
        for lm in g.lookups:
            if not lm.sp_weight_name:
                out.append(None)
                continue
            w = feature_weights[lm.sp_weight_name]
            if w.dim() == 1:
                w = w.unsqueeze(1)
            if w.shape[1] != lm.slot_end - lm.slot_begin:
                raise ValueError(f"sp_weight {lm.sp_weight_name}: width {w.shape[1]} != lookup hotness "
                                 f"{lm.slot_end - lm.slot_begin}")
            out.append(w.float())
        return out

    def _group_weights(self, g: GroupPlan, feature_weights, keys: torch.Tensor) -> Optional[torch.Tensor]:
        """[B, H] float32 per-slot weights of a weighted group, 1 for the
        slots of its unweighted lookups, 0 where the group's (windowed) key
        is padding (collection.py:556-595, :670-672); None for a group
        without weighted lookups."""
        per = self._lookup_weights(g, feature_weights)
        if per is None:
            return None
        cols = [w if w is not None else torch.ones((keys.shape[0], lm.slot_end - lm.slot_begin),
                                                   dtype=torch.float32, device=keys.device)
                for w, lm in zip(per, g.lookups)]
        return torch.cat(cols, dim=1) * (keys != INVALID_KEY)

    # ------------------------------------------------------------- forward
    def forward(self, tables: Tables, feature_keys: Dict[str, torch.Tensor],
                feature_weights: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """{bottom_name: [B, hotness] keys} -> {top_name: [B, out_width]}
        (collection.py:647). `feature_weights` {sp_weight_name: [B,
        hotness] float}: the per-key weights of the weighted lookups,
        required iff one is declared."""
        outs: Dict[str, torch.Tensor] = {}
        for g in self.plan.groups:
            if g.compute_kind == "onehot":
                go = self._onehot_fwd(g.name, tables[g.name], self._lookup_keys(g, feature_keys),
                                      self._lookup_weights(g, feature_weights))
            elif g.is_model_parallel and self.world > 1:
                # the batch's keys; the rows of this rank's keys pooled; the
                # pools summed over the ranks in the table's type and
                # scattered (or the unique rows exchanged)
                keys_loc = self._group_keys(g, feature_keys)
                w_loc = self._group_weights(g, feature_weights, keys_loc)
                keys = self._all_gather(keys_loc)
                weights = self._all_gather(w_loc) if w_loc is not None else None
                store = tables.get(f"{g.name}#keys")
                table = self._weights(g.name, tables[g.name])
                dense_ex = self._dense_exchange_ok(g)
                lists = self._dense_lists(g.name, keys) if dense_ex else None
                if lists is not None:
                    go = self._mp_fwd_dense(g.name, table, lists, keys_loc, w_loc)
                elif self.fwd_partition and not dense_ex:
                    go = self._scatter(self._mp_fwd_partitioned(g.name, table, keys, store, weights))
                else:  # the masked gather; the dense exchange's overflow branch too
                    go = self._scatter(self._dp_fwd(g.name, table, keys, store, weights))
            else:
                keys = self._group_keys(g, feature_keys)
                table = self._weights(g.name, tables[g.name])
                w = self._group_weights(g, feature_weights, keys)
                vcap = self.valid_caps.get(g.name, 0)
                # a measured valid cap below the batch's key list (the
                # batch is W x the rank's block): the compact forward
                # (`_dp_fwd`, collection.py:1460-1473)
                if vcap and vcap < keys.numel() * self.world:
                    go = self._mp_fwd_partitioned(g.name, table, keys, tables.get(f"{g.name}#keys"), w,
                                                  cut=False)
                else:
                    go = self._dp_fwd(g.name, table, keys, tables.get(f"{g.name}#keys"), w)
            for lm in g.lookups:
                outs[lm.top_name] = go[:, lm.out_begin : lm.out_end]
        return self._merge_outputs(outs, feature_keys, feature_weights)

    def _scatter(self, partial: torch.Tensor) -> torch.Tensor:
        """The pooled partials of the gathered batch summed over the data
        axes, this rank's block kept (`_psum_scatter_batch`,
        collection.py:391-423): two levels, ICI then DCN, with Hierarchical
        communication on a hierarchical mesh; else one over all of them."""
        return hier_reduce_scatter(partial, self.rm) if self.hierarchical else self._reduce_scatter(partial)

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The backward's all-gather of the rank's cotangents: the transpose
        of `_scatter` (DCN, then ICI) where it has two levels."""
        return hier_all_gather(t, self.rm) if self.hierarchical else self._all_gather(t)

    def _merge_denom(self, m, feature_keys: Dict[str, torch.Tensor], feature_weights, dtype) -> torch.Tensor:
        """[B, 1] count of a split lookup's raw valid keys, at least 1, or a
        weighted lookup's sum of their weights, 1 where it is 0
        (collection.py:749-766)."""
        k = feature_keys[m.bottom_name]
        if k.dim() == 1:
            k = k.unsqueeze(1)
        valid = k.to(torch.int32) != INVALID_KEY
        if m.sp_weight_name and feature_weights is not None:
            w = feature_weights[m.sp_weight_name]
            w = w.unsqueeze(1) if w.dim() == 1 else w
            return self._weight_sum(torch.where(valid, w.float(), 0.0).to(dtype), dtype)
        return self._count(valid, dtype)

    def _merge_outputs(self, outs, feature_keys, feature_weights=None) -> Dict[str, torch.Tensor]:
        """Each split lookup's top is the sum of its tiers' tops; Mean
        divides by the raw valid count, or sum of weights (collection.py:768)."""
        for m in self.plan.merges:
            o = outs.pop(m.sub_tops[0])
            for sub in m.sub_tops[1:]:
                o = o + outs.pop(sub)
            if m.combiner == Combiner_t.Mean:
                o = o / self._merge_denom(m, feature_keys, feature_weights, o.dtype)
            outs[m.top_name] = o
        return outs

    def _expand_d_outs(self, d_outs, feature_keys, feature_weights=None) -> Dict[str, torch.Tensor]:
        """The user top's cotangent to each tier's top; Mean divides it by
        the raw valid count, or sum of weights (collection.py:788-805)."""
        if not self.plan.merges:
            return d_outs
        d_outs = dict(d_outs)
        for m in self.plan.merges:
            d = d_outs.pop(m.top_name)
            if m.combiner == Combiner_t.Mean:
                d = d / self._merge_denom(m, feature_keys, feature_weights, d.dtype)
            for sub in m.sub_tops:
                d_outs[sub] = d
        return d_outs

    def _onehot_fwd(self, gname: str, table: torch.Tensor, keys: List[torch.Tensor], weights=None) -> torch.Tensor:
        """Every lookup of the group on the raw feature keys
        (collection.py:1311-1337), one call per 48 consecutive lookups: the
        kernel does the placement, the Mean division and writes each lookup
        into its output columns; a weighted lookup's keys carry their
        weights (the JAX package's counts path, :1338-1357)."""
        g = self._meta[gname].plan
        return onehot_fwd_chunked(keys, self._meta[gname].fwd_lookups, table, g.out_width, weights)

    def _dp_fwd(self, gname: str, table: torch.Tensor, keys: torch.Tensor, key_store=None,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
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
        disjoint and their sum is the batch's (:829-837). With `weights`
        ([B, H], masked) each row is first multiplied by its weight in the
        table's type, and a weighted Mean divides by the sum of weights
        (:1474-1485, :858-864)."""
        meta = self._meta[gname]
        g = meta.plan
        valid, owner, local_row = self._slot_placement(gname, keys, key_store)
        if self.world > 1 and g.is_model_parallel:
            valid = self._owned(meta, keys, valid, owner)
        raw_valid = keys != INVALID_KEY
        safe = torch.where(valid, local_row, 0)
        b = keys.shape[0]
        outs: List[torch.Tensor] = []
        for lm in g.lookups:
            sl = slice(lm.slot_begin, lm.slot_end)
            scale = valid[:, sl] if weights is None else torch.where(valid[:, sl], weights[:, sl], 0.0)
            rows = table[safe[:, sl]] * scale.unsqueeze(-1).to(table.dtype)
            if lm.combiner == Combiner_t.Concat:
                outs.append(rows.reshape(b, -1))
                continue
            s = rows.sum(dim=1, dtype=torch.float32).to(table.dtype)
            if lm.combiner == Combiner_t.Mean:
                s = s / self._mean_denom(lm, raw_valid, weights, s.dtype)
            outs.append(s)
        return torch.cat(outs, dim=1)

    def _owned(self, meta: _GroupMeta, keys: torch.Tensor, valid: torch.Tensor, owner) -> torch.Tensor:
        """The valid keys of the gathered batch that this rank pools: those
        of its shard, and with replicas (f < W shards) only those of block
        r // f of the batch, so that the ranks' pools are disjoint
        (collection.py:826-837)."""
        if owner is not None:
            valid = valid & (owner == meta.shard)
        if meta.plan.num_replicas > 1:
            block = keys.shape[0] // meta.plan.num_replicas
            mine = torch.arange(keys.shape[0], device=keys.device) // block == self.rank // meta.num_shards
            valid = valid & mine.unsqueeze(1)
        return valid

    def _pool_segments(self, gname: str, keys: torch.Tensor, sentinel: int, key_store=None,
                       weights: Optional[torch.Tensor] = None, cut: bool = True):
        """(row ids, [B x S + 1] slot offsets) of the owner-partitioned
        forward's pool (`_mp_fwd_partitioned`, collection.py:867-916), the
        inputs of `ordered_pool`: slot b x S + gsrc[j] pools the local rows
        of the gathered keys [b, j] this rank owns, in ascending order, and
        every key it does not pool reads as `sentinel` (at least the
        table's rows), last in its slot. The slots' columns are fixed by the
        plan (its offsets are made once a batch size), so only the rows
        within a slot need an order: one sort along each batch row, none
        when every slot holds one key. With a capacity factor the (row,
        slot) pairs are stably sorted by row (lax.sort is stable), cut to
        `capacity(K, factor, W)` entries, dropping the owned keys past it,
        and regrouped by slot (`segments`); `cut` False (the compact
        forward) never cuts. With `weights` ([B, H]) a third
        entry: each row id's weight, carried through stable sorts, so that
        equal rows of a slot keep their order, as lax.sort with the weights
        as a third operand keeps it (collection.py:884-888); else None."""
        meta = self._meta[gname]
        g = meta.plan
        valid, owner, local_row = self._slot_placement(gname, keys, key_store)
        mine = self._owned(meta, keys, valid, owner)
        bg, h = keys.shape
        idx = torch.where(mine, local_row, sentinel)
        if cut and self.capacity_factor > 0:
            src = (torch.arange(bg, device=keys.device).unsqueeze(1) * g.grad_src_slots + meta.gsrc).reshape(-1)
            k = capacity(idx.numel(), self.capacity_factor, self.world)
            idx, perm = torch.sort(idx.reshape(-1), stable=True)
            if weights is None:
                return (*segments(idx[:k], src[perm[:k]], bg * g.grad_src_slots, sentinel), None)
            return segments(idx[:k], src[perm[:k]], bg * g.grad_src_slots, sentinel,
                            weights.reshape(-1)[perm[:k]])
        layout = meta.pool_layout.get((bg, sentinel))
        if layout is None:
            starts = (torch.arange(bg, device=keys.device).unsqueeze(1) * h + meta.slot_start).reshape(-1)
            layout = meta.pool_layout[(bg, sentinel)] = (
                meta.gsrc * (sentinel + 1), torch.cat([starts, starts.new_full((1,), bg * h)]))
        slot_base, offsets = layout
        if meta.multi_key_slots:
            if weights is None:
                idx = torch.sort(slot_base + idx, dim=1).values % (sentinel + 1)
            else:
                idx, perm = torch.sort(slot_base + idx, dim=1, stable=True)
                idx, weights = idx % (sentinel + 1), torch.gather(weights, 1, perm)
        w = weights.reshape(-1).contiguous() if weights is not None else None
        return idx.reshape(-1), offsets, w

    def _mp_fwd_partitioned(self, gname: str, table: torch.Tensor, keys: torch.Tensor, key_store=None,
                            weights: Optional[torch.Tensor] = None, cut: bool = True) -> torch.Tensor:
        """This rank's [B, out_width] partial pools of the gathered keys by
        the owner-partitioned forward (collection.py:867-936, the JAX
        package's default at W > 1): gather only the owned rows and pool
        them into [B x S, E] with the ordered-pool kernel, each slot's rows
        in ascending row order with a rounding to the table's type after
        every add, as XLA's scatter-add in that type sums the row-sorted
        owned prefix (`ops/ordered_pool.py`); then Mean divides by the raw
        valid count (`_apply_mean_scaling`, :1212). Nothing waits for the
        card: the keys of other shards sort last in each slot and the kernel
        stops there. A weighted group's rows are scaled by their weights in
        the kernel, in the table's type (:890-900).

        The JAX package's measured window (`valid_caps`, :904-930) pools a
        prefix of the row-sorted list with an exact fallback, so it changes
        no result; here each slot's row list ends at its first foreign key,
        so there is no prefix to cut. With `cut` False this is the compact
        forward of a group with a measured valid cap (`_dp_fwd_compact`,
        :1496-1564), every valid key of the rank's batch owned: each slot
        sums its rows in ascending row order, as the scatter-add of the
        row-sorted valid prefix does (and in the order of the tier sort,
        `_tier_sorted_rows`, :1758-1799, which sorts the raw keys: the same
        rows, the same order)."""
        g = self._meta[gname].plan
        rows, offsets, w = self._pool_segments(gname, keys, table.shape[0], key_store, weights, cut)
        # the slots of the uncut layout have the plan's columns (a capacity
        # cut regroups the rows by the data)
        fixed = None if cut and self.capacity_factor > 0 else self._meta[gname].max_slot
        pooled = ordered_pool(table, rows, offsets, w, fixed).reshape(keys.shape[0], g.grad_src_slots, g.ev_size)
        return self._mean_scaled(g, pooled, keys != INVALID_KEY, weights)

    def _mean_scaled(self, g: GroupPlan, pooled: torch.Tensor, raw_valid: torch.Tensor,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, S, E] slot pools -> [B, out_width]: a Concat lookup's slots
        side by side, a Mean lookup's pool divided by its count of raw valid
        keys, or sum of weights (collection.py:1212-1232)."""
        b = pooled.shape[0]
        parts, cursor = [], 0
        for lm in g.lookups:
            h = lm.slot_end - lm.slot_begin
            if lm.combiner == Combiner_t.Concat:
                parts.append(pooled[:, cursor : cursor + h].reshape(b, -1))
                cursor += h
                continue
            p = pooled[:, cursor]
            if lm.combiner == Combiner_t.Mean:
                p = p / self._mean_denom(lm, raw_valid, weights, p.dtype)
            parts.append(p)
            cursor += 1
        return torch.cat(parts, dim=1)

    # ------------------------------------- the unique-key dense exchange
    def _dense_exchange_ok(self, g: GroupPlan) -> bool:
        """The gate of the unique-key dense exchange (`_dense_exchange_ok`,
        collection.py:953-957): the group's shape admits it and its cap is
        set, explicitly or by `auto_unique_caps`."""
        return self._dense_exchange_shape_ok(g) and self._dense_exchange_cap(g.name) > 0

    def _dense_exchange_shape_ok(self, g: GroupPlan) -> bool:
        """A static all-Concat model-parallel rowop group at full placement
        (f = W, no replicas) over W > 1 ranks, neither packed nor holding a
        frozen table, with the exchange on (`Solver.dense_exchange`), shut
        on the hierarchical and ("data", "ev") meshes (collection.py:959-979)."""
        return (
            self.dense_exchange and self.world > 1
            and not self.rm.is_hierarchical and self.ev == 1
            and g.is_model_parallel and g.compute_kind == "rowop" and not self._meta[g.name].any_dynamic
            and g.num_shards == self.world and g.num_replicas == 1
            and g.name not in self.packed_groups
            and all(lm.combiner == Combiner_t.Concat for lm in g.lookups)
            and not any(self._is_frozen(t.name) for t in g.tables)
        )

    def _dense_exchange_cap(self, gname: str) -> int:
        """The lists' length C: the explicit cap, else the measured one
        (collection.py:981-984)."""
        return self.dense_exchange_cap or self.dense_exchange_caps.get(gname, 0)

    def _dense_lists(self, gname: str, keys: torch.Tensor) -> Optional[torch.Tensor]:
        """[W, f, C] sorted-unique local-row lists per (batch block, owner
        shard) of the gathered keys, sentinel R past each list's end, the
        same on every rank (`_dense_lists`, collection.py:1001-1049); None
        when a list holds more than C rows on any rank. The overflow flag is
        summed over the ranks before the branch, so every rank takes the
        same one: one host sync per group and pass."""
        meta = self._meta[gname]
        g = meta.plan
        f, cap, n = meta.num_shards, self._dense_exchange_cap(gname), self.world
        r = g.total_local_rows
        valid, owner, local_row = self._slot_placement(gname, keys)
        kpb = (keys.shape[0] // n) * keys.shape[1]
        ow = torch.where(valid, owner, f).reshape(n, kpb)
        rw = torch.where(valid, local_row, r).reshape(n, kpb)
        key = torch.sort(ow * (r + 1) + rw, dim=1).values  # (owner, row) in order, per block
        so, sr = torch.div(key, r + 1, rounding_mode="floor"), key % (r + 1)
        first = torch.ones_like(key, dtype=torch.bool)
        first[:, 1:] = key[:, 1:] != key[:, :-1]
        unew = first & (so < f)
        grank = torch.cumsum(unew.to(torch.int64), dim=1) - 1
        cnt = torch.stack([(unew & (so == s)).sum(dim=1) for s in range(f)], dim=1)  # [n, f]
        start = torch.cumsum(cnt, dim=1) - cnt
        so_c = so.clamp(max=f - 1)
        srank = grank - torch.gather(start, 1, so_c)
        dest = torch.where(unew & (srank < cap), so_c * cap + srank, f * cap)
        lists = torch.full((n, f * cap + 1), r, dtype=torch.int64, device=keys.device)
        lists.scatter_(1, dest, sr)
        over = self._all_reduce((cnt > cap).any().to(torch.int32).reshape(1))
        if int(over.item()) > 0:
            return None
        return lists[:, : f * cap].reshape(n, f, cap)

    def _dense_positions(self, gname: str, my_lists: torch.Tensor, keys_loc: torch.Tensor):
        """(flat index into the received [f x C] rows, valid) of each of the
        rank's [b, H] keys: its row's place in its owner's list
        (`_dense_positions`, collection.py:1051-1067)."""
        f, cap = my_lists.shape
        valid, owner, local_row = self._slot_placement(gname, keys_loc)
        of, rf = owner.reshape(-1), local_row.reshape(-1).contiguous()
        pos = torch.zeros_like(rf)
        for s in range(f):
            pos = torch.where(of == s, torch.searchsorted(my_lists[s].contiguous(), rf), pos)
        return of.clamp(0, f - 1) * cap + pos.clamp(max=cap - 1), valid

    def _mp_fwd_dense(self, gname: str, table: torch.Tensor, lists: torch.Tensor, keys_loc: torch.Tensor,
                      w_loc: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[b, out_width] outputs of the rank's block by the unique-key
        exchange (`_mp_fwd_dense_local`, collection.py:1069-1095): the rank
        gathers its shard's rows of every block's list, `all_to_all` sends
        block d's to rank d, and each key takes its row's vector (times its
        weight in the table's type, :1091-1094)."""
        g = self._meta[gname].plan
        r = g.total_local_rows
        want = lists[:, self.rank].reshape(-1)
        send = torch.where((want < r).unsqueeze(1), table[want.clamp(max=r - 1)], table.new_zeros(()))
        recv = self._all_to_all(send)  # block s's rows: rank s's shard's vectors for this block
        flat, valid = self._dense_positions(gname, lists[self.rank], keys_loc)
        vecs = recv[flat] * valid.reshape(-1, 1).to(recv.dtype)
        if w_loc is not None:
            vecs = vecs * torch.where(valid, w_loc, 0.0).reshape(-1, 1).to(vecs.dtype)
        return vecs.reshape(keys_loc.shape[0], g.out_width)

    def _mp_bwd_dense(self, gname: str, table, state, lists, keys_loc, d_loc, lr, step,
                      w_loc: Optional[torch.Tensor] = None) -> str:
        """The update of this rank's shard by the unique-key exchange
        (`_mp_bwd_dense_local`, collection.py:1121-1175): the rank's block's
        float32 gradient sums per list entry (each key's cotangent times its
        weight in the table's type, :1145-1147), `all_to_all` to the owners,
        rounded to the table's type, then `apply_sparse` over the [W x C]
        list with the key-ratio rule off. Returns the route."""
        g = self._meta[gname].plan
        f, cap = self._meta[gname].num_shards, self._dense_exchange_cap(gname)
        flat, valid = self._dense_positions(gname, lists[self.rank], keys_loc)
        dk = d_loc.reshape(keys_loc.shape[0], g.hotness_total, g.ev_size)
        if w_loc is not None:
            dk = dk * w_loc.unsqueeze(-1).to(dk.dtype)
        dk = dk.reshape(-1, g.ev_size).float()
        gbuf = torch.zeros((f * cap + 1, g.ev_size), dtype=torch.float32, device=self.device)
        gbuf.index_add_(0, torch.where(valid.reshape(-1), flat, f * cap), dk)
        recv = self._all_to_all(gbuf[:-1])  # block d's sums for this rank's lists
        idx = lists[:, self.rank].reshape(-1)
        src = torch.arange(idx.numel(), device=self.device)
        return sparse_optimizer.apply_sparse(
            self.group_opt[gname], table, state, idx, src, recv.to(self.dtype), lr,
            dense_rows=self.dense_update_rows, dense_ratio=0.0, step=step, grad_dtype=self.dense_grad_dtype,
        )

    # ------------------------------------------------- backward + update
    def backward_and_update(
        self,
        tables: Tables,
        opt_state: Dict[str, Dict[str, torch.Tensor]],
        feature_keys: Dict[str, torch.Tensor],
        d_outs: Dict[str, torch.Tensor],
        lr: torch.Tensor,
        step=1,
        feature_weights: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[Tables, Dict[str, Dict[str, torch.Tensor]]]:
        """Fused embedding backward + sparse optimizer update, in place
        (collection.py:1567). d_outs: {top_name: [B, out_width]} cotangents
        from the dense network; `step` is the 1-based global step or the
        model's `StepScalars` (Adam's bias corrections as device scalars);
        `feature_weights` as for `forward`: a weighted
        key's row gradient is its weight times the cotangent. A dynamic
        group inserts the batch's new keys into
        its key store before its rows are updated (`_bwd_single`, :1942).
        Over W ranks, `feature_keys` and `d_outs` are the rank's block of
        the batch, the cotangents of the global-batch loss; every rank
        calls this together (collectives). Returns the (updated) inputs."""
        lr = torch.as_tensor(lr, dtype=self.dtype, device=self.device)
        d_outs = self._expand_d_outs(d_outs, feature_keys, feature_weights)
        for g in self.plan.groups:
            d_group = torch.cat([d_outs[lm.top_name].to(self.dtype) for lm in g.lookups], dim=1)
            opt = self.group_opt[g.name]
            if g.compute_kind == "onehot":
                grad, colsum = self._onehot_grad(g.name, tables[g.name].dtype, feature_keys, d_group,
                                                 feature_weights)
                # the ranks' rows summed: the gradient rounded once to the
                # table's type, then one all_reduce of it in that type; the
                # touch counts in float32 (`_onehot_bwd_local`, :1437-1446)
                grad = self._all_reduce(grad.to(tables[g.name].dtype))
                self._all_reduce(colsum)
                if self.ev > 1:
                    # the ev replicas' gradients came from atomic sums:
                    # the first replica's is every replica's
                    broadcast(grad, self.rm.ev_group.ranks[0], self.rm.ev_group)
                # every row a valid key lands on is touched, for every
                # optimizer (`_onehot_bwd_local`, collection.py:1437-1452)
                sparse_optimizer.apply_dense(
                    opt, tables[g.name], opt_state[g.name], grad, colsum > 0, lr, step,
                )
                route = "onehot"
            else:
                keys = self._group_keys(g, feature_keys)
                w = self._group_weights(g, feature_weights, keys)
                route = self._rowop_update(g, tables, opt_state[g.name], keys, d_group, lr, step, w)
            self.route_counts[route] += 1
            self.group_routes[g.name] = route
        return tables, opt_state

    def _rowop_update(self, g: GroupPlan, tables: Tables, state, keys, d_group, lr, step,
                      weights: Optional[torch.Tensor] = None) -> str:
        """The update of a rowop group from the rank's [b, H] keys and [b,
        out_width] cotangents; returns the route. Over W ranks a
        model-parallel group updates this rank's shard for the whole global
        batch (every replica of a shard the same, `_mp_bwd_local`,
        collection.py:1844-1894), by the unique-key exchange where its gate
        opens and no list overflows (`_mp_bwd_dense_local`, :1121-1195), and
        with a capacity factor on a sorted list cut at `capacity(K, factor,
        f)` (:1884-1891); a data-parallel group gives every rank the same
        update (`_dp_bwd_local`, :1896). The shared sort of a split table's
        tiers (ROADMAP Queue 2, "split tables") is refused with frozen
        tables, as the JAX package's `_tier_shared_ok` refuses it (:1741).
        A weighted group's `weights` ([b, H], masked) expand its gradient
        into per-key rows (`_row_grads`)."""
        opt = self.group_opt[g.name]
        meta = self._meta[g.name]
        key_store = tables.get(f"{g.name}#keys")
        k_limit = 0
        if self.world > 1:
            gkeys = self._all_gather(keys)
            if self._dense_exchange_ok(g):
                lists = self._dense_lists(g.name, gkeys)
                if lists is not None:
                    return self._mp_bwd_dense(g.name, tables[g.name], state, lists, keys, d_group, lr, step,
                                              weights)
            elif meta.num_shards > 1 and self.capacity_factor > 0:
                k_limit = capacity(gkeys.numel(), self.capacity_factor, meta.num_shards)
            keys, d_group = gkeys, self._gather_rows(d_group)
            if weights is not None:
                weights = self._all_gather(weights)
        if key_store is not None:
            self._dynamic_insert(meta, key_store, keys)
        idx, src, dsrc = self._row_grads(g.name, keys, d_group, key_store, weights)
        route = sparse_optimizer.apply_sparse(
            opt, tables[g.name], state, idx, src, dsrc, lr, step=step, k_limit=k_limit, stats=self.ucap_stats,
            **self._opt_knobs(g),
        )
        if route in sparse_optimizer.ATOMIC_ROUTES and self._replicated(g):
            # atomic sums differ in their last bits from rank to rank: the
            # lowest replica's update is every replica's
            src_rank, group = self.rm.replica_group(meta.num_shards)
            for t in (tables[g.name], *state.values()):
                broadcast(t, src_rank, group)
        return route

    def _replicated(self, g: GroupPlan) -> bool:
        """Whether more than one rank holds the group's rowop storage (or a
        shard of it): a data-parallel group over W ranks, a model-parallel
        group over fewer shards than batch blocks, or any group on the
        ("data", "ev") mesh (its ev replicas)."""
        if g.compute_kind == "onehot":
            return False
        return self.world // self._meta[g.name].num_shards * self.ev > 1

    def _opt_knobs(self, g: GroupPlan) -> Dict:
        """`apply_sparse`'s settings for a rowop group (`_opt_knobs`,
        collection.py:1962-1994). The key-ratio rule counts the measured
        valid keys where a cap was measured; without one it is off for a
        windowed group, whose key list is mostly padding, and a
        model-parallel group over f shards, which sees the global key list
        but owns about 1/f of it, asks f x the keys."""
        ratio = self.dense_key_ratio
        vcap = self.valid_caps.get(g.name, 0)
        if not vcap:
            if any(lm.windowed for lm in g.lookups):
                ratio = 0.0
            else:
                ratio *= self._meta[g.name].num_shards
        return dict(dense_rows=self.dense_update_rows, dense_ratio=ratio, grad_dtype=self.dense_grad_dtype,
                    ucap_factor=self.ucap_factor, ucap_min_k=self.ucap_min_k, ucap_drop=self.ucap_drop,
                    ucap_cap=self.unique_caps.get(g.name, 0), valid_cap=vcap,
                    packed=self.packed_kind.get(g.name, False))

    def measured_caps(self) -> Dict[str, Dict[str, int]]:
        """{"unique" | "valid" | "dense_exchange": {group: cap}}, the caps
        `auto_unique_caps` measured (copies)."""
        return dict(unique=dict(self.unique_caps), valid=dict(self.valid_caps),
                    dense_exchange=dict(self.dense_exchange_caps))

    def auto_unique_caps(self, feature_keys: Dict[str, np.ndarray]) -> None:
        """Measure each static rowop group's caps on one batch
        (HCTR_TPU_UCAP_FACTOR=auto, `auto_unique_caps`, collection.py:1996-2092):
        `feature_keys` {bottom_name: [B, hotness]} is the host copy of the
        whole batch (over W ranks, every rank's block gathered in rank
        order). Per group and shard: the distinct owned rows (u) and the
        owned valid keys (v), maxima over the shards, and where the dense
        exchange's shape holds, the distinct owned rows of every (batch
        block, owner shard) pair (de). Caps: `unique_caps` ceil512(u x
        headroom), at least 512; `dense_exchange_caps` ceil128(de x
        headroom), at least 128; `valid_caps` ceil512(v x headroom), at
        least 512, kept only below 0.8 x the batch's key list. These are
        the caps the JAX package's one process over a mesh of W devices
        measures on the same batch."""
        self.ucap_measured = True
        for g in self.plan.groups:
            if g.compute_kind != "rowop" or self._meta[g.name].any_dynamic:
                continue
            cols = []
            for lm in g.lookups:
                k = np.asarray(feature_keys[lm.bottom_name]).astype(np.int64)
                if k.ndim == 1:
                    k = k[:, None]
                if lm.key_lo > 0 or lm.key_hi >= 0 or lm.key_shift:
                    hi = lm.key_hi if lm.key_hi >= 0 else np.iinfo(np.int64).max
                    k = np.where((k >= lm.key_lo) & (k < hi), k - lm.key_shift, int(INVALID_KEY))
                cols.append(k)
            keys = np.concatenate(cols, axis=1)
            valid = keys != INVALID_KEY
            f = g.num_shards if g.is_model_parallel else 1
            kk = keys % np.asarray(g.slot_vocab, dtype=np.int64)[None, :]
            owner = (kk + np.asarray(g.slot_rotation, dtype=np.int64)[None, :]) % f
            local = kk // f + np.asarray(g.slot_local_offset, dtype=np.int64)[None, :]
            gid = owner * int(g.total_local_rows) + local
            u_max = v_max = de_max = 0
            for sh in range(f):
                own = valid & (owner == sh)
                u_max = max(u_max, int(np.unique(gid[own]).size))
                v_max = max(v_max, int(own.sum()))
            n = self.world
            if self._dense_exchange_shape_ok(g) and keys.shape[0] % n == 0:
                bl = keys.shape[0] // n
                for d in range(n):
                    sl = slice(d * bl, (d + 1) * bl)
                    for sh in range(f):
                        own = valid[sl] & (owner[sl] == sh)
                        de_max = max(de_max, int(np.unique(local[sl][own]).size))
            h = self.ucap_headroom
            self.unique_caps[g.name] = max(((int(u_max * h) + 511) // 512) * 512, 512)
            if de_max > 0:
                self.dense_exchange_caps[g.name] = max(((int(de_max * h) + 127) // 128) * 128, 128)
            vcap = ((int(v_max * h) + 511) // 512) * 512
            if vcap < 0.8 * keys.size:
                self.valid_caps[g.name] = max(vcap, 512)

    def _onehot_grad(
        self, gname: str, table_dtype, feature_keys: Dict[str, torch.Tensor], d_group: torch.Tensor,
        feature_weights: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense float32 [R, E] gradient + [R] touch counts of the rank's
        rows (collection.py:1407): one backward launch for the group's
        lookups (one per 48), on the raw feature keys and the [B, W]
        cotangents read in place, in the table's type. The kernel places
        each key as the forward does, divides a Mean lookup's cotangent by
        its count of non-padding keys (a weighted one's by the sum of their
        weights) rounded to the table's type (:1427-1429), scales a
        weighted key's by its weight and adds each sample's |summed
        weights| on a row to its touch count (:1355-1391). A frozen table's
        lookups get no descriptor: no gradient, no touch (:1420-1422)."""
        meta = self._meta[gname]
        g = meta.plan
        live = [i for i, lm in enumerate(g.lookups) if not self._is_frozen(g.tables[lm.table_index].name)]
        keys = self._lookup_keys(g, feature_keys)
        per_w = self._lookup_weights(g, feature_weights)
        return onehot_bwd_chunked(
            [keys[i] for i in live], [meta.fwd_lookups[i] for i in live], d_group.to(table_dtype),
            g.total_local_rows, g.ev_size, None if per_w is None else [per_w[i] for i in live],
        )

    def _grad_source(self, g: GroupPlan, d_out: torch.Tensor, valid: torch.Tensor,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, W] output grads -> compact gradient source [B*S, E]: one row
        per sample for each sum/mean lookup (collection.py:616); Mean
        divides by the count of `valid`, the raw valid keys (:1827), or a
        weighted lookup's sum of weights."""
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
                d = d / self._mean_denom(lm, valid, weights, d.dtype).unsqueeze(-1)
            parts.append(d)
        return torch.cat(parts, dim=1).reshape(-1, g.ev_size)

    def _row_grads(
        self, gname: str, keys: torch.Tensor, d_group: torch.Tensor, key_store=None,
        weights: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(flat row ids with sentinel R, grad-source rows, compact grad
        source) (collection.py:1801); over f shards the keys of the other
        shards take the sentinel too, and so do a frozen table's slots
        (:1818-1825). A weighted group expands to one gradient row per key,
        its weight times its slot's source row in the table's type
        (:1829-1837), so the update's list has K = B x H rows."""
        meta = self._meta[gname]
        g = meta.plan
        valid, owner, local_row = self._slot_placement(gname, keys, key_store)
        if owner is not None:
            valid = valid & (owner == meta.shard)
        if self.frozen_tables:
            unfrozen = [not self._is_frozen(g.tables[ti].name) for ti in g.slot_table]
            valid = valid & torch.as_tensor(unfrozen, device=valid.device).unsqueeze(0)
        dsrc = self._grad_source(g, d_group, keys != INVALID_KEY, weights)
        b = keys.shape[0]
        idx = torch.where(valid, local_row, g.total_local_rows).reshape(-1)
        if weights is not None:
            dk = dsrc.reshape(b, g.grad_src_slots, g.ev_size)[:, meta.gsrc, :]
            dk = dk * weights.unsqueeze(-1).to(dk.dtype)
            return idx, torch.arange(b * g.hotness_total, device=self.device), dk.reshape(-1, g.ev_size)
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

    def export_rows(self, tables: Tables, table_name: str, full: bool = False) -> torch.Tensor:
        """One table as a [vocab, ...] host tensor (a copy) in key order, in
        the storage's dtype, a split table put back together from its tiers
        (collection.py:2101). `tables` may be any {group: [rows, ...]}
        arrays laid out as the storage: a kind of optimizer state, or the
        key stores under their groups' names. A packed group's rows give
        their first E columns, the weights (:2120-2121), or with `full` the
        whole rows. A sharded table is all-gathered: every rank calls this
        together; ranks 0..f-1 hold its f shards."""
        if table_name in self.plan.table_splits:
            return torch.cat([self.export_rows(tables, sub, full) for sub, _off in self.plan.table_splits[table_name]])
        g, ti = self._find_table(table_name)
        off, vocab = int(g.local_offsets[ti]), int(g.table_vocab[ti])
        src = tables[g.name].detach()
        if not full and src.dim() == 2 and src.shape[1] > g.ev_size:
            src = src[:, : g.ev_size]
        if self._meta[g.name].num_shards > 1:
            rps = int(g.rows_per_shard[ti])
            shards = self._all_gather(src[off : off + rps].contiguous()).cpu()
            shard, row = self._sharded_rows(g, ti)
            return shards[torch.from_numpy(shard * rps + row)]
        return src[off : off + vocab].to("cpu", copy=True)

    def export_table(self, tables: Tables, table_name: str) -> np.ndarray:
        """`export_rows` as a numpy array; float32 for bfloat16 tables
        (numpy has no bfloat16)."""
        t = self.export_rows(tables, table_name)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def import_table(self, tables: Tables, table_name: str, values) -> Tables:
        """Write one table from a [vocab, ...] array or host tensor (a float
        array through float32, then rounded to the storage's type), a split
        table's rows into its tiers (collection.py:2124); `tables` as for
        `export_rows`. [vocab, E] values into a packed group's rows write
        their weights and keep their accumulators (:2150-2155, `_import_packed_fn`).
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
        if dst.dim() == 2 and dst.shape[1] > g.ev_size and values.ndim == 2 and values.shape[1] == g.ev_size:
            dst = dst[:, : g.ev_size]
        if tuple(values.shape) != (vocab, *dst.shape[1:]):
            raise ValueError(
                f"table {table_name}: expected {(vocab, *dst.shape[1:])}, got {tuple(values.shape)}"
            )
        if not isinstance(values, torch.Tensor):
            values = np.asarray(values)
            values = torch.from_numpy(values.astype(np.float32) if values.dtype.kind == "f" else values)
        values = values.to(dst.dtype)
        with torch.no_grad():
            meta = self._meta[g.name]
            if meta.num_shards > 1:  # this rank's shard's keys only
                shard, row = self._sharded_rows(g, ti)
                mine = shard == meta.shard
                rows = torch.as_tensor(off + row[mine], device=self.device)
                dst[rows] = values[torch.from_numpy(mine)].to(self.device)
            else:
                dst[off : off + vocab].copy_(values)
        return tables

    def _key_store(self, tables: Tables, table_name: str):
        """(group, the group's key store) of a dynamic table; None for a
        static or split table, whose key -> row map is positional."""
        if table_name in self.plan.table_splits:
            return None
        g, ti = self._find_table(table_name)
        ks = tables.get(f"{g.name}#keys")
        return None if ks is None or not g.tables[ti].is_dynamic else (g, ks)

    def export_key_store(self, tables: Tables, table_name: str) -> Optional[np.ndarray]:
        """A dynamic table's int32 key store [vocab], row-aligned with
        `export_table`'s rows (collection.py:2164); None for a static table.
        A sharded store is all-gathered (every rank calls this together)."""
        found = self._key_store(tables, table_name)
        if found is None:
            return None
        g, ks = found
        return self.export_rows({g.name: ks}, table_name).numpy()

    def import_key_store(self, tables: Tables, table_name: str, keys) -> Tables:
        """Write a dynamic table's key store from an `export_key_store`
        array (collection.py:2184); every replica of a shard the same rows.
        A static table is left as it is. The keys are written as they are:
        every insert folds the key 2^31 - 1 (`fold_reserved_key`), so in an
        exported store that value only marks an empty row. The JAX package
        folds it here (:2209-2211), which turns every empty row into key
        2^31 - 2 and leaves no row for a new key (ROADMAP Queue 3)."""
        found = self._key_store(tables, table_name)
        if found is None:
            return tables
        g, ks = found
        keys = np.asarray(keys)
        vocab = int(g.table_vocab[self._find_table(table_name)[1]])
        if keys.shape != (vocab,):
            raise ValueError(f"table {table_name}: expected key store shape {(vocab,)}, got {keys.shape}")
        self.import_table({g.name: ks}, table_name, torch.from_numpy(keys.astype(np.int32)))
        return tables

    # ------------------------------------------------ dynamic-table upkeep
    def _host_key_store(self, tables: Tables, g: GroupPlan) -> np.ndarray:
        """A host copy of the rank's key store of group `g` (its shard over
        f shards; collection.py:2282)."""
        return tables[f"{g.name}#keys"].to("cpu", copy=True).numpy()

    def _probe_np(self, g: GroupPlan, ti: int, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(int32 key as stored, owner shard, first probed row) of a dynamic
        table's keys on the host (collection.py:2297-2302)."""
        f = self._meta[g.name].num_shards
        k32 = fold_reserved_key(np.asarray(keys).reshape(-1).astype(np.int32))
        h = hash_mix_np(k32).astype(np.uint64)
        base = ((h // np.uint64(f)) % np.uint64(int(g.rows_per_shard[ti]))).astype(np.int64)
        return k32, (h % np.uint64(f)).astype(np.int64), base

    def _dynamic_host_slots(self, ks_host: np.ndarray, g: GroupPlan, ti: int, keys: np.ndarray) -> np.ndarray:
        """The rank's storage row of each key of dynamic table `ti` that its
        store holds, probing every one of the NUM_PROBES rows (evict punches
        holes); -1 where it holds it nowhere, a key of another shard
        included (collection.py:2292-2315; `_host_find_keys`, :2373, is the
        same probe)."""
        k32, owner, base = self._probe_np(g, ti, keys)
        rows_t, off = int(g.rows_per_shard[ti]), int(g.local_offsets[ti])
        mine = owner == self._meta[g.name].shard
        out = np.full(k32.shape, -1, dtype=np.int64)
        for j in range(NUM_PROBES):
            local = off + (base + j) % rows_t
            hit = (out < 0) & mine & (ks_host[local] == k32)
            out = np.where(hit, local, out)
        return out

    def _live_slots(self, ks_host: np.ndarray, g: GroupPlan, ti: int) -> Tuple[np.ndarray, np.ndarray]:
        """(the rank's storage rows, keys) of the keys its store holds for
        dynamic table `ti`, in row order (collection.py:2342)."""
        lo, rows_t = int(g.local_offsets[ti]), int(g.rows_per_shard[ti])
        idx = np.nonzero(ks_host[lo : lo + rows_t] != EMPTY_KEY)[0]
        return lo + idx, ks_host[lo + idx]

    def _collect_dynamic_entries(self, tables: Tables, opt_state, g: GroupPlan, ti: int):
        """(keys, rows, {state: rows}) of a dynamic table's resident entries
        on the rank, rows as host tensors of the storage's dtypes
        (collection.py:2360)."""
        slots, live = self._live_slots(self._host_key_store(tables, g), g, ti)
        idx = torch.as_tensor(slots, device=self.device)
        vals = tables[g.name][idx].cpu()
        st = {k: v[idx].cpu() for k, v in opt_state.get(g.name, {}).items()}
        return live, vals, st

    def _host_insert_keys(self, nks: np.ndarray, g: GroupPlan, ti: int, keys: np.ndarray) -> np.ndarray:
        """Place `keys` into the host store copy `nks` (in place) one by one,
        as the JAX package does (collection.py:2402-2436): a key already in
        one of its NUM_PROBES rows keeps that row, else it takes the first
        EMPTY one. Returns each key's storage row, -1 for a key dropped (no
        free row) or of another shard."""
        k32, owner, base = self._probe_np(g, ti, keys)
        rows_t, off = int(g.rows_per_shard[ti]), int(g.local_offsets[ti])
        shard = self._meta[g.name].shard
        placed = np.full(k32.shape, -1, dtype=np.int64)
        for i, (k, o, b0) in enumerate(zip(k32.tolist(), owner.tolist(), base.tolist())):
            if o != shard:
                continue
            slots = [off + (b0 + j) % rows_t for j in range(NUM_PROBES)]
            hit = next((r for r in slots if nks[r] == k), -1)
            if hit < 0:
                hit = next((r for r in slots if nks[r] == EMPTY_KEY), -1)
                if hit >= 0:
                    nks[hit] = k
            placed[i] = hit
        return placed

    def _scatter_all_replicas_multi(self, arrs, rows: np.ndarray, vals_list) -> None:
        """Set each of `vals_list` at the rank's storage `rows` of the
        row-aligned `arrs` (table, key store, state), in place
        (collection.py:2438-2482; every replica of a shard writes its own
        copy, since each gets the same rows)."""
        idx = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=self.device)
        with torch.no_grad():
            for a, v in zip(arrs, vals_list):
                a[idx] = torch.as_tensor(v).to(a.device, a.dtype)

    def _gather_rows_multi(self, arrs, rows: np.ndarray):
        """The `rows` of several row-aligned arrays as host tensors
        (collection.py:2484)."""
        idx = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=self.device)
        return tuple(a[idx].cpu() for a in arrs)

    def evict(self, tables: Tables, opt_state, table_name: str, keys):
        """Reset `keys` of a table, in place: the rows and their optimizer
        state become 0, and a dynamic table's store frees their rows, so the
        keys insert again (collection.py:2220-2281; DynamicEmbeddingTable::
        evict); a static table's rows are zeroed. A split table evicts per
        tier, each key from the tier whose window holds it. Over W ranks the
        rank evicts the keys of its shard (every rank calls this). Returns
        (tables, opt_state)."""
        k = np.asarray(keys).reshape(-1).astype(np.int64)
        if table_name in self.plan.table_splits:
            subs = self.plan.table_splits[table_name]
            for i, (sub, lo) in enumerate(subs):
                hi = subs[i + 1][1] if i + 1 < len(subs) else np.iinfo(np.int64).max
                self.evict(tables, opt_state, sub, k[(k >= lo) & (k < hi)] - lo)
            return tables, opt_state
        g, ti = self._find_table(table_name)
        meta = self._meta[g.name]
        if g.tables[ti].is_dynamic:
            return self._evict_dynamic_exact(tables, opt_state, g, ti, k)
        k32 = k.astype(np.int32).astype(np.int64) % int(g.table_vocab[ti])
        f = meta.num_shards
        mine = (k32 + int(g.table_rotation[ti]) % f) % f == meta.shard
        rows = int(g.local_offsets[ti]) + k32[mine] // f
        self._zero_rows(tables, opt_state, g, rows)
        return tables, opt_state

    def _zero_rows(self, tables: Tables, opt_state, g: GroupPlan, rows: np.ndarray) -> None:
        idx = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        with torch.no_grad():
            tables[g.name][idx] = 0
            for v in opt_state.get(g.name, {}).values():
                v[idx] = 0

    def _evict_dynamic_exact(self, tables: Tables, opt_state, g: GroupPlan, ti: int, keys: np.ndarray):
        """The rows the rank's store holds for `keys` (a host probe over all
        NUM_PROBES rows): table and state rows 0, store rows EMPTY
        (collection.py:2317-2340)."""
        slots = self._dynamic_host_slots(self._host_key_store(tables, g), g, ti, keys)
        slots = slots[slots >= 0]
        self._zero_rows(tables, opt_state, g, slots)
        tables[f"{g.name}#keys"][torch.as_tensor(slots, device=self.device)] = EMPTY_KEY
        return tables, opt_state

    def grow_dynamic_capacity(self, tables: Tables, opt_state, table_name: str, new_capacity: int):
        """Grow a dynamic table to `new_capacity` rows between steps
        (collection.py:2495-2667). Returns (new collection, its tables, its
        state): the plan is recompiled with the larger capacity (the same
        engine settings, strategy and shard counts), every static table's
        rows and state are copied by key, and every dynamic table's resident
        keys are re-inserted one by one into the new stores in row order
        (shard by shard), each carrying its row and state (a packed group's
        whole rows). Rows no key holds start from the new collection's init.
        The measured caps of the groups that remain carry over
        (collection.py:2593-2602). Over W ranks every rank calls this
        together."""
        g, ti = self._find_table(table_name)
        if not g.tables[ti].is_dynamic:
            raise ValueError(f"{table_name} is not a dynamic table")
        if new_capacity <= int(g.table_vocab[ti]):
            raise ValueError("new_capacity must exceed the current capacity")
        dyn_entries = {
            tt.name: self._collect_dynamic_entries(tables, opt_state, gg, tti)
            for gg in self.plan.groups for tti, tt in enumerate(gg.tables) if tt.is_dynamic
        }
        base = table_name.split("::", 1)[0]
        new_lookups = [
            dataclasses.replace(lk, table=dataclasses.replace(lk.table, dynamic_capacity=int(new_capacity)))
            if lk.table.name.split("::", 1)[0] == base else lk
            for lk in self.plan.lookups
        ]
        strategy, shard_counts = [], {}
        for gg in self.plan.groups:
            names = [t.name.split("::", 1)[0] for t in gg.tables]
            strategy.append(("mp" if gg.is_model_parallel else "dp", names))
            if gg.is_model_parallel:
                shard_counts.update(dict.fromkeys(names, gg.num_shards))
        options = dict(self.plan.options)
        column_factors = options.pop("column_factors", {})
        new_plan = compile_plan(new_lookups, ShardingPlan(strategy=strategy, column_factors=column_factors),
                                num_shards=self.plan.num_shards, shard_counts=shard_counts, **options)
        new_ec = EmbeddingCollection(new_plan, self.rm, self.opt, **self._settings)
        new_ec.frozen_tables = set(self.frozen_tables)
        new_ec.group_opt.update({k: v for k, v in self.group_opt.items() if k in new_ec.group_opt})
        for attr in ("unique_caps", "valid_caps", "dense_exchange_caps"):
            setattr(new_ec, attr, {k: v for k, v in getattr(self, attr).items() if k in new_ec.group_opt})
        new_ec.ucap_measured = self.ucap_measured
        new_tables = new_ec.init(torch.Generator(device=self.device).manual_seed(0))
        new_state = new_ec.init_optimizer(new_tables)
        for gg in self.plan.groups:
            for tt in gg.tables:
                if tt.is_dynamic:
                    continue
                new_ec.import_table(new_tables, tt.name, self.export_rows(tables, tt.name, full=True))
                ng, _nti = new_ec._find_table(tt.name)
                for slot, arr in opt_state.get(gg.name, {}).items():
                    new_ec.import_table({ng.name: new_state[ng.name][slot]}, tt.name,
                                        self.export_rows({gg.name: arr}, tt.name))
        for name, (live, vals, st) in dyn_entries.items():
            ng, nti = new_ec._find_table(name)
            nks = new_ec._host_key_store(new_tables, ng)
            placed = new_ec._host_insert_keys(nks, ng, nti, live)
            ok = placed >= 0
            okt = torch.from_numpy(ok)
            slots = list(new_state[ng.name])
            new_ec._scatter_all_replicas_multi(
                [new_tables[ng.name], new_tables[f"{ng.name}#keys"], *(new_state[ng.name][k] for k in slots)],
                placed[ok],
                [vals[okt], torch.from_numpy(fold_reserved_key(live[ok].astype(np.int32))),
                 *(st[k][okt] for k in slots)],
            )
        return new_ec, new_tables, new_state
