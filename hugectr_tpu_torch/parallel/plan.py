"""Embedding plan compiler (counterpart of hugectr_tpu/parallel/plan.py).

Turns table and lookup configs plus a shard strategy into static numpy
metadata: which tables share a storage array, which engine serves each
group, and where each lookup's slots and outputs sit. numpy only, as in the
JAX package. The engine thresholds are arguments (`Solver` fields) instead of
environment variables.

The hot/cold split (`_split_hot_cold`, plan.py:355) rewrites each big static
sum/mean table into sub-tables `name::shot|hot|warm|cold` over key windows
[key_lo, key_hi): the superhot prefix joins the one-hot group, the other
tiers are rowop groups of their own, and a `MergeMeta` sums the sub-lookups
back into the user's top. `table_splits` maps a split table to its
sub-tables and their first rows.

Left out: row-capped group binning (plan.py:468, off by default) and the
scatter-counts one-hot rule (plan.py:499, off by default).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.types import Combiner_t, TablePlacementStrategy


@dataclasses.dataclass
class EmbeddingTableConfig:
    """User-facing table config (plan.py:42). `max_vocabulary_size` -1 makes
    a dynamic table: an exact key store of `dynamic_capacity` rows whose
    rows are claimed on first touch (`EmbeddingCollection`)."""

    name: str
    max_vocabulary_size: int  # -1: dynamic
    ev_size: int
    opt_params: Optional[object] = None
    init_scale: Optional[float] = None
    dynamic_capacity: int = 2**22

    @property
    def is_dynamic(self) -> bool:
        return self.max_vocabulary_size is None or self.max_vocabulary_size < 0

    @property
    def vocabulary_size(self) -> int:
        return self.dynamic_capacity if self.is_dynamic else self.max_vocabulary_size


@dataclasses.dataclass
class LookupConfig:
    """One embedding lookup (plan.py:81)."""

    lookup_id: int
    table: EmbeddingTableConfig
    bottom_name: str
    top_name: str
    combiner: Combiner_t
    max_hotness: int
    # key window (plan.py:81): a key k takes part iff key_lo <= k < key_hi
    # (key_hi -1: no upper bound) and is looked up as k - key_shift; other
    # keys are padding for this lookup
    key_lo: int = 0
    key_hi: int = -1
    key_shift: int = 0

    @property
    def out_width(self) -> int:
        if self.combiner == Combiner_t.Concat:
            return self.max_hotness * self.table.ev_size
        return self.table.ev_size


@dataclasses.dataclass
class ShardingPlan:
    """Which tables are model-parallel and which data-parallel (plan.py:117)."""

    strategy: List[Tuple[str, List[str]]]

    def placement_of(self, table_name: str) -> TablePlacementStrategy:
        base = table_name.split("::", 1)[0]  # split sub-tables inherit
        for kind, names in self.strategy:
            if base in names:
                return TablePlacementStrategy(kind)
        return TablePlacementStrategy.ModelParallel


@dataclasses.dataclass
class LookupMeta:
    """Per-lookup static metadata inside a group (plan.py:139)."""

    lookup_id: int
    table_index: int
    combiner: Combiner_t
    hotness: int
    slot_begin: int
    slot_end: int
    out_begin: int
    out_end: int
    top_name: str
    bottom_name: str
    key_lo: int = 0
    key_hi: int = -1
    key_shift: int = 0

    @property
    def windowed(self) -> bool:
        return self.key_lo > 0 or self.key_hi >= 0 or self.key_shift != 0


@dataclasses.dataclass
class MergeMeta:
    """A split lookup's user top: the sum of its sub-lookups' tops; Mean
    divides by the count of the raw valid keys (plan.py:159)."""

    top_name: str
    sub_tops: List[str]
    combiner: Combiner_t
    bottom_name: str


@dataclasses.dataclass
class GroupPlan:
    """Static plan of one (placement, ev_size, compute_kind) group
    (plan.py:174). compute_kind is "onehot" (small tables, pooled lookup and
    scatter-add kernels) or "rowop" (any vocab, gather + sorted update)."""

    name: str
    placement: TablePlacementStrategy
    ev_size: int
    tables: List[EmbeddingTableConfig]
    lookups: List[LookupMeta]
    num_shards: int
    table_vocab: np.ndarray
    rows_per_shard: np.ndarray
    local_offsets: np.ndarray
    total_local_rows: int
    slot_table: np.ndarray
    slot_local_offset: np.ndarray
    slot_vocab: np.ndarray
    slot_is_dynamic: np.ndarray  # [H] slots of dynamic tables (plan.py:201)
    hotness_total: int
    out_width: int
    compute_kind: str = "rowop"
    mesh_size: int = 0

    def __post_init__(self):
        if not self.mesh_size:
            self.mesh_size = self.num_shards

    @property
    def is_model_parallel(self) -> bool:
        return self.placement == TablePlacementStrategy.ModelParallel

    @property
    def total_storage_rows(self) -> int:
        if self.is_model_parallel:
            return self.total_local_rows * self.mesh_size
        return self.total_local_rows

    @property
    def grad_src_slots(self) -> int:
        """Rows per sample in the compact gradient source: one per sum/mean
        lookup, hotness per concat lookup (plan.py:255)."""
        return sum(
            (lm.slot_end - lm.slot_begin) if lm.combiner == Combiner_t.Concat else 1
            for lm in self.lookups
        )


@dataclasses.dataclass
class CompiledEmbeddingPlan:
    groups: List[GroupPlan]
    lookups: List[LookupConfig]  # the user's lookups, before any split
    num_shards: int
    merges: List[MergeMeta] = dataclasses.field(default_factory=list)
    # split table -> [(sub-table name, its first row in the table)]
    table_splits: Dict[str, List[Tuple[str, int]]] = dataclasses.field(default_factory=dict)

    def group_of_lookup(self, lookup_id: int) -> Tuple[GroupPlan, LookupMeta]:
        for g in self.groups:
            for lm in g.lookups:
                if lm.lookup_id == lookup_id:
                    return g, lm
        raise KeyError(lookup_id)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _onehot_eligible(
    lookups: Sequence[LookupConfig], threshold: int
) -> Dict[str, bool]:
    """A static table takes the one-hot engine iff it is small
    (0 < vocab <= threshold) and every lookup into it pools (sum/mean, or
    concat with hotness 1) (plan.py:525); a dynamic table never does
    (plan.py:551)."""
    by_table: Dict[str, List[LookupConfig]] = {}
    for lk in lookups:
        by_table.setdefault(lk.table.name, []).append(lk)
    out: Dict[str, bool] = {}
    for name, lks in by_table.items():
        t = lks[0].table
        out[name] = (
            threshold > 0
            and not t.is_dynamic
            and 0 < t.vocabulary_size <= threshold
            and all(
                lk.combiner in (Combiner_t.Sum, Combiner_t.Mean)
                or (lk.combiner == Combiner_t.Concat and lk.max_hotness == 1)
                for lk in lks
            )
        )
    return out


def _split_hot_cold(
    lookups: Sequence[LookupConfig], hot: int, superhot: int, warm: int, onehot_vocab: int
) -> Tuple[List[LookupConfig], List[MergeMeta], Dict[str, List[Tuple[str, int]]]]:
    """Rewrite the lookups of eligible tables into sub-lookups, one per tier
    (plan.py:355). A table is eligible when it holds at least
    max(4 * hot, 2 * onehot_vocab) rows and every lookup into it is Sum or
    Mean; dynamic tables are never split (plan.py:368). Tiers: [0, superhot) when 0 < superhot < hot and superhot <=
    onehot_vocab, [superhot, hot), [hot, warm) when warm > hot, and the rest;
    tiers at or past the table's vocabulary are dropped. Sub-lookups sum;
    the first keeps the lookup's id, the others take new ids after the
    largest."""
    if not hot:
        return list(lookups), [], {}
    by_table: Dict[str, List[LookupConfig]] = {}
    for lk in lookups:
        by_table.setdefault(lk.table.name, []).append(lk)

    def eligible(t: EmbeddingTableConfig) -> bool:
        return not t.is_dynamic and t.vocabulary_size >= max(4 * hot, 2 * onehot_vocab) and all(
            lk.combiner in (Combiner_t.Sum, Combiner_t.Mean) for lk in by_table[t.name]
        )

    shot = superhot if 0 < superhot < hot and superhot <= onehot_vocab else 0
    bounds = [0, shot, hot] if shot else [0, hot]
    suffixes = ["shot", "hot", "cold"] if shot else ["hot", "cold"]
    if warm > hot:
        bounds.append(warm)
        suffixes.insert(-1, "warm")

    out: List[LookupConfig] = []
    merges: List[MergeMeta] = []
    splits: Dict[str, List[Tuple[str, int]]] = {}
    sub_tables: Dict[str, List[EmbeddingTableConfig]] = {}
    next_id = max(lk.lookup_id for lk in lookups) + 1 if lookups else 0
    for lk in lookups:
        t = lk.table
        if not eligible(t):
            out.append(lk)
            continue
        tiers = [(lo, sfx) for lo, sfx in zip(bounds, suffixes) if lo < t.vocabulary_size]
        his = [lo for lo, _ in tiers[1:]] + [t.vocabulary_size]
        if t.name not in sub_tables:
            sub_tables[t.name] = [
                dataclasses.replace(t, name=f"{t.name}::{sfx}", max_vocabulary_size=hi - lo)
                for (lo, sfx), hi in zip(tiers, his)
            ]
            splits[t.name] = [(s.name, lo) for s, (lo, _) in zip(sub_tables[t.name], tiers)]
        subs = [
            dataclasses.replace(
                lk, lookup_id=lk.lookup_id if i == 0 else next_id + i - 1, table=sub_t,
                top_name=f"{lk.top_name}::{sfx}", combiner=Combiner_t.Sum,
                key_lo=lo, key_hi=hi, key_shift=lo,
            )
            for i, (sub_t, (lo, sfx), hi) in enumerate(zip(sub_tables[t.name], tiers, his))
        ]
        next_id += len(subs) - 1
        out.extend(subs)
        merges.append(MergeMeta(lk.top_name, [s.top_name for s in subs], lk.combiner, lk.bottom_name))
    return out, merges, splits


def _shard_count_of(
    table: EmbeddingTableConfig, shard_counts: Optional[Dict[str, int]], num_shards: int
) -> int:
    """Per-table logical shard count (plan.py:566)."""
    if not shard_counts:
        return num_shards
    f = int(shard_counts.get(table.name.split("::", 1)[0], 0) or num_shards)
    f = max(1, min(f, num_shards))
    while num_shards % f:
        f += 1
    return f


def compile_plan(
    lookups: Sequence[LookupConfig],
    plan: ShardingPlan,
    num_shards: int,
    shard_counts: Optional[Dict[str, int]] = None,
    onehot_vocab: int = 8192,
    split_vocab: int = 256 * 1024,
    hot_rows: int = 0,
    superhot_rows: int = 0,
    warm_rows: int = 0,
) -> CompiledEmbeddingPlan:
    """Split the big tables into tiers (`hot_rows` > 0), then group lookups
    by (placement, ev_size, engine, private split, shard count) in
    first-appearance order and lay out each group's storage (plan.py:584)."""
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    orig_lookups = list(lookups)
    lookups, merges, table_splits = _split_hot_cold(
        orig_lookups, hot_rows, superhot_rows, warm_rows, onehot_vocab
    )
    eligible = _onehot_eligible(lookups, onehot_vocab)
    group_keys: List[Tuple] = []
    group_lookups: Dict[Tuple, List[LookupConfig]] = {}
    for lk in lookups:
        placement = plan.placement_of(lk.table.name)
        if placement == TablePlacementStrategy.DataParallel and lk.table.is_dynamic:
            raise ValueError(f"dynamic table {lk.table.name} cannot be data-parallel")
        if eligible[lk.table.name]:
            placement = TablePlacementStrategy.DataParallel
            kind, split, f = "onehot", "", 1
        else:
            kind = "rowop"
            split = (
                lk.table.name
                if split_vocab and lk.table.vocabulary_size >= split_vocab
                else ""
            )
            f = (
                _shard_count_of(lk.table, shard_counts, num_shards)
                if placement == TablePlacementStrategy.ModelParallel
                else 1
            )
        key = (placement, lk.table.ev_size, kind, split, f)
        if key not in group_lookups:
            group_lookups[key] = []
            group_keys.append(key)
        group_lookups[key].append(lk)

    groups: List[GroupPlan] = []
    for key in group_keys:
        placement, ev_size, kind, split, f = key
        lks = group_lookups[key]
        tables: List[EmbeddingTableConfig] = []
        table_index: Dict[str, int] = {}
        for lk in lks:
            if lk.table.name not in table_index:
                table_index[lk.table.name] = len(tables)
                tables.append(lk.table)
        mp = placement == TablePlacementStrategy.ModelParallel
        shards = f if mp else 1
        table_vocab = np.array([t.vocabulary_size for t in tables], dtype=np.int64)
        rows_per_shard = np.array(
            [_ceil_div(int(v), shards) for v in table_vocab], dtype=np.int64
        )
        local_offsets = np.zeros(len(tables), dtype=np.int64)
        if len(tables) > 1:
            local_offsets[1:] = np.cumsum(rows_per_shard[:-1])

        metas: List[LookupMeta] = []
        slot_table: List[int] = []
        slot_cursor = out_cursor = 0
        for lk in lks:
            ti = table_index[lk.table.name]
            metas.append(
                LookupMeta(
                    lookup_id=lk.lookup_id,
                    table_index=ti,
                    combiner=lk.combiner,
                    hotness=lk.max_hotness,
                    slot_begin=slot_cursor,
                    slot_end=slot_cursor + lk.max_hotness,
                    out_begin=out_cursor,
                    out_end=out_cursor + lk.out_width,
                    top_name=lk.top_name,
                    bottom_name=lk.bottom_name,
                    key_lo=lk.key_lo,
                    key_hi=lk.key_hi,
                    key_shift=lk.key_shift,
                )
            )
            slot_table.extend([ti] * lk.max_hotness)
            slot_cursor += lk.max_hotness
            out_cursor += lk.out_width
        slot_table_arr = np.array(slot_table, dtype=np.int32)
        if kind == "onehot":
            name = f"onehot_ev{ev_size}"
        else:
            name = (
                f"{placement.value}_ev{ev_size}"
                + (f"_{split}" if split else "")
                + (f"_x{f}" if mp and f != num_shards else "")
            )
        groups.append(
            GroupPlan(
                name=name,
                placement=placement,
                ev_size=ev_size,
                tables=tables,
                lookups=metas,
                num_shards=shards,
                mesh_size=num_shards if mp else shards,
                table_vocab=table_vocab,
                rows_per_shard=rows_per_shard,
                local_offsets=local_offsets,
                total_local_rows=int(rows_per_shard.sum()),
                slot_table=slot_table_arr,
                slot_local_offset=local_offsets[slot_table_arr].astype(np.int64),
                slot_vocab=table_vocab[slot_table_arr],
                slot_is_dynamic=np.array([tables[ti].is_dynamic for ti in slot_table_arr], dtype=bool),
                hotness_total=slot_cursor,
                out_width=out_cursor,
                compute_kind=kind,
            )
        )
    return CompiledEmbeddingPlan(
        groups=groups, lookups=orig_lookups, num_shards=num_shards, merges=merges,
        table_splits=table_splits,
    )
