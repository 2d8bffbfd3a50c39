"""Embedding plan compiler (counterpart of hugectr_tpu/parallel/plan.py).

Turns table and lookup configs plus a shard strategy into static numpy
metadata: which tables share a storage array, which engine serves each
group, and where each lookup's slots and outputs sit. numpy only, as in the
JAX package. The engine thresholds are arguments (`Solver` fields) instead of
environment variables.

Left out of this slice: the hot/cold/superhot split (plan.py:355, off by
default there), row-capped group binning (plan.py:468, off by default) and
the scatter-counts one-hot rule (plan.py:499, off by default).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.types import Combiner_t, TablePlacementStrategy


@dataclasses.dataclass
class EmbeddingTableConfig:
    """User-facing table config (plan.py:42)."""

    name: str
    max_vocabulary_size: int
    ev_size: int
    opt_params: Optional[object] = None
    init_scale: Optional[float] = None

    def __post_init__(self):
        if self.max_vocabulary_size is None or self.max_vocabulary_size < 0:
            raise NotImplementedError(
                f"table {self.name}: dynamic tables are not ported yet (ROADMAP Queue 1)"
            )

    @property
    def vocabulary_size(self) -> int:
        return self.max_vocabulary_size


@dataclasses.dataclass
class LookupConfig:
    """One embedding lookup (plan.py:81)."""

    lookup_id: int
    table: EmbeddingTableConfig
    bottom_name: str
    top_name: str
    combiner: Combiner_t
    max_hotness: int

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
        for kind, names in self.strategy:
            if table_name in names:
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
    lookups: List[LookupConfig]
    num_shards: int

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
    concat with hotness 1) (plan.py:525)."""
    by_table: Dict[str, List[LookupConfig]] = {}
    for lk in lookups:
        by_table.setdefault(lk.table.name, []).append(lk)
    out: Dict[str, bool] = {}
    for name, lks in by_table.items():
        t = lks[0].table
        out[name] = (
            threshold > 0
            and 0 < t.vocabulary_size <= threshold
            and all(
                lk.combiner in (Combiner_t.Sum, Combiner_t.Mean)
                or (lk.combiner == Combiner_t.Concat and lk.max_hotness == 1)
                for lk in lks
            )
        )
    return out


def _shard_count_of(
    table: EmbeddingTableConfig, shard_counts: Optional[Dict[str, int]], num_shards: int
) -> int:
    """Per-table logical shard count (plan.py:566)."""
    if not shard_counts:
        return num_shards
    f = int(shard_counts.get(table.name, 0) or num_shards)
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
) -> CompiledEmbeddingPlan:
    """Group lookups by (placement, ev_size, engine, private split, shard
    count) in first-appearance order and lay out each group's storage
    (plan.py:584)."""
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    lookups = list(lookups)
    eligible = _onehot_eligible(lookups, onehot_vocab)
    group_keys: List[Tuple] = []
    group_lookups: Dict[Tuple, List[LookupConfig]] = {}
    for lk in lookups:
        placement = plan.placement_of(lk.table.name)
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
                hotness_total=slot_cursor,
                out_width=out_cursor,
                compute_kind=kind,
            )
        )
    return CompiledEmbeddingPlan(groups=groups, lookups=lookups, num_shards=num_shards)
