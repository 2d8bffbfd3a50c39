"""User-facing embedding configuration (counterpart of
hugectr_tpu/embedding/config.py): `EmbeddingTableConfig`,
`EmbeddingCollectionConfig` and the legacy `SparseEmbedding`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..core.types import Combiner_t, CommunicationStrategy
from ..parallel.plan import EmbeddingTableConfig, LookupConfig, ShardingPlan

__all__ = ["EmbeddingTableConfig", "EmbeddingCollectionConfig", "SparseEmbedding", "Embedding_t"]


class Embedding_t:
    """Legacy embedding kinds (config.py:27-31)."""

    DistributedSlotSparseEmbeddingHash = "DistributedSlotSparseEmbeddingHash"
    LocalizedSlotSparseEmbeddingHash = "LocalizedSlotSparseEmbeddingHash"


def _as_list(x, n: Optional[int] = None) -> List:
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x] * (n or 1)


@dataclasses.dataclass
class _LookupDecl:
    table: EmbeddingTableConfig
    bottom_name: str
    top_name: str
    combiner: Combiner_t
    sp_weight_name: str = ""  # the per-key weight feature ("" = unweighted)


class EmbeddingCollectionConfig:
    """`ebc.embedding_lookup(...)`; `ebc.shard(...)` (config.py:49).
    `comm_strategy` Hierarchical takes the two-level exchange on a
    hierarchical mesh (`EmbeddingCollection`); elsewhere it is Uniform's."""

    def __init__(self, comm_strategy: CommunicationStrategy = CommunicationStrategy.Uniform):
        self.comm_strategy = CommunicationStrategy(comm_strategy or CommunicationStrategy.Uniform)
        self.lookup_decls: List[_LookupDecl] = []
        self.shard_matrix: Optional[List[List[str]]] = None
        self.shard_strategy: Optional[List[Tuple[str, List[str]]]] = None
        self.column_factors: Dict[str, int] = {}

    def embedding_lookup(
        self,
        table_config: Union[EmbeddingTableConfig, Sequence[EmbeddingTableConfig]],
        bottom_name: Union[str, Sequence[str]],
        top_name: Union[str, Sequence[str]],
        combiner: Union[str, Sequence[str]],
        sp_weight_name: Union[str, Sequence[str]] = "",
    ) -> None:
        """List arguments broadcast; one `top_name` shared by N lookups gives
        one batch-major concatenated output (config.py:65). `sp_weight_name`
        names a [batch, hotness] float feature of per-key weights: Sum pools
        sum(w * row), Mean divides by sum(w), the row gradients scale by w;
        "" is unweighted (config.py:71-105)."""
        tables = _as_list(table_config)
        n = len(tables)
        bottoms = _as_list(bottom_name, n)
        tops = _as_list(top_name, n)
        combs = _as_list(combiner, n)
        wnames = _as_list(sp_weight_name, n)
        if len(tops) == 1:
            tops = tops * n
        if len(combs) == 1:
            combs = combs * n
        if len(wnames) == 1:
            wnames = wnames * n
        if not len(bottoms) == len(tops) == len(combs) == len(wnames) == n:
            raise ValueError("embedding_lookup: inconsistent list lengths")
        for t, b, tp, c, w in zip(tables, bottoms, tops, combs, wnames):
            self.lookup_decls.append(_LookupDecl(t, b, tp, Combiner_t(c), w or ""))

    def shard(
        self,
        shard_matrix: Sequence[Sequence[str]],
        shard_strategy: Sequence[Tuple[str, Sequence[str]]],
        column_factors: Optional[Dict[str, int]] = None,
        compression_strategy=None,
    ) -> None:
        """`column_factors` ({table: f}) splits table t into f sub-tables
        `t#col{j}` of ev / f columns each (`Model.compile`; config.py:109-173).
        `compression_strategy` ({CompressionStrategy: [tables]}) is
        accepted for parity and not read, as in the JAX package
        (embedding/config.py:109-136)."""
        self.compression_strategy = compression_strategy
        self.column_factors = dict(column_factors or {})
        self.shard_matrix = [list(r) for r in shard_matrix]
        self.shard_strategy = [(k, list(v)) for k, v in shard_strategy]
        dp_tables = {n for kind, names in self.shard_strategy if kind == "dp" for n in names}
        for name in dp_tables:
            for row in self.shard_matrix:
                if name not in row:
                    raise ValueError(
                        f"DP table {name!r} must be present on every device row of shard_matrix"
                    )

    def build_lookup_configs(self) -> List[LookupConfig]:
        """One `LookupConfig` per declared lookup, top `"{top}:{i}"`, hotness
        1 until the Model sets the input's (config.py:149-166)."""
        return [
            LookupConfig(lookup_id=i, table=d.table, bottom_name=d.bottom_name, top_name=f"{d.top_name}:{i}",
                         combiner=d.combiner, max_hotness=1, sp_weight_name=d.sp_weight_name)
            for i, d in enumerate(self.lookup_decls)
        ]

    def sharding_plan(self) -> ShardingPlan:
        return ShardingPlan(strategy=[(k, v) for k, v in (self.shard_strategy or [])],
                            column_factors=dict(self.column_factors))


@dataclasses.dataclass
class SparseEmbedding:
    """The legacy embedding declaration (config.py:185-215). `Model.compile`
    lowers it onto the collection as the JAX package does: one table
    `sparse_table_<name>` with one lookup per slot, model-parallel, and a
    [batch, slots, ev] top. The distributed and localized kinds differ only
    in how the reference's GPUs partition rows; both lower alike."""

    embedding_type: str
    workspace_size_per_gpu_in_mb: int
    embedding_vec_size: int
    combiner: str
    sparse_embedding_name: str
    bottom_name: str
    optimizer: Optional[object] = None  # OptParams of the table
    slot_size_array: List[int] = dataclasses.field(default_factory=list)
    max_vocabulary_size: int = 0  # an explicit vocabulary

    def vocabulary_for(self, num_devices: int) -> int:
        """The table's rows: `max_vocabulary_size`, else the sum of
        `slot_size_array`, else the workspace of `num_devices` devices at
        four bytes an element."""
        if self.max_vocabulary_size > 0:
            return self.max_vocabulary_size
        if self.slot_size_array:
            return int(sum(self.slot_size_array))
        bytes_total = self.workspace_size_per_gpu_in_mb * (1 << 20) * num_devices
        return max(bytes_total // (4 * self.embedding_vec_size), 1)
