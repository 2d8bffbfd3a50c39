"""User-facing embedding configuration (counterpart of
hugectr_tpu/embedding/config.py): `EmbeddingTableConfig`,
`EmbeddingCollectionConfig` and the legacy `SparseEmbedding`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

from ..core.types import Combiner_t, CommunicationStrategy
from ..parallel.plan import EmbeddingTableConfig, ShardingPlan

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


class EmbeddingCollectionConfig:
    """`ebc.embedding_lookup(...)`; `ebc.shard(...)` (config.py:49)."""

    def __init__(self, comm_strategy: CommunicationStrategy = CommunicationStrategy.Uniform):
        if CommunicationStrategy(comm_strategy) != CommunicationStrategy.Uniform:
            raise NotImplementedError(
                "hierarchical communication is not ported yet (ROADMAP Queue 1 item 1g)"
            )
        self.comm_strategy = CommunicationStrategy.Uniform
        self.lookup_decls: List[_LookupDecl] = []
        self.shard_matrix: Optional[List[List[str]]] = None
        self.shard_strategy: Optional[List[Tuple[str, List[str]]]] = None

    def embedding_lookup(
        self,
        table_config: Union[EmbeddingTableConfig, Sequence[EmbeddingTableConfig]],
        bottom_name: Union[str, Sequence[str]],
        top_name: Union[str, Sequence[str]],
        combiner: Union[str, Sequence[str]],
        sp_weight_name: Union[str, Sequence[str]] = "",
    ) -> None:
        """List arguments broadcast; one `top_name` shared by N lookups gives
        one batch-major concatenated output (config.py:65)."""
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
            if w:
                raise NotImplementedError(
                    "weighted lookups are not ported yet (ROADMAP Queue 1)"
                )
            self.lookup_decls.append(_LookupDecl(t, b, tp, Combiner_t(c)))

    def shard(
        self,
        shard_matrix: Sequence[Sequence[str]],
        shard_strategy: Sequence[Tuple[str, Sequence[str]]],
        compression_strategy=None,
    ) -> None:
        """`compression_strategy` ({CompressionStrategy: [tables]}) is
        accepted for parity and not read, as in the JAX package
        (embedding/config.py:109-136)."""
        self.compression_strategy = compression_strategy
        self.shard_matrix = [list(r) for r in shard_matrix]
        self.shard_strategy = [(k, list(v)) for k, v in shard_strategy]
        dp_tables = {n for kind, names in self.shard_strategy if kind == "dp" for n in names}
        for name in dp_tables:
            for row in self.shard_matrix:
                if name not in row:
                    raise ValueError(
                        f"DP table {name!r} must be present on every device row of shard_matrix"
                    )

    def sharding_plan(self) -> ShardingPlan:
        return ShardingPlan(strategy=[(k, v) for k, v in (self.shard_strategy or [])])


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
