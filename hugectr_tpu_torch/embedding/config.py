"""User-facing embedding configuration (counterpart of
hugectr_tpu/embedding/config.py): `EmbeddingTableConfig` and
`EmbeddingCollectionConfig`. The legacy `SparseEmbedding` waits for a later
slice.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

from ..core.types import Combiner_t, CommunicationStrategy
from ..parallel.plan import EmbeddingTableConfig, ShardingPlan

__all__ = ["EmbeddingTableConfig", "EmbeddingCollectionConfig"]


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
    ) -> None:
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
