"""Embedding training cache: a table bigger than the card kept in host
memory and trained one pass at a time (counterpart of
hugectr_tpu/embedding/training_cache.py; HugeCTR's EmbeddingTrainingCache,
include/embedding_training_cache/embedding_training_cache.hpp:26-70).

The master table (and, optionally, its optimizer state) lives on the host;
the model's table of the same name is the staging area, of
`max_vocabulary_size` = the most keys a pass may hold. Each pass stages its
keyset's rows into the device table (`update`), maps the batches' keys to
staged rows (`map_keys`, the KeysToIndices step on the host), trains, and
writes the trained rows back (`flush`).

    etc = EmbeddingTrainingCache(model, "table0", host_values, host_opt)
    for keyset, batches in passes:
        etc.update(keyset)
        for b in batches: ...train on etc.map_keys(b's keys)...
        etc.flush()
    etc.dump("table0.npy")
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core.logger import get_logger

logger = get_logger()


class EmbeddingTrainingCache:
    def __init__(self, model, table_name: str, host_values: np.ndarray,
                 host_opt_state: Optional[Dict[str, np.ndarray]] = None):
        """`model`: a compiled Model whose collection holds `table_name`,
        its vocabulary the staging capacity; `host_values` [V_huge, ev] the
        host master (a np.memmap will do); `host_opt_state` {slot: [V_huge,
        width]} its optimizer state, staged beside the rows."""
        self.model = model
        self.table_name = table_name
        self.host = host_values
        self.host_opt = host_opt_state or {}
        g, ti = model.ec._find_table(table_name)
        self.capacity = int(g.table_vocab[ti])
        self.ev = g.ev_size
        if host_values.shape[1] != self.ev:
            raise ValueError(f"host table ev {host_values.shape[1]} != device ev {self.ev}")
        self._keyset: Optional[np.ndarray] = None  # the staged keys, sorted

    def _gname(self) -> str:
        return self.model.ec._find_table(self.table_name)[0].name

    def update(self, keyset: np.ndarray) -> None:
        """Stage the rows of `keyset` (keys outside the master dropped; the
        previous pass flushed first): staged row i holds the i-th smallest
        key, the rows past the keyset are zero (training_cache.py:64)."""
        keys = np.unique(np.asarray(keyset).ravel())
        keys = keys[(keys >= 0) & (keys < self.host.shape[0])]
        if len(keys) > self.capacity:
            raise ValueError(f"pass keyset size {len(keys)} exceeds staging capacity {self.capacity}: raise "
                             "max_vocabulary_size or split passes")
        if self._keyset is not None:
            self.flush()
        ec = self.model.ec
        staged = np.zeros((self.capacity, self.ev), self.host.dtype)
        staged[: len(keys)] = self.host[keys]
        ec.import_table(self.model.tables, self.table_name, staged)
        st = self.model.eopt.get(self._gname(), {})
        for slot, arr in self.host_opt.items():
            if slot in st:
                staged_s = np.zeros((self.capacity, arr.shape[1]), arr.dtype)
                staged_s[: len(keys)] = arr[keys]
                ec.import_table({self._gname(): st[slot]}, self.table_name, staged_s)
        self._keyset = keys
        logger.info(f"ETC staged {len(keys)} rows of {self.table_name} (capacity {self.capacity})")

    def map_keys(self, raw_keys: np.ndarray) -> np.ndarray:
        """Master keys -> staged rows, -1 (padding) for a key not staged
        (training_cache.py:103)."""
        if self._keyset is None:
            raise RuntimeError("call update(keyset) first")
        pos = np.clip(np.searchsorted(self._keyset, raw_keys), 0, len(self._keyset) - 1)
        hit = self._keyset[pos] == raw_keys
        return np.where(hit & (raw_keys >= 0), pos, -1).astype(raw_keys.dtype)

    def flush(self) -> None:
        """Write the staged rows (and state) back to the master
        (training_cache.py:114)."""
        if self._keyset is None:
            return
        ec = self.model.ec
        n = len(self._keyset)
        self.host[self._keyset] = ec.export_table(self.model.tables, self.table_name)[:n]
        st = self.model.eopt.get(self._gname(), {})
        for slot, arr in self.host_opt.items():
            if slot in st:
                arr[self._keyset] = ec.export_table({self._gname(): st[slot]}, self.table_name)[:n]

    def get_incremental_model(self) -> Dict[str, np.ndarray]:
        """The current pass's keys and their master rows, after a flush
        (training_cache.py:133)."""
        self.flush()
        if self._keyset is None:
            return {"keys": np.zeros(0, np.int64), "values": np.zeros((0, self.ev))}
        return {"keys": self._keyset, "values": self.host[self._keyset]}

    def dump(self, path: str) -> None:
        """Flush, then `np.save` the master."""
        self.flush()
        np.save(path, self.host)
