"""Host-spill tier under a dynamic table (counterpart of
hugectr_tpu/embedding/host_spill.py; HugeCTR's HierarchicalKV host tier and
the embedding training cache's staged host parameter server).

The model's dynamic table (the exact key store of `dynamic_capacity` rows on
the device) is backed by a growing master in host memory. Between steps
`stage_batch(keys)` brings the master's rows of a batch's keys into the
device working set, and when the working set would pass its watermark it
first spills the least recently used share of it to the master: their rows
and optimizer state are read back and the keys evicted from the device.

- The residency mirror: a sorted array of the keys taken to be on the device
  with a last-use stamp each, merged with every batch's keys on the host.
  Staging reads nothing back from the device on the steady path (fresh keys,
  resident keys); the device's key store is read back at a spill, at a
  resync (every `resync_interval` batches, since a key that the insert on
  the backward could not place is taken as resident until then) and when
  master rows are staged (their free rows come from the store, as in the
  JAX package).
- The host master: an open-addressed int64 -> row map (`_NpMap`, batched
  linear probing) over float32 value and state arrays that grow by
  doubling; rows are never freed.
- LRU subset eviction: `spill(evict_frac)` moves only the least recently
  used share of the working set. The master keeps the values a key had when
  it was evicted: a key still resident trains on, and its master row is
  stale until its next eviction; read live values through the model.

The device writes and reads go through the collection's host helpers
(`_host_insert_keys`, `_scatter_all_replicas_multi`, `_gather_rows_multi`,
`evict`). The JAX package pads each staging's rows to a power of two so that
its jitted scatters compile once a size; the port runs eagerly and stages
the rows as they are.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core.logger import get_logger
from .collection import fold_reserved_key

logger = get_logger()

_MIX = np.uint64(0x9E3779B97F4A7C15)


class _NpMap:
    """Open-addressed int64 -> int32 row map with append-only rows
    (host_spill.py:72)."""

    def __init__(self, cap: int = 4096):
        cap = 1 << int(np.ceil(np.log2(max(cap, 1024))))
        self._keys = np.full(cap, -1, np.int64)
        self._rows = np.full(cap, -1, np.int32)
        self.size = 0

    def _slots(self, keys: np.ndarray) -> np.ndarray:
        h = keys.astype(np.uint64) * _MIX
        return ((h >> np.uint64(33)) % np.uint64(self._keys.size)).astype(np.int64)

    def _grow(self) -> None:
        old_k, old_r = self._keys, self._rows
        self._keys = np.full(old_k.size * 2, -1, np.int64)
        self._rows = np.full(old_k.size * 2, -1, np.int32)
        live = old_k >= 0
        self.size = 0
        self._insert(old_k[live], old_r[live])

    def _insert(self, keys: np.ndarray, rows: np.ndarray) -> None:
        # grow first: more keys than free slots would probe forever
        while self.size + keys.size > 0.7 * self._keys.size:
            self._grow()
        slot = self._slots(keys)
        pending = np.arange(keys.size)
        cap = self._keys.size
        while pending.size:
            s = slot[pending]
            empty = self._keys[s] == -1
            same = self._keys[s] == keys[pending]
            # the first of the batch's keys to want an empty slot takes it
            claim_idx = pending[empty]
            uniq_s, first = np.unique(s[empty], return_index=True)
            self._keys[uniq_s] = keys[claim_idx[first]]
            self._rows[uniq_s] = rows[claim_idx[first]]
            self.size += uniq_s.size
            done = (self._keys[slot[pending]] == keys[pending]) | same
            pending = pending[~done]
            slot[pending] = (slot[pending] + 1) % cap

    def get(self, keys: np.ndarray) -> np.ndarray:
        """Rows of `keys`, -1 where absent."""
        out = np.full(keys.size, -1, np.int32)
        if not keys.size:
            return out
        slot = self._slots(keys)
        pending = np.arange(keys.size)
        cap = self._keys.size
        while pending.size:
            s = slot[pending]
            k_at = self._keys[s]
            hit = k_at == keys[pending]
            out[pending[hit]] = self._rows[s[hit]]
            pending = pending[~hit & (k_at != -1)]
            slot[pending] = (slot[pending] + 1) % cap
        return out

    def upsert(self, keys: np.ndarray, next_row: int):
        """(rows of `keys`, the next free row): absent keys take new rows
        from `next_row` on, one a distinct key."""
        keys = np.asarray(keys, np.int64)
        rows = self.get(keys)
        fresh = rows < 0
        if fresh.any():
            uq = np.unique(keys[fresh])
            self._insert(uq, (next_row + np.arange(uq.size)).astype(np.int32))
            next_row += uq.size
            rows = self.get(keys)
        return rows, next_row


class HostSpillTier:
    """A host master under `model`'s dynamic table `table_name`
    (host_spill.py:158). `spill_watermark` is the share of the table's
    capacity the working set may fill before a staging spills,
    `evict_frac` the share a spill evicts, `resync_interval` the batches
    between two readbacks of the device's store."""

    def __init__(self, model, table_name: str, spill_watermark: float = 0.75, evict_frac: float = 0.5,
                 resync_interval: int = 64):
        g, ti = model.ec._find_table(table_name)
        if not g.tables[ti].is_dynamic:
            raise ValueError(f"{table_name} is not a dynamic table: the host-spill tier needs the exact key store "
                             "(max_vocabulary_size=-1)")
        if f"{g.name}#keys" not in model.tables:
            raise ValueError(f"{table_name}: dynamic key store missing")
        self.model = model
        self.table_name = table_name
        self.spill_watermark = float(spill_watermark)
        self.evict_frac = float(evict_frac)
        self.resync_interval = int(resync_interval)
        self.ev = g.ev_size
        self._host_values: Optional[np.ndarray] = None
        self._host_opt: Dict[str, np.ndarray] = {}
        self._host_map = _NpMap()
        self._host_next = 0
        # residency mirror: sorted resident keys and their last-use stamps
        self._resident = np.zeros(0, np.int64)
        self._lastuse = np.zeros(0, np.int64)
        self._clock = 0
        self._since_resync = 0
        self._mirror_resync()  # the model may hold a working set already

    # ------------------------------------------------------------- helpers
    def _ec(self):
        return self.model.ec

    def _g_ti(self):
        return self._ec()._find_table(self.table_name)

    def _device_resident(self) -> np.ndarray:
        """The keys the device's store holds (a readback of the store: at a
        spill or a resync only)."""
        ec = self._ec()
        g, ti = self._g_ti()
        return ec._live_slots(ec._host_key_store(self.model.tables, g), g, ti)[1]

    def _mirror_resync(self) -> None:
        actual = np.unique(self._device_resident().astype(np.int64))
        pos = np.clip(np.searchsorted(self._resident, actual), 0, max(self._resident.size - 1, 0))
        known = self._resident[pos] == actual if self._resident.size else np.zeros(actual.size, bool)
        stamps = np.full(actual.size, self._clock, np.int64)
        if self._resident.size:
            stamps[known] = self._lastuse[pos[known]]
        self._resident, self._lastuse = actual, stamps
        self._since_resync = 0

    def _mirror_touch(self, keys: np.ndarray) -> None:
        """Merge a batch's keys into the mirror at the current stamp."""
        self._clock += 1
        if not keys.size:
            return
        merged = np.union1d(self._resident, keys)
        stamps = np.zeros(merged.size, np.int64)
        if self._resident.size:
            stamps[np.searchsorted(merged, self._resident)] = self._lastuse
        stamps[np.searchsorted(merged, keys)] = self._clock
        self._resident, self._lastuse = merged, stamps

    def _host_upsert(self, keys, vals: np.ndarray, st: Dict[str, np.ndarray]) -> None:
        keys = np.asarray(keys, np.int64)
        if self._host_values is None:
            cap = max(1024, 2 * keys.size)
            self._host_values = np.zeros((cap, self.ev), np.float32)
            self._host_opt = {slot: np.zeros((cap, a.shape[1]), np.float32) for slot, a in st.items()}
        rows, self._host_next = self._host_map.upsert(keys, self._host_next)
        cap = self._host_values.shape[0]
        if self._host_next > cap:
            new_cap = max(2 * cap, self._host_next)
            self._host_values = np.resize(self._host_values, (new_cap, self.ev))
            self._host_values[cap:] = 0.0
            for slot in self._host_opt:
                w = self._host_opt[slot].shape[1]
                self._host_opt[slot] = np.resize(self._host_opt[slot], (new_cap, w))
                self._host_opt[slot][cap:] = 0.0
        self._host_values[rows] = vals
        for slot, a in st.items():
            self._host_opt[slot][rows] = a

    # ------------------------------------------------------------------ API
    def spill(self, evict_frac: Optional[float] = None, max_keep: Optional[int] = None) -> int:
        """Evict the least recently used `evict_frac` share of the working
        set (keys the mirror does not know count as oldest), at most
        `max_keep` keys staying: their rows and state go to the master
        (float32), then `evict` frees their store rows (host_spill.py:267).
        Returns the count evicted."""
        ec = self._ec()
        g, ti = self._g_ti()
        frac = self.evict_frac if evict_frac is None else float(evict_frac)
        slots, live = ec._live_slots(ec._host_key_store(self.model.tables, g), g, ti)
        if not len(live):
            return 0
        live64 = live.astype(np.int64)
        stamps = np.zeros(live64.size, np.int64)
        if self._resident.size:
            pos = np.clip(np.searchsorted(self._resident, live64), 0, self._resident.size - 1)
            hit = self._resident[pos] == live64
            stamps[hit] = self._lastuse[pos[hit]]
        n_evict = int(np.ceil(frac * live64.size))
        if max_keep is not None:
            n_evict = max(n_evict, live64.size - max(int(max_keep), 0))
        n_evict = min(n_evict, live64.size)
        order = np.argsort(stamps, kind="stable")[:n_evict]
        evict_keys = live[order]
        opt_items = list(self.model.eopt.get(g.name, {}).items())
        got = ec._gather_rows_multi([self.model.tables[g.name]] + [v for _k, v in opt_items], slots[order])
        vals = got[0].float().numpy()
        st = {k: a.float().numpy() for (k, _v), a in zip(opt_items, got[1:])}
        self._host_upsert(evict_keys, vals, st)
        ec.evict(self.model.tables, self.model.eopt, self.table_name, evict_keys)
        mask = np.ones(live64.size, bool)
        mask[order] = False
        surv, surv_st = live64[mask], stamps[mask]
        o2 = np.argsort(surv)
        self._resident, self._lastuse = surv[o2], surv_st[o2]
        self._since_resync = 0
        return int(evict_keys.size)

    def stage_batch(self, keys: np.ndarray) -> int:
        """Bring the master's rows of this batch's keys (raw keys of the
        table's feature) into the device working set, spilling first under
        watermark pressure (host_spill.py:340). Call between steps. Returns
        the rows staged."""
        ec = self._ec()
        g, ti = self._g_ti()
        keys = np.asarray(keys).reshape(-1)
        if getattr(self.model.solver, "i64_input_key", False):
            # the store and the master hold the exact fold's int31 ids
            base = self.table_name.split("::", 1)[0]
            keys = self.model._i64_exact_fold(base, keys.astype(np.int64).reshape(-1, 1)).reshape(-1)
        uniq = np.unique(keys[keys >= 0]).astype(np.int64)
        if not uniq.size:
            return 0
        if self._since_resync >= self.resync_interval:
            self._mirror_resync()
        self._since_resync += 1

        def plan():
            if self._resident.size:
                pos = np.clip(np.searchsorted(self._resident, uniq), 0, self._resident.size - 1)
                nonres = self._resident[pos] != uniq
            else:
                nonres = np.ones(uniq.size, bool)
            cand = uniq[nonres]
            host_rows = self._host_map.get(cand)
            return cand[host_rows >= 0], int((host_rows < 0).sum())

        want, fresh = plan()
        cap = int(g.table_vocab[ti])
        if self._resident.size + want.size + fresh > self.spill_watermark * cap:
            # keep free rows for the incoming keys (a near-full store drops inserts)
            self.spill(max_keep=int(self.spill_watermark * cap) - (int(want.size) + fresh))
            want, fresh = plan()
        if not want.size:
            self._mirror_touch(uniq)
            return 0
        nks = ec._host_key_store(self.model.tables, g)
        placed = ec._host_insert_keys(nks, g, ti, want.astype(np.int32))
        if (placed < 0).any():
            # probe clustering: spill and try once more, since a wanted key
            # left out would be restarted by the insert on the backward
            self.spill()
            want, fresh = plan()  # the batch's spilled keys join `want`
            if not want.size:
                self._mirror_touch(uniq)
                return 0
            nks = ec._host_key_store(self.model.tables, g)
            placed = ec._host_insert_keys(nks, g, ti, want.astype(np.int32))
            if (placed < 0).any():
                dropped = want[placed < 0]
                logger.warning(f"host-spill: {dropped.size} key(s) unplaceable after spill (e.g. "
                               f"{dropped[:4].tolist()}): the insert on the backward restarts their rows; "
                               "raise dynamic_capacity")
        rows = self._host_map.get(want)
        ok = (placed >= 0) & (rows >= 0)
        dst = placed[ok]
        if not len(dst):
            self._mirror_touch(uniq)
            return 0
        store_vals = fold_reserved_key(want.astype(np.int32)[ok])
        opt_slots = [s for s in self.model.eopt.get(g.name, {}) if s in self._host_opt]
        ec._scatter_all_replicas_multi(
            [self.model.tables[g.name], self.model.tables[f"{g.name}#keys"]]
            + [self.model.eopt[g.name][s] for s in opt_slots],
            dst, [self._host_values[rows[ok]], store_vals] + [self._host_opt[s][rows[ok]] for s in opt_slots])
        self._mirror_touch(uniq)
        return int(ok.sum())

    @property
    def host_size(self) -> int:
        """Keys in the host master."""
        return int(self._host_map.size)

    def lookup_host(self, key: int) -> Optional[np.ndarray]:
        """The master's row of `key` (None if it was never spilled)."""
        row = int(self._host_map.get(np.asarray([key], np.int64))[0])
        return None if row < 0 else self._host_values[row].copy()
