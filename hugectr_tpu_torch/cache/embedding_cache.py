"""Device-resident embedding cache (counterpart of
hugectr_tpu/cache/embedding_cache.py, the analog of the reference's
gpu_cache): a set-associative LRU cache whose state lives in tensors on the
device, a static open-addressing table, and a host-backed table with the
cache in front.

State for capacity = num_sets x ways:
  tags   [num_sets, ways] int64  (EMPTY = -1)
  values [num_sets, ways, ev]
  stamps [num_sets, ways] int32  (LRU clock; larger = more recent)
  clock  []               int32

The set of a key is the murmur3 finaliser of its low 32 bits modulo
num_sets, in uint32 arithmetic with wrap-around: torch has no uint32
arithmetic, so it runs in int64 with `& 0xFFFFFFFF` after each step (the
low 32 bits of an int64 product are those of the uint32 product).

Each call is vectorised as the JAX package's: every key finds its way in
the state before the call. A hit takes its first matching way; a miss in
`replace` takes the way with the smallest stamp (the first of equals).
Where several keys of one call write the same (set, way) — one key twice,
or two keys that miss in one set — the last of them in the call's order
wins, as XLA's scatter leaves it on the CPU (`.at[].set` in index order);
`query` raises the stamp of every hit way to the call's clock (a scatter
max). So the state comes out bitwise the JAX package's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core.mesh import DeviceLike, resolve_device

EMPTY = -1
_M32 = 0xFFFFFFFF


def _hash_set(keys: torch.Tensor, num_sets: int) -> torch.Tensor:
    k = keys.long() & _M32
    k = k ^ (k >> 16)
    k = (k * 0x85EBCA6B) & _M32
    k = k ^ (k >> 13)
    return k % num_sets


def _last_writer(flat: torch.Tensor, slots: int) -> torch.Tensor:
    """Mask of the entries of `flat` (slot ids) that are the last in the
    call to write their slot."""
    pos = torch.arange(flat.numel(), device=flat.device)
    last = torch.full((slots,), -1, dtype=torch.int64, device=flat.device)
    last.scatter_reduce_(0, flat, pos, reduce="amax")
    return last[flat] == pos


class EmbeddingCache:
    """Set-associative LRU cache: `init`, `query`, `replace`, `update`
    (gpu_cache_api.hpp's surface), each taking and returning the state."""

    def __init__(self, num_sets: int, ways: int, ev: int, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        self.num_sets, self.ways, self.ev, self.dtype = num_sets, ways, ev, dtype
        self.device = resolve_device(device)

    def init(self) -> Dict[str, torch.Tensor]:
        s, w, dev = self.num_sets, self.ways, self.device
        return {
            "tags": torch.full((s, w), EMPTY, dtype=torch.int64, device=dev),
            "values": torch.zeros((s, w, self.ev), dtype=self.dtype, device=dev),
            "stamps": torch.zeros((s, w), dtype=torch.int32, device=dev),
            "clock": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def _find(self, state, keys: torch.Tensor):
        keys = keys.reshape(-1).long().to(self.device)
        sets = _hash_set(keys, self.num_sets)
        match = state["tags"][sets] == keys[:, None]
        return keys, sets, match.any(dim=1), match.int().argmax(dim=1)

    def query(self, state, keys) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """[N] keys -> (values [N, ev], hit [N] bool, new state); hits
        refresh their way's stamp."""
        keys, sets, hit, way = self._find(state, keys)
        vals = torch.where(hit[:, None], state["values"][sets, way], torch.zeros((), dtype=self.dtype,
                                                                                   device=self.device))
        clock = state["clock"] + 1
        stamp = torch.where(hit, clock, torch.zeros_like(clock)).to(torch.int32)
        stamps = state["stamps"].reshape(-1).scatter_reduce(0, sets * self.ways + way, stamp, reduce="amax")
        return vals, hit, {**state, "stamps": stamps.view(self.num_sets, self.ways), "clock": clock}

    def replace(self, state, keys, values) -> Dict[str, torch.Tensor]:
        """Insert or refresh key/value pairs, a miss evicting its set's LRU
        way."""
        keys, sets, hit, hit_way = self._find(state, keys)
        lru_way = state["stamps"][sets].argmin(dim=1)
        way = torch.where(hit, hit_way, lru_way)
        clock = state["clock"] + 1
        flat = sets * self.ways + way
        win = _last_writer(flat, self.num_sets * self.ways)
        flat, keys = flat[win], keys[win]
        values = values.to(device=self.device, dtype=self.dtype)[win]
        tags = state["tags"].reshape(-1).index_put((flat,), keys)
        vals = state["values"].reshape(-1, self.ev).index_put((flat,), values)
        stamps = state["stamps"].reshape(-1).index_put((flat,), clock.expand(flat.numel()).to(torch.int32))
        shape = (self.num_sets, self.ways)
        return {"tags": tags.view(shape), "values": vals.view(*shape, self.ev), "stamps": stamps.view(shape),
                "clock": clock}

    def update(self, state, keys, values) -> Dict[str, torch.Tensor]:
        """New values for keys already cached; misses are ignored."""
        keys, sets, hit, way = self._find(state, keys)
        flat = sets * self.ways + way
        win = hit & _last_writer(torch.where(hit, flat, self.num_sets * self.ways), self.num_sets * self.ways + 1)
        values = values.to(device=self.device, dtype=self.dtype)[win]
        vals = state["values"].reshape(-1, self.ev).index_put((flat[win],), values)
        return {**state, "values": vals.view(self.num_sets, self.ways, self.ev)}


def _h32(x: np.ndarray) -> np.ndarray:
    """murmur3's 32-bit finaliser of the keys' low 32 bits (uint64 math)."""
    x = x.astype(np.uint64) & np.uint64(_M32)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x85EBCA6B)) & np.uint64(_M32)
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(0xC2B2AE35)) & np.uint64(_M32)
    return x ^ (x >> np.uint64(16))


class StaticTable:
    """Immutable open-addressing hash table (the reference's static_table):
    built once on the host with linear probing at load factor <= 0.5, the
    keys and values then on the device; `lookup` probes at most the longest
    probe length of any stored key."""

    def __init__(self, keys: np.ndarray, values: np.ndarray, load_factor: float = 0.5, device: DeviceLike = None):
        keys = np.asarray(keys).astype(np.int64).reshape(-1)
        values = np.asarray(values)
        cap = 1
        while cap < len(keys) / load_factor:
            cap *= 2
        self.capacity, self._mask = cap, cap - 1
        table_keys = np.full(cap, EMPTY, np.int64)
        table_vals = np.zeros((cap, values.shape[1]), values.dtype)
        self.max_probe = 1
        for k, v, h in zip(keys, values, _h32(keys)):
            slot, probe = int(h) & self._mask, 1
            while table_keys[slot] != EMPTY and table_keys[slot] != k:
                slot = (slot + 1) & self._mask
                probe += 1
            table_keys[slot] = k
            table_vals[slot] = v
            self.max_probe = max(self.max_probe, probe)
        dev = resolve_device(device)
        self.keys = torch.as_tensor(table_keys, device=dev)
        self.values = torch.as_tensor(table_vals, device=dev)

    def lookup(self, q) -> Tuple[torch.Tensor, torch.Tensor]:
        """[N] keys -> (values [N, ev], found [N])."""
        q = torch.as_tensor(q).reshape(-1).long().to(self.keys.device)
        x = q & _M32
        x = x ^ (x >> 16)
        x = (x * 0x85EBCA6B) & _M32
        x = x ^ (x >> 13)
        x = (x * 0xC2B2AE35) & _M32
        slot = (x ^ (x >> 16)) & self._mask
        found = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
        vals = torch.zeros((q.numel(), self.values.shape[1]), dtype=self.values.dtype, device=q.device)
        for _ in range(self.max_probe):
            m = (self.keys[slot] == q) & ~found
            vals = torch.where(m[:, None], self.values[slot], vals)
            found |= m
            slot = (slot + 1) & self._mask
        return vals, found


class UvmTable:
    """A table in host memory with the device cache in front (the
    reference's uvm_table): `query` serves hits from the cache and fills
    misses from the host master (one host gather, one `replace` a call);
    `update` writes through to the master and to cached copies."""

    def __init__(self, keys: np.ndarray, values: np.ndarray, cache_capacity: int, ways: int = 8,
                 dtype: torch.dtype = torch.float32, device: DeviceLike = None):
        keys = np.asarray(keys).reshape(-1)
        values = np.asarray(values)
        if len(keys) != len(values):
            raise ValueError("keys/values length mismatch")
        order = np.argsort(keys)
        self._host_keys = keys[order]
        self._host_values = values[order]
        self.ev = values.shape[1]
        self.cache = EmbeddingCache(max(1, cache_capacity // ways), ways, self.ev, dtype=dtype, device=device)
        self.state = self.cache.init()
        self.hits = 0
        self.misses = 0

    def _host_lookup(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        pos = np.clip(np.searchsorted(self._host_keys, keys), 0, len(self._host_keys) - 1)
        found = self._host_keys[pos] == keys
        vals = np.where(found[:, None], self._host_values[pos], 0.0).astype(self._host_values.dtype)
        return vals, found

    def query(self, keys) -> Tuple[np.ndarray, np.ndarray]:
        """[N] keys -> (values [N, ev] float32, found [N] bool) on the host."""
        keys = np.asarray(keys).reshape(-1)
        vals, hit, self.state = self.cache.query(self.state, torch.as_tensor(keys))
        hit_h = hit.cpu().numpy()
        self.hits += int(hit_h.sum())
        out = vals.float().cpu().numpy()
        found = hit_h.copy()
        miss = np.flatnonzero(~hit_h)
        if len(miss):
            self.misses += len(miss)
            miss_keys = keys[miss]
            host_vals, host_found = self._host_lookup(miss_keys)
            out[miss] = host_vals
            found[miss] = host_found
            if host_found.any():
                self.state = self.cache.replace(self.state, torch.as_tensor(miss_keys[host_found]),
                                                torch.as_tensor(host_vals[host_found]))
        return out, found

    def update(self, keys, values) -> None:
        """Write-through: the host master and any cached copies."""
        keys = np.asarray(keys).reshape(-1)
        values = np.asarray(values)
        pos = np.clip(np.searchsorted(self._host_keys, keys), 0, len(self._host_keys) - 1)
        found = self._host_keys[pos] == keys
        self._host_values[pos[found]] = values[found]
        self.state = self.cache.update(self.state, torch.as_tensor(keys), torch.as_tensor(values))
