"""The standalone sparse API (counterpart of hugectr_tpu/sok/__init__.py;
HugeCTR's sparse_operation_kit): the port's embedding collection for any
PyTorch training loop, without the Model.

`lookup_sparse` pairs with `OptimizerWrapper.apply_gradients`, which takes
the cotangents of the lookup's outputs ([B, ev]) and runs the collection's
fused update, as the JAX package does (its cotangents are dense, so a
gradient with respect to the table would be vocabulary-sized).

Module state: `init(rm)` binds the ResourceManager the variables and engines
take by default (`_RM`, as sok.init binds the devices); a test that needs a
clean slate sets it again. Over W ranks each process passes its own block
of the batch to `lookup` and `apply_gradients`, as the Model does, and
every rank calls them (and `export`, `dump`, `size`) together.

Variables take a torch.Generator or an int seed where the JAX package takes
a jax.random key; their rows start from the port's init, not JAX's.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.mesh import ResourceManager, all_reduce
from ..core.types import Combiner_t, Optimizer_t
from ..embedding.collection import EmbeddingCollection, fold_reserved_key
from ..optim.params import OptParams
from ..parallel.plan import EmbeddingTableConfig, LookupConfig, ShardingPlan, compile_plan

__all__ = [
    "init", "Variable", "DynamicVariable", "DistributedVariable", "LocalizedVariable", "export", "assign",
    "sparse_read_and_evict", "SGD", "LookupEngine", "lookup_sparse", "all2all_dense_embedding",
    "OptimizerWrapper", "dump", "load", "incremental_model_dump", "filter_variables",
]

_RM: Optional[ResourceManager] = None
# compile_plan's settings among a LookupEngine's keyword arguments; the others
# go to EmbeddingCollection
_PLAN_SETTINGS = ("onehot_vocab", "split_vocab", "hot_rows", "superhot_rows", "warm_rows", "shard_rotation",
                  "group_rows")


def init(resource_manager: Optional[ResourceManager] = None) -> None:
    """Bind the ResourceManager (sok/__init__.py:53): the given one, or
    `ResourceManager.create()` (over the initialised group, on the card)."""
    global _RM
    _RM = resource_manager or ResourceManager.create()


def _rm() -> ResourceManager:
    if _RM is None:
        init()
    return _RM


def _generator(key, rm: ResourceManager) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return rm.generator(0 if key is None else int(key))


def _as_keys(keys, device) -> torch.Tensor:
    k = keys if isinstance(keys, torch.Tensor) else torch.from_numpy(np.asarray(keys))
    k = k.to(device)
    return k.reshape(-1, 1) if k.dim() == 1 else k


class LookupEngine:
    """Tables and the compiled plan of a set of lookups (sok/__init__.py:621):
    what `lookup_sparse` and `OptimizerWrapper` run. `settings`: the plan's
    engine thresholds (`onehot_vocab`, `split_vocab`, `hot_rows`, ...) and the
    collection's (`dtype`, `state_dtype`, `dense_update_rows`, ...).

    `use_sp_weight`: lookups compile as Concat so that each slot's vector is
    there; the user's Sum pools sum(w x e), Mean sum(w x e) / sum(w) (TF's
    embedding_lookup_sparse), and the update routes w-scaled per-slot
    cotangents back through the Concat lookup (:637-757)."""

    def __init__(
        self,
        tables: Sequence[EmbeddingTableConfig],
        hotness: Sequence[int],
        combiners: Sequence[Union[str, Combiner_t]],
        opt: OptParams,
        rm: Optional[ResourceManager] = None,
        dp_tables: Sequence[str] = (),
        shard_counts: Optional[Dict[str, int]] = None,
        use_sp_weight: bool = False,
        **settings,
    ):
        self.rm = rm or _rm()
        self.use_sp_weight = bool(use_sp_weight)
        self.user_combiners = [Combiner_t(c) for c in combiners]
        if self.use_sp_weight:
            if any(c == Combiner_t.Concat for c in self.user_combiners):
                raise ValueError("sp_weights require sum/mean combiners")
            combiners = [Combiner_t.Concat] * len(self.user_combiners)
        lookups = [
            LookupConfig(lookup_id=i, table=t, bottom_name=f"in{i}", top_name=f"out{i}", combiner=Combiner_t(c),
                         max_hotness=h)
            for i, (t, h, c) in enumerate(zip(tables, hotness, combiners))
        ]
        mp = [t.name for t in tables if t.name not in set(dp_tables)]
        plan_kw = {k: settings.pop(k) for k in _PLAN_SETTINGS if k in settings}
        self.compiled = compile_plan(lookups, ShardingPlan(strategy=[("mp", mp), ("dp", list(dp_tables))]),
                                     num_shards=self.rm.data_parallel_size, shard_counts=shard_counts, **plan_kw)
        self.ec = EmbeddingCollection(self.compiled, self.rm, opt, **settings)
        self.n = len(lookups)

    def init(self, key=None) -> Dict[str, torch.Tensor]:
        return self.ec.init(_generator(key, self.rm))

    def init_optimizer(self, tables) -> Dict[str, Dict[str, torch.Tensor]]:
        return self.ec.init_optimizer(tables)

    def _slot_weights(self, i: int, keys: torch.Tensor, sp_weights) -> torch.Tensor:
        """[B, h] weights of lookup i: 1 without weights, 0 at padding, a
        Mean's normalised by their sum (at least 1e-12)."""
        k = keys if keys.dim() == 2 else keys.unsqueeze(1)
        valid = k != -1
        w = sp_weights[i] if sp_weights is not None and sp_weights[i] is not None else None
        if w is None:
            w = torch.ones(k.shape, dtype=torch.float32, device=k.device)
        else:
            w = torch.as_tensor(w, device=k.device).float()
            w = w.unsqueeze(1) if w.dim() == 1 else w
        w = torch.where(valid, w, 0.0)
        if self.user_combiners[i] == Combiner_t.Mean:
            w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)
        return w

    def _feature_keys(self, keys) -> Dict[str, torch.Tensor]:
        return {lk.bottom_name: _as_keys(keys[i], self.rm.device) for i, lk in enumerate(self.compiled.lookups)}

    def lookup(self, tables, keys: Sequence, sp_weights=None) -> List[torch.Tensor]:
        """keys[i] [B, hotness_i] (-1 padding) -> pooled [B, ev_i] per
        lookup (sok/__init__.py:691; sok.lookup_sparse)."""
        if sp_weights is not None and not self.use_sp_weight:
            raise ValueError("pass use_sp_weight=True at engine build to use sp_weights")
        fk = self._feature_keys(keys)
        outs = self.ec.forward(tables, fk)
        flat = [outs[lk.top_name] for lk in self.compiled.lookups]
        if not self.use_sp_weight:
            return flat
        pooled = []
        for i, (o, lk) in enumerate(zip(flat, self.compiled.lookups)):
            w = self._slot_weights(i, fk[lk.bottom_name], sp_weights)
            pooled.append(torch.einsum("bhe,bh->be", o.reshape(o.shape[0], -1, lk.table.ev_size), w.to(o.dtype)))
        return pooled

    def apply_gradients(self, tables, opt_state, keys: Sequence, d_outs: Sequence, lr, step=1, sp_weights=None):
        """The fused update from the outputs' cotangents, in place
        (sok/__init__.py:726); with weights, d_slot[b, h] = w[b, h] x d[b]."""
        fk = self._feature_keys(keys)
        d_outs = [torch.as_tensor(d, device=self.rm.device) for d in d_outs]
        if self.use_sp_weight:
            d_outs = [
                (self._slot_weights(i, fk[lk.bottom_name], sp_weights).to(d.dtype).unsqueeze(2)
                 * d.unsqueeze(1)).reshape(d.shape[0], -1)
                for i, (d, lk) in enumerate(zip(d_outs, self.compiled.lookups))
            ]
        grads = {lk.top_name: d_outs[i] for i, lk in enumerate(self.compiled.lookups)}
        return self.ec.backward_and_update(tables, opt_state, fk, grads, torch.as_tensor(lr), int(step))


class Variable:
    """One table with its own engine, storage and optimizer state
    (sok/__init__.py:67; sok.Variable): `mode="distributed"` row-shards it
    over the ranks, `"localized:<i>"` keeps it whole on every rank (one
    shard)."""

    def __init__(self, rows: int, ev: int, key=None, name: str = "sok_var", max_hotness: int = 1,
                 combiner: str = "sum", mode: str = "distributed", opt_params: Optional[OptParams] = None,
                 rm: Optional[ResourceManager] = None, _table_cfg: Optional[EmbeddingTableConfig] = None,
                 **settings):
        self.name = name
        self.rows = rows
        self.ev = ev
        cfg = _table_cfg or EmbeddingTableConfig(name=name, max_vocabulary_size=rows, ev_size=ev)
        opt = opt_params or OptParams(Optimizer_t.SGD, lr=1.0)
        self.engine = LookupEngine([cfg], [max_hotness], [combiner], opt, rm=rm,
                                   shard_counts={name: 1} if mode.startswith("localized") else None, **settings)
        self.tables = self.engine.init(key)
        self.opt_state = self.engine.init_optimizer(self.tables)

    @classmethod
    def create(cls, rows: int, ev: int, key=None, **kw):
        return cls(rows, ev, key, **kw)

    def lookup(self, keys) -> torch.Tensor:
        """Pooled lookup of [B, hotness] keys (-1 padding) -> [B, ev]."""
        return self.engine.lookup(self.tables, [keys])[0]

    def apply_gradients(self, keys, d_out, lr, step: int = 1) -> None:
        self.engine.apply_gradients(self.tables, self.opt_state, [keys], [d_out], lr, step)

    def to_numpy(self) -> np.ndarray:
        return self.engine.ec.export_table(self.tables, self._table_name)

    def assign(self, values: np.ndarray) -> None:
        self.engine.ec.import_table(self.tables, self._table_name, values)

    @property
    def _table_name(self) -> str:
        return self.engine.compiled.lookups[0].table.name

    @property
    def shape(self):
        return (self.rows, self.ev)


class DynamicVariable(Variable):
    """A table of exact dynamic keys (sok/__init__.py:145; sok.DynamicVariable)
    on the collection's key store: insert on the backward, `evict`, growth
    by `reserve`. backend="hkv": the device store is a working set of fixed
    capacity under a host master that holds every key ever trained;
    `lookup` and `apply_gradients` first stage the master's rows of the
    batch's keys, spilling the whole working set to the master when it would
    pass `spill_watermark` of the capacity."""

    def __init__(self, dimension: int, initial_capacity: int = 2**20, key=None, name: str = "sok_dyn_var",
                 max_hotness: int = 1, combiner: str = "sum", opt_params: Optional[OptParams] = None,
                 rm: Optional[ResourceManager] = None, mode: str = "distributed", backend: str = "det",
                 spill_watermark: float = 0.75, **settings):
        if backend not in ("det", "hkv"):
            raise ValueError(f"backend must be 'det' or 'hkv', got {backend}")
        self.backend = backend
        self._spill_watermark = float(spill_watermark)
        # the host master (hkv): key -> row; rows freed by evict are reused
        self._host_index: dict = {}
        self._host_free: list = []
        self._host_next = 0
        self._host_values: Optional[np.ndarray] = None
        self._host_opt: dict = {}
        self._static_indices = None
        self._static_values = None
        cfg = EmbeddingTableConfig(name=name, max_vocabulary_size=-1, ev_size=dimension,
                                   dynamic_capacity=initial_capacity)
        super().__init__(rows=initial_capacity, ev=dimension, key=key, name=name, max_hotness=max_hotness,
                         combiner=combiner, mode=mode, opt_params=opt_params, rm=rm, _table_cfg=cfg, **settings)
        self.dimension = dimension

    def _g_ti(self):
        return self.engine.ec._find_table(self._table_name)

    @property
    def capacity(self) -> int:
        g, ti = self._g_ti()
        return int(g.table_vocab[ti])

    @property
    def size(self) -> int:
        """Resident keys (over W ranks the shards' sum: every rank calls this)."""
        g, _ti = self._g_ti()
        n = torch.tensor([len(self._device_resident())], dtype=torch.int64, device=self.engine.rm.device)
        if self.engine.rm.data_parallel_size > 1:
            n = all_reduce(n, self.engine.rm.data_group)
        return int(n.item()) // max(g.num_replicas, 1)

    def reserve(self, new_capacity: int) -> None:
        """Grow the capacity between steps (`grow_dynamic_capacity`)."""
        ec2, t2, s2 = self.engine.ec.grow_dynamic_capacity(self.tables, self.opt_state, self._table_name,
                                                           new_capacity)
        self.engine.ec, self.engine.compiled = ec2, ec2.plan
        self.tables, self.opt_state = t2, s2
        self.rows = new_capacity

    def evict(self, keys) -> None:
        self.engine.ec.evict(self.tables, self.opt_state, self._table_name, keys)
        if self.backend == "hkv":
            for k in np.asarray(keys).reshape(-1).tolist():
                row = self._host_index.pop(int(k), None)
                if row is not None:
                    self._host_free.append(row)

    # ---- static mode (dynamic_variable.py:205-222)
    def is_static(self) -> bool:
        return self._static_indices is not None

    def to_static(self, indices) -> np.ndarray:
        """A dense [len(indices), ev] float32 copy of the keys' rows (keys
        never trained read as 0); lookups are off until `to_dynamic`."""
        if self.is_static():
            raise RuntimeError("to_static() must be called in dynamic mode.")
        keys = np.asarray(indices).reshape(-1)
        self._static_values = self.lookup(keys.astype(np.int32)).float().cpu().numpy()
        self._static_indices = keys
        return self._static_values

    def to_dynamic(self) -> None:
        """Write the static buffer's rows back at their keys (the last of a
        duplicated key wins), inserting keys as needed."""
        if not self.is_static():
            raise RuntimeError("to_dynamic() must be called in static mode.")
        keys, vals = self._static_indices, self._static_values
        _, last = np.unique(keys[::-1], return_index=True)
        sel = np.sort(len(keys) - 1 - last)
        self._write_rows(keys[sel], vals[sel])
        self._static_indices = self._static_values = None

    def assign(self, values: np.ndarray) -> None:
        if self.is_static():
            values = np.asarray(values, np.float32)
            if values.shape != self._static_values.shape:
                raise ValueError(f"static assign: shape {values.shape} != {self._static_values.shape}")
            self._static_values = values
            return
        super().assign(values)

    def _write_rows(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Upsert rows at keys into the store, on the host (sok/__init__.py:297)."""
        ec = self.engine.ec
        g, ti = self._g_ti()
        nks = ec._host_key_store(self.tables, g)
        placed = ec._dynamic_host_slots(nks, g, ti, keys)
        missing = placed < 0
        if missing.any():
            ins = ec._host_insert_keys(nks, g, ti, keys[missing])
            if (ins < 0).any():
                raise RuntimeError("dynamic table capacity exhausted during to_dynamic(); call "
                                   "reserve(new_capacity) first")
            placed[missing] = ins
        ec._scatter_all_replicas_multi([self.tables[g.name]], placed, [np.asarray(vals, np.float32)])
        if missing.any():
            ec._scatter_all_replicas_multi([self.tables[f"{g.name}#keys"]], placed[missing],
                                           [fold_reserved_key(keys[missing].astype(np.int32))])

    # ---- hkv host tier
    def _device_resident(self) -> np.ndarray:
        """The keys the rank's store holds (a host copy)."""
        g, ti = self._g_ti()
        return self.engine.ec._live_slots(self.engine.ec._host_key_store(self.tables, g), g, ti)[1]

    def _host_upsert(self, keys: np.ndarray, vals: np.ndarray, st: dict) -> None:
        if self._host_values is None:
            cap = max(1024, 2 * len(keys))
            self._host_values = np.zeros((cap, self.ev), np.float32)
            self._host_opt = {slot: np.zeros((cap, a.shape[1]), np.float32) for slot, a in st.items()}
        need = sum(1 for k in keys if int(k) not in self._host_index)
        need_fresh = max(0, need - len(self._host_free))
        cap = self._host_values.shape[0]
        if self._host_next + need_fresh > cap:
            new_cap = max(2 * cap, self._host_next + need_fresh)
            self._host_values = np.resize(self._host_values, (new_cap, self.ev))
            self._host_values[cap:] = 0.0
            for slot in self._host_opt:
                w = self._host_opt[slot].shape[1]
                self._host_opt[slot] = np.resize(self._host_opt[slot], (new_cap, w))
                self._host_opt[slot][cap:] = 0.0
        for i, k in enumerate(np.asarray(keys).tolist()):
            row = self._host_index.get(int(k))
            if row is None:
                row = self._host_free.pop() if self._host_free else self._host_next
                if row == self._host_next:
                    self._host_next += 1
                self._host_index[int(k)] = row
            self._host_values[row] = vals[i]
            for slot, a in st.items():
                self._host_opt[slot][row] = a[i]

    def _entries(self):
        g, ti = self._g_ti()
        live, vals, st = self.engine.ec._collect_dynamic_entries(self.tables, self.opt_state, g, ti)
        return live, vals.float().numpy(), {k: v.float().numpy() for k, v in st.items()}

    def spill(self) -> None:
        """Move the whole working set to the host master and clear it."""
        live, vals, st = self._entries()
        if len(live):
            self._host_upsert(live, vals, st)
            self.engine.ec.evict(self.tables, self.opt_state, self._table_name, live)

    def _stage(self, keys: np.ndarray) -> None:
        """Bring the master's rows of `keys` into the working set."""
        ec = self.engine.ec
        g, ti = self._g_ti()
        uniq = [int(k) for k in np.unique(keys[keys >= 0]).tolist()]

        def plan_stage():
            resident = set(self._device_resident().tolist())
            want = [k for k in uniq if k not in resident and k in self._host_index]
            fresh = sum(1 for k in uniq if k not in resident and k not in self._host_index)
            return resident, want, fresh

        resident, want, fresh = plan_stage()
        if len(resident) + len(want) + fresh > self._spill_watermark * self.capacity:
            self.spill()  # the batch's resident keys went too: plan again
            resident, want, fresh = plan_stage()
        if not want:
            return
        rows = np.asarray([self._host_index[k] for k in want])
        nks = ec._host_key_store(self.tables, g)
        placed = ec._host_insert_keys(nks, g, ti, np.asarray(want))
        ok = placed >= 0
        if not ok.any():
            return
        slots = list(self.opt_state.get(g.name, {}))
        ec._scatter_all_replicas_multi(
            [self.tables[g.name], self.tables[f"{g.name}#keys"]] + [self.opt_state[g.name][s] for s in slots],
            placed[ok], [self._host_values[rows][ok], fold_reserved_key(np.asarray(want, np.int32)[ok])]
            + [self._host_opt[s][rows][ok] for s in slots])

    def lookup(self, keys) -> torch.Tensor:
        if self.is_static():
            raise RuntimeError("variable is in static mode; call to_dynamic() first")
        if self.backend == "hkv":
            self._stage(_as_keys(keys, "cpu").numpy().reshape(-1))
        return super().lookup(keys)

    def apply_gradients(self, keys, d_out, lr, step: int = 1) -> None:
        if self.is_static():
            raise RuntimeError("variable is in static mode; call to_dynamic() first")
        # the master's rows resident before the update: the insert on the
        # backward would otherwise restart them from a fresh row
        if self.backend == "hkv":
            self._stage(_as_keys(keys, "cpu").numpy().reshape(-1))
        super().apply_gradients(keys, d_out, lr, step)

    @property
    def host_size(self) -> int:
        return len(self._host_index)

    @property
    def total_size(self) -> int:
        """Distinct trained keys over both tiers (hkv)."""
        return len(set(self._device_resident().tolist()) | set(self._host_index))

    def export_merged(self) -> dict:
        """{key: vector} over both tiers; a resident row wins."""
        out = {}
        if self._host_values is not None:
            for k, r in self._host_index.items():
                out[k] = np.array(self._host_values[r])
        live, vals, _st = self._entries()
        for i, k in enumerate(live.tolist()):
            out[int(k)] = vals[i]
        return out


class DistributedVariable(Variable):
    """`Variable(mode="distributed")` (sok/__init__.py:494)."""

    def __init__(self, *args, **kw):
        kw["mode"] = "distributed"
        super().__init__(*args, **kw)


class LocalizedVariable(Variable):
    """`Variable(mode="localized:<target_gpu>")`: the whole table on every
    rank (sok/__init__.py:503)."""

    def __init__(self, *args, target_gpu: int = 0, **kw):
        kw["mode"] = f"localized:{target_gpu}"
        super().__init__(*args, **kw)


def export(var: DynamicVariable) -> Tuple[np.ndarray, np.ndarray]:
    """(keys, float32 rows) of every resident key (sok.export); hkv merges
    both tiers."""
    if not isinstance(var, DynamicVariable):
        raise TypeError("sok.export expects a sok.DynamicVariable")
    if var.backend == "hkv":
        merged = var.export_merged()
        keys = np.asarray(sorted(merged), dtype=np.int64)
        vals = np.stack([merged[int(k)] for k in keys]) if len(keys) else np.zeros((0, var.ev), np.float32)
        return keys, vals
    live, vals, _st = var._entries()
    return np.asarray(live, np.int64), vals


def assign(var: DynamicVariable, indices, values) -> DynamicVariable:
    """Upsert rows at keys (sok.assign)."""
    if not isinstance(var, DynamicVariable):
        raise TypeError("sok.assign expects a sok.DynamicVariable")
    keys = np.asarray(indices).reshape(-1)
    var._write_rows(keys, np.asarray(values, np.float32).reshape(len(keys), -1))
    return var


def sparse_read_and_evict(var: DynamicVariable, indices) -> np.ndarray:
    """The rows of `indices`, then those keys moved from the working set to
    the host master (sok.sparse_read_and_evict; hkv only)."""
    if not isinstance(var, DynamicVariable) or var.backend != "hkv":
        raise TypeError("sparse_read_and_evict only works on backend='hkv' DynamicVariable")
    keys = np.asarray(indices).reshape(-1)
    vals = var.lookup(keys.astype(np.int32)).float().cpu().numpy()
    live, dev_vals, st = var._entries()
    sel = np.isin(live, keys.astype(live.dtype))
    if sel.any():
        var._host_upsert(live[sel], dev_vals[sel], {slot: a[sel] for slot, a in st.items()})
        var.engine.ec.evict(var.tables, var.opt_state, var._table_name, live[sel])
    return vals


class SGD:
    """Plain SGD on (values, indices) gradients (sok.SGD): w[idx] -= lr x g,
    whatever optimizer the variable was built with (its engine's is replaced)."""

    def __init__(self, lr: float):
        self._lr = float(lr)

    @property
    def lr(self) -> float:
        return self._lr

    def apply_gradients(self, grads_and_vars, global_step=None, name=None):
        for g, v in grads_and_vars:
            if g is None:
                continue
            if hasattr(g, "values") and hasattr(g, "indices"):
                values, idx = g.values, g.indices
            elif isinstance(g, tuple):
                values, idx = g
            else:  # a dense gradient covers every row
                values = torch.as_tensor(np.asarray(g) if not isinstance(g, torch.Tensor) else g)
                idx = torch.arange(values.shape[0], dtype=torch.int32)
            ec = v.engine.ec
            if any(ec.group_opt[gr.name].optimizer != Optimizer_t.SGD for gr in ec.plan.groups):
                for gr in ec.plan.groups:
                    ec.group_opt[gr.name] = OptParams(Optimizer_t.SGD, lr=self._lr)
                v.opt_state = v.engine.init_optimizer(v.tables)
            v.apply_gradients(_as_keys(idx, v.engine.rm.device),
                              torch.as_tensor(np.asarray(values) if not isinstance(values, torch.Tensor) else values),
                              self._lr)


def lookup_sparse(engine: LookupEngine, tables, keys: Sequence, sp_weights=None) -> List[torch.Tensor]:
    """`engine.lookup` (sok.lookup_sparse)."""
    return engine.lookup(tables, keys, sp_weights=sp_weights)


def all2all_dense_embedding(engine: LookupEngine, tables, keys) -> torch.Tensor:
    """One table's unpooled lookup: [B] keys -> [B, ev] (sok.all2all_dense_embedding)."""
    return engine.lookup(tables, [_as_keys(keys, engine.rm.device).reshape(-1, 1)])[0]


class OptimizerWrapper:
    """Binds optimizer settings to an engine and applies the fused update
    from the lookup's cotangents (sok.OptimizerWrapper)."""

    def __init__(self, engine: LookupEngine, opt: Optional[OptParams] = None):
        self.engine = engine
        if opt is not None:
            for g in engine.ec.plan.groups:
                engine.ec.group_opt[g.name] = opt

    def initialize(self, tables):
        return self.engine.init_optimizer(tables)

    def apply_gradients(self, tables, opt_state, keys, d_outs, lr, step=1, sp_weights=None):
        return self.engine.apply_gradients(tables, opt_state, keys, d_outs, lr, step, sp_weights=sp_weights)


def dump(path: str, engine: LookupEngine, tables) -> None:
    """Each table as `<path>/<name>.npy` in key order (sok.dump; bf16 rows
    as float32, which holds them exactly). Every rank calls this; rank 0
    writes, then the ranks meet."""
    os.makedirs(path, exist_ok=True)
    for g in engine.ec.plan.groups:
        for t in g.tables:
            arr = engine.ec.export_table(tables, t.name)
            if engine.rm.rank == 0:
                np.save(os.path.join(path, f"{t.name}.npy"), arr)
    if engine.rm.data_parallel_size > 1:
        all_reduce(torch.zeros(1, device=engine.rm.device), engine.rm.data_group)


def load(path: str, engine: LookupEngine, tables):
    """The tables `dump` wrote, where their files are (sok.load)."""
    for g in engine.ec.plan.groups:
        for t in g.tables:
            f = os.path.join(path, f"{t.name}.npy")
            if os.path.exists(f):
                engine.ec.import_table(tables, t.name, np.load(f))
    return tables


def incremental_model_dump(engine: LookupEngine, tables, touched_keys: Dict[str, np.ndarray]):
    """{table: {"keys", "values"}} of the named keys only (sok.incremental_model_dump)."""
    out = {}
    for g in engine.ec.plan.groups:
        for t in g.tables:
            keys = np.asarray(touched_keys.get(t.name, []), dtype=np.int64)
            if keys.size == 0:
                continue
            full = engine.ec.export_table(tables, t.name)
            keys = keys[(keys >= 0) & (keys < full.shape[0])]
            out[t.name] = {"keys": keys, "values": full[keys]}
    return out


def filter_variables(variables: Sequence) -> Tuple[List, List]:
    """(sok's variables and engines, the others) (sok.filter_variables)."""
    sok_vars = [v for v in variables if isinstance(v, (LookupEngine, Variable))]
    return sok_vars, [v for v in variables if not isinstance(v, (LookupEngine, Variable))]
