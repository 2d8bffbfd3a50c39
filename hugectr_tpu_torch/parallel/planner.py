"""Automatic embedding sharding planner.

Semantics mirrored from the reference auto-planner
(samples/dlrm/sharding/planner.py:22-327 and generate_plan.py): a greedy
cost-model search that iteratively splits the hottest table across more
devices and packs shards onto the devices with the lowest accumulated cost.
Cost per device = unit_hotness_cost * sum(hotness/num_split)
               + unit_table_cost * num_tables
with a memory-capacity constraint mem_cost <= capacity; tables smaller than
`dp_threshold` bytes are placed data-parallel on every device.

TPU notes: on the current engine all MP tables are fully row-sharded over the
mesh (shard_matrix rows are equal), so the planner's main products are the
mp/dp split and per-table shard counts; the shard_matrix is still produced
with reference-identical structure for config parity and for future partial
placement support.

The port's own copy of hugectr_tpu/parallel/planner.py (numpy only, no
torch), kept so that the port imports nothing of the JAX package; it
returns the JAX module's plans. The port's collection places a plan's
partial shard matrix too (a table on fewer shards than ranks).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class PlannerCostModel:
    """Unit costs (reference: CostModel, planner.py:143-200).

    Defaults follow samples/dlrm/train.py: mem/comm bandwidth ratio drives
    table_cost; hotness cost is per looked-up row.
    """

    unit_hotness_cost: float = 1.0
    unit_table_cost: float = 50.0
    unit_mem_cost: float = 1.0
    mem_capacity_bytes: float = 16e9  # per-device HBM budget for tables


def auto_plan(
    table_names: Sequence[str],
    table_sizes_bytes: Sequence[float],
    hotness: Sequence[int],
    num_devices: int,
    cost_model: Optional[PlannerCostModel] = None,
    dp_threshold_bytes: float = 0.0,
    max_search_iter: int = 20,
) -> Tuple[List[Tuple[str, List[str]]], List[List[str]]]:
    """Greedy hotness-balancing search (reference: Planner.plan).

    Returns (shard_strategy, shard_matrix) in reference format with table
    NAMES (the reference returns ids; names are what our ECC.shard takes).
    """
    cm = cost_model or PlannerCostModel()
    n = len(table_names)
    sizes = np.asarray(table_sizes_bytes, dtype=np.float64)
    hot = np.asarray(hotness, dtype=np.float64)

    dp_ids = (
        np.where(sizes < dp_threshold_bytes)[0] if dp_threshold_bytes > 0 else np.array([], int)
    )
    mp_ids = np.setdiff1d(np.arange(n), dp_ids)
    capacity = cm.mem_capacity_bytes - sizes[dp_ids].sum() * cm.unit_mem_cost
    if capacity < 0:
        raise MemoryError("DP tables alone exceed per-device capacity")

    # state: per-table split count; shard list per device
    num_split = {t: 1 for t in mp_ids}

    def device_costs(shard_ll: List[List[int]]):
        costs, mems = [], []
        for lst in shard_ll:
            h = sum(cm.unit_hotness_cost * hot[t] / num_split[t] for t in lst)
            tc = cm.unit_table_cost * len(lst)
            m = sum(cm.unit_mem_cost * sizes[t] / num_split[t] for t in lst)
            costs.append(h + tc)
            mems.append(m)
        return np.asarray(costs), np.asarray(mems)

    def greedy_pack() -> Optional[List[List[int]]]:
        """Place each shard on the cheapest device that fits; None on OOM."""
        order = sorted(
            [t for t in mp_ids for _ in range(num_split[t])],
            key=lambda t: -hot[t] / num_split[t],
        )
        shard_ll: List[List[int]] = [[] for _ in range(num_devices)]
        for t in order:
            costs, mems = device_costs(shard_ll)
            placed = False
            for d in np.argsort(costs):
                if t in shard_ll[d]:
                    continue  # uniform sharding: one shard of a table per device
                if mems[d] + cm.unit_mem_cost * sizes[t] / num_split[t] <= capacity:
                    shard_ll[d].append(t)
                    placed = True
                    break
            if not placed:
                return None
        return shard_ll

    candidates = []
    # most-memory-efficient default: every table on every device
    for t in mp_ids:
        num_split[t] = num_devices
    full = [[int(t) for t in mp_ids] for _ in range(num_devices)]
    costs, mems = device_costs(full)
    if mems.max() > capacity:
        raise MemoryError("OOM even with fully-sharded plan")
    candidates.append((costs.max(), full))

    # search from unsplit upward
    for t in mp_ids:
        num_split[t] = 1
    for _ in range(max_search_iter):
        shard_ll = greedy_pack()
        if shard_ll is not None:
            costs, _ = device_costs(shard_ll)
            candidates.append((costs.max(), [list(r) for r in shard_ll]))
        # split the hottest splittable shard further (×2, capped at P)
        splittable = [
            t for t in mp_ids if num_split[t] * 2 <= num_devices
        ]
        if not splittable:
            break
        hottest = max(splittable, key=lambda t: hot[t] / num_split[t])
        num_split[hottest] *= 2

    candidates.sort(key=lambda c: c[0])
    best = candidates[0][1]
    shard_matrix = [[table_names[t] for t in row] for row in best]
    for d in range(num_devices):
        for t in dp_ids:
            shard_matrix[d].append(table_names[t])
    strategy: List[Tuple[str, List[str]]] = [
        ("mp", [table_names[t] for t in mp_ids])
    ]
    if len(dp_ids):
        strategy.append(("dp", [table_names[t] for t in dp_ids]))
    return strategy, shard_matrix


def round_robin_plan(
    table_names: Sequence[str], num_devices: int
) -> Tuple[List[Tuple[str, List[str]]], List[List[str]]]:
    """Table i lives on device i % P (reference: round_robin option,
    samples/dlrm/train.py:204-209)."""
    matrix: List[List[str]] = [[] for _ in range(num_devices)]
    for i, t in enumerate(table_names):
        matrix[i % num_devices].append(t)
    return [("mp", list(table_names))], matrix


def uniform_plan(
    table_names: Sequence[str], num_devices: int
) -> Tuple[List[Tuple[str, List[str]]], List[List[str]]]:
    """Every table row-sharded on every device — the XLA-SPMD-natural layout
    and the engine's current execution model."""
    return [("mp", list(table_names))], [list(table_names)] * num_devices
