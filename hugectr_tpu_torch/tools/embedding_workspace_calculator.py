"""Embedding memory sizing (counterpart of tools/embedding_workspace_calculator.py).

Given the tables' vocabularies, widths and hotness and the optimizer, prints
the bytes a rank holds: the tables, the sparse optimizer state and an
estimate of a step's working set, in the JAX tool's lines, then one line of
the exact bytes. The tables and the state follow what the port allocates:
the plan `Model.compile` lays out on `--num_devices` ranks at the engine's
default settings (a model-parallel table holds ceil(v / P) rows a rank; a
table of at most 8,192 rows takes the one-hot engine and is whole on every
rank), and the port's state layouts (`embedding/sparse_optimizer.py::
init_state`): none for SGD, one [R, E] slot for momentum, Nesterov, AdaGrad
and RMSProp, two for Adam and FTRL, one [R, 1] slot for row-wise AdaGrad.
`--dtype_bytes` is the width of an element of the tables and the state.

    python -m hugectr_tpu_torch.tools.embedding_workspace_calculator \\
        --vocab 40000000,39060,17295 --ev 128 --hotness 3,2,1 --optimizer rowwise_adagrad --dtype_bytes 2
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Sequence

from ..core.types import Combiner_t, Optimizer_t

GIB = 1 << 30


def state_columns(optimizer: Optimizer_t, ev: int) -> int:
    """Elements of sparse optimizer state per table row, as `init_state`
    allocates them."""
    opt = Optimizer_t(optimizer)
    if opt == Optimizer_t.SGD:
        return 0
    if opt == Optimizer_t.RowWiseAdaGrad:
        return 1
    if opt in (Optimizer_t.Adam, Optimizer_t.FTRL):
        return 2 * ev
    return ev  # momentum, Nesterov, AdaGrad, RMSProp


def estimate(vocabs: Sequence[int], evs: Sequence[int], hotness: Sequence[int], optimizer: str = "adagrad",
             num_devices: int = 1, batchsize: int = 8192, dtype_bytes: int = 4) -> Dict:
    """The bytes a rank holds for these tables: `rows` (local rows),
    `weights`, `state` and `working_set` (the JAX tool's estimate of a
    step's gathers and sorted gradients), by the plan at the engine's
    default settings (`Model`'s)."""
    from ..parallel.plan import EmbeddingTableConfig, LookupConfig, ShardingPlan, compile_plan

    names = [str(i) for i in range(len(vocabs))]
    lookups = [LookupConfig(i, EmbeddingTableConfig(names[i], int(v), int(e)), f"data{i}", f"emb{i}",
                            Combiner_t.Sum, int(h))
               for i, (v, e, h) in enumerate(zip(vocabs, evs, hotness))]
    plan = compile_plan(lookups, ShardingPlan([("mp", names)]), num_devices,
                        {n: num_devices for n in names})
    opt = Optimizer_t(optimizer)
    rows = sum(int(g.total_local_rows) for g in plan.groups)
    weights = sum(int(g.total_local_rows) * g.ev_size for g in plan.groups) * dtype_bytes
    state = sum(int(g.total_local_rows) * state_columns(opt, g.ev_size) for g in plan.groups) * dtype_bytes
    k = batchsize * sum(hotness)
    working_set = (3 * k * max(evs) + 2 * k) * dtype_bytes
    return dict(devices=num_devices, tables=len(vocabs), rows=rows, weights=weights, state=state,
                working_set=working_set, total=weights + state + working_set, optimizer=opt.value,
                batchsize=batchsize, keys=k)


def lines(est: Dict) -> List[str]:
    """The JAX tool's lines, then the exact bytes."""
    return [
        f"devices={est['devices']} tables={est['tables']} local rows={est['rows']:,}",
        f"  weights / device       : {est['weights'] / GIB:8.2f} GiB",
        f"  optimizer state        : {est['state'] / GIB:8.2f} GiB ({est['optimizer']})",
        f"  step working set (~)   : {est['working_set'] / GIB:8.2f} GiB (batch {est['batchsize']}, "
        f"K={est['keys']:,})",
        f"  TOTAL                  : {est['total'] / GIB:8.2f} GiB",
        f"  bytes: weights={est['weights']} state={est['state']} working_set={est['working_set']} "
        f"total={est['total']}",
    ]


def main(argv=None) -> None:
    p = argparse.ArgumentParser("embedding_workspace_calculator")
    p.add_argument("--vocab", type=str, required=True, help="comma list of vocab sizes")
    p.add_argument("--ev", type=str, required=True, help="comma list (or one) of ev sizes")
    p.add_argument("--hotness", type=str, default="", help="comma list of hotness")
    p.add_argument("--optimizer", default="adagrad")
    p.add_argument("--num_devices", type=int, default=1)
    p.add_argument("--batchsize", type=int, default=8192)
    p.add_argument("--dtype_bytes", type=int, default=4)
    a = p.parse_args(argv)

    vocabs = [int(x) for x in a.vocab.split(",")]
    evs = [int(x) for x in a.ev.split(",")]
    if len(evs) == 1:
        evs = evs * len(vocabs)
    hot = [int(x) for x in a.hotness.split(",")] if a.hotness else [1] * len(vocabs)
    est = estimate(vocabs, evs, hot, a.optimizer, a.num_devices, a.batchsize, a.dtype_bytes)
    print("\n".join(lines(est)))


if __name__ == "__main__":
    main()
