"""Batch inference: a graph file and a snapshot in, predictions out (the
port's counterpart of tools/predict.py, which drives the JAX package).

The model is rebuilt from a `Model.graph_to_json` file (either package's)
with `Model.construct_from_json`, loads a `download_params_to_files`
snapshot (either package's layout), and sweeps its eval source through the
eval forward (`Model._eval_step`: the embedding lookups, the dense network
in eval mode, each loss layer's sigmoid or softmax). A one-head model
writes one `.npy` array [N, label_dim]; a multi-task model writes one
array per label into a `.npz`.

    python -m hugectr_tpu_torch.tools.predict --graph graph.json \\
        --snapshot snap_iter1000 --data-reader-type raw --source eval.bin \\
        --num-samples 65536 --output preds.npy [--max-batches N] [--device cpu]

It runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from ..core.config import DataReaderParams
from ..core.mesh import DeviceLike, ResourceManager
from ..core.types import DataReaderType_t
from ..model.model import Model


def predict(graph_path: str, snapshot_dir: str, reader_params: Optional[DataReaderParams], max_batches: int = 0,
            model: Optional[Model] = None, resource_manager: Optional[ResourceManager] = None,
            device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """{label name: predictions [N, dim]} over the eval source, at most
    `max_batches` batches (0: all the eval reader gives). A given `model`
    is used as it is (no rebuild, no load)."""
    if model is None:
        model = Model.construct_from_json(graph_path, reader_params=reader_params,
                                          resource_manager=resource_manager, device=device)
        model.load_params_from_files(snapshot_dir)
    outs = {spec.label_name: [] for spec in model.network.loss_specs}
    source, feeder, _fed = model._eval_batches()
    n = 0
    for batch in source:
        if max_batches and n >= max_batches:
            break
        _loss, preds, _labels = model._eval_step(batch)
        for name in outs:
            outs[name].append(preds[name])
        n += 1
    if feeder is not None:
        feeder.stop()
    return {k: torch.cat(v).cpu().numpy() for k, v in outs.items() if v}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--graph", required=True, help="graph_to_json output")
    ap.add_argument("--snapshot", required=True, help="download_params_to_files directory")
    ap.add_argument("--data-reader-type", default="parquet", choices=[t.value for t in DataReaderType_t])
    ap.add_argument("--source", required=True, help="eval file list / file")
    ap.add_argument("--slot-size-array", default="", help="comma-separated per-slot vocabs")
    ap.add_argument("--num-samples", type=int, default=0, help="raw formats")
    ap.add_argument("--max-batches", type=int, default=0, help="0 = all")
    ap.add_argument("--output", default="preds.npy")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rp = DataReaderParams(
        data_reader_type=DataReaderType_t(args.data_reader_type), source=[], eval_source=args.source,
        eval_num_samples=args.num_samples,
        slot_size_array=[int(x) for x in args.slot_size_array.split(",")] if args.slot_size_array else [],
    )
    rm = ResourceManager.create(device=args.device)
    preds = predict(args.graph, args.snapshot, rp, max_batches=args.max_batches, resource_manager=rm)
    if len(preds) == 1:
        (arr,) = preds.values()
        np.save(args.output, arr)
    else:
        np.savez(args.output, **preds)
    total = sum(a.shape[0] for a in preds.values())
    print(f"wrote {args.output}: {total} rows across {len(preds)} head(s)")


if __name__ == "__main__":
    main()
