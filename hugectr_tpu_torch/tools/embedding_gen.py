"""Random embedding tables in the snapshot layout (counterpart of
tools/embedding_gen.py; reference: tools/model_generation/embedding_gen.py:
30-78): one `sparse_<name>/emb_vector.npy` a table, float32 [n, dim] drawn
uniform in [-sqrt(1/n), sqrt(1/n)) from `--seed`, the files the port's
`Model.load_params_from_files` and `embedding_load` read.

    python -m hugectr_tpu_torch.tools.embedding_gen --embedding-size 39884406-39043-17289 \\
        --dim 128 --output ./snap [--names table0,table1,table2] [--seed 0]
"""
from __future__ import annotations

import argparse
import math
import os

import numpy as np


def generate(embedding_sizes, dim, output, names=None, seed=0, chunk=1 << 20) -> None:
    os.makedirs(output, exist_ok=True)
    rng = np.random.default_rng(seed)
    if names is None:
        names = [f"table{i}" for i in range(len(embedding_sizes))]
    if len(names) != len(embedding_sizes):
        raise ValueError("--names count must match --embedding-size count")
    for name, n in zip(names, embedding_sizes):
        tdir = os.path.join(output, f"sparse_{name}")
        os.makedirs(tdir, exist_ok=True)
        bound = math.sqrt(1.0 / n)
        arr = np.empty((n, dim), dtype=np.float32)
        for start in range(0, n, chunk):  # chunks bound the float64 draws of a 100M-row table
            stop = min(n, start + chunk)
            arr[start:stop] = rng.uniform(-bound, bound, size=(stop - start, dim)).astype(np.float32)
        np.save(os.path.join(tdir, "emb_vector.npy"), arr)
        print(f"wrote {tdir}/emb_vector.npy  [{n} x {dim}]")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Generate random embedding snapshot")
    p.add_argument("--embedding-size", type=str, default="39884406-39043-17289-7420-20263-3-7120-1543-63",
                   help="dash-separated per-table vocabulary sizes")
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--names", type=str, default=None, help="comma-separated table names")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    sizes = [int(s) for s in args.embedding_size.split("-") if s]
    generate(sizes, args.dim, args.output, names=args.names.split(",") if args.names else None, seed=args.seed)


if __name__ == "__main__":
    main()
