"""Synthetic dataset generator (counterpart of tools/data_generator.py): the
same flags over the port's `DataGenerator`, which writes Raw files
byte-equal to the JAX package's (Parquet needs `pyarrow`).

    python -m hugectr_tpu_torch.tools.data_generator --format parquet \\
        --source ./dcn_data/file_list.txt --eval_source ./dcn_data/file_list_test.txt \\
        --slot_size_array 39884,39043,17289,7420,20263,3,7120,1543,63,38532 \\
        --num_files 8 --num_samples_per_file 40960
"""
from __future__ import annotations

import argparse

from ..core.types import DataReaderType_t, PowerLaw_t
from ..data.generator import DataGenerator, DataGeneratorParams


def main(argv=None) -> None:
    p = argparse.ArgumentParser("data_generator")
    p.add_argument("--format", default="parquet", choices=["parquet", "raw", "raw_async"])
    p.add_argument("--source", required=True)
    p.add_argument("--eval_source", required=True)
    p.add_argument("--slot_size_array", required=True)
    p.add_argument("--nnz_array", default="")
    p.add_argument("--label_dim", type=int, default=1)
    p.add_argument("--dense_dim", type=int, default=13)
    p.add_argument("--num_files", type=int, default=8)
    p.add_argument("--eval_num_files", type=int, default=2)
    p.add_argument("--num_samples_per_file", type=int, default=40960)
    p.add_argument("--num_samples", type=int, default=0, help="raw: total rows")
    p.add_argument("--eval_num_samples", type=int, default=0)
    p.add_argument("--dist", default="powerlaw", choices=["powerlaw", "uniform"])
    p.add_argument("--power_law_type", default="specific", choices=["long", "medium", "short", "specific"])
    p.add_argument("--alpha", type=float, default=1.2)
    p.add_argument("--float_label_dense", action="store_true")
    p.add_argument("--i64_input_key", action="store_true")
    a = p.parse_args(argv)

    slots = [int(x) for x in a.slot_size_array.split(",")]
    nnz = [int(x) for x in a.nnz_array.split(",")] if a.nnz_array else [1] * len(slots)
    DataGenerator(DataGeneratorParams(
        format=DataReaderType_t(a.format), label_dim=a.label_dim, dense_dim=a.dense_dim, num_slot=len(slots),
        i64_input_key=a.i64_input_key, source=a.source, eval_source=a.eval_source, slot_size_array=slots,
        nnz_array=nnz, dist_type=a.dist, power_law_type=PowerLaw_t(a.power_law_type), alpha=a.alpha,
        num_files=a.num_files, eval_num_files=a.eval_num_files, num_samples_per_file=a.num_samples_per_file,
        num_samples=a.num_samples, eval_num_samples=a.eval_num_samples, float_label_dense=a.float_label_dense,
    )).generate()
    print(f"wrote train={a.source} eval={a.eval_source}")


if __name__ == "__main__":
    main()
