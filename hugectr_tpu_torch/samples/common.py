"""Shared scaffolding of the sample scripts (counterpart of samples/common.py).

`sample_args` takes the JAX scripts' flags, plus `--device` (the card unless
`--device cpu`). `make_reader` reads the Parquet set in `--data_dir`, and
writes it there first with the port's `DataGenerator` when the directory has
no `file_list.txt` (samples/common.py:40-76). Without `--data_dir` the set
goes to `./_sample_data_torch/<sample>`, never to the JAX package's
`./_sample_data`. Parquet needs `pyarrow`.

`--num_devices` is 0 or the process group's size: the port runs one process
per rank (`torchrun` and `init_distributed()`), not a device mesh in one
process (`ResourceManager.create`).
"""
from __future__ import annotations

import argparse
import os

import hugectr_tpu_torch as hugectr
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import DataReaderType_t


def sample_args(name: str, extra=None) -> argparse.Namespace:
    """The flags of samples/common.py:18-38 (`extra` adds a sample's own,
    e.g. `--variant`), and `--device`; `args.sample` is `name`."""
    p = argparse.ArgumentParser(name)
    if extra is not None:
        extra(p)
    p.add_argument("--data_dir", default="", help="dataset dir (empty = synthetic)")
    p.add_argument("--batchsize", type=int, default=2048)
    p.add_argument("--max_iter", type=int, default=300)
    p.add_argument("--display", type=int, default=100)
    p.add_argument("--eval_interval", type=int, default=300)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--num_devices", type=int, default=0)
    p.add_argument(
        "--use_dynamic_hash_table", action="store_true",
        help="max_vocabulary_size=-1 dynamic tables (where the sample "
        "supports them; reference: samples/ftrl/dlrm_train_ftrl.py:187)",
    )
    add_device_flag(p)
    args = p.parse_args()
    args.sample = name
    return args


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None, help="cuda (the default: the card) or cpu")


def sample_rm(args) -> ResourceManager:
    """The resource manager of the flags: over the initialised process group
    (`--num_devices` 0 or its size), on `--device`."""
    return ResourceManager.create(num_devices=args.num_devices, device=args.device)


def make_reader(
    args,
    slot_size_array,
    nnz_array=None,
    label_dim=1,
    dense_dim=13,
    num_samples_per_file=16384,
    num_files=4,
):
    """Parquet reader over `args.data_dir`, generating synthetic data there
    (or in ./_sample_data_torch/<sample>) when it has no file_list.txt."""
    data_dir = args.data_dir or os.path.join(".", "_sample_data_torch", args.sample)
    train_list = os.path.join(data_dir, "file_list.txt")
    eval_list = os.path.join(data_dir, "file_list_test.txt")
    if not os.path.exists(train_list):
        os.makedirs(data_dir, exist_ok=True)
        hugectr.DataGenerator(
            hugectr.DataGeneratorParams(
                format=DataReaderType_t.Parquet,
                label_dim=label_dim,
                dense_dim=dense_dim,
                num_slot=len(slot_size_array),
                source=train_list,
                eval_source=eval_list,
                slot_size_array=list(slot_size_array),
                nnz_array=list(nnz_array or [1] * len(slot_size_array)),
                num_files=num_files,
                eval_num_files=max(num_files // 2, 1),
                num_samples_per_file=num_samples_per_file,
            )
        ).generate()
    return hugectr.DataReaderParams(
        data_reader_type=DataReaderType_t.Parquet,
        source=[train_list],
        eval_source=eval_list,
        slot_size_array=list(slot_size_array),
    )


def run(model, args) -> None:
    """What each script does under `__main__`: compile, summary, fit."""
    model.compile()
    model.summary()
    model.fit(max_iter=args.max_iter, display=args.display, eval_interval=args.eval_interval)
