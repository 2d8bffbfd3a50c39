"""Criteo TSV to Parquet (counterpart of tools/criteo_preprocess.py): label
and 13 integer features and 26 hex categoricals a line; writes
`file_list.txt`, the Parquet parts under `file_list.txt.d/` and their
`_metadata.json`, the layout the port's Parquet reader reads. The dense
features become log(max(x, -2) + 3), a missing one counting as 0; a
categorical is its hex id modulo `--vocab_cap` (missing: 0).
`--frequency-remap` then renumbers each categorical column by descending
frequency (id 0 = the most frequent), for the hot/cold split.

Needs `pyarrow`, so it runs where that is installed (not on the card's
machine); the JAX tool parses with pandas, this one without.

    python -m hugectr_tpu_torch.tools.criteo_preprocess --input day_0.tsv --out_dir ./criteo_parquet
"""
from __future__ import annotations

import argparse
import itertools
import json
import os

import numpy as np


def _chunks(path: str, rows: int):
    """Lists of at most `rows` split TSV lines, padded to 40 fields."""
    with open(path, "rb") as f:
        while True:
            block = list(itertools.islice(f, rows))
            if not block:
                return
            out = []
            for line in block:
                parts = line.rstrip(b"\n\r").split(b"\t")
                out.append(parts + [b""] * (40 - len(parts)))
            yield out


def _columns(lines, vocab_cap: int):
    """(labels float32 [n], dense float32 [n, 13], categoricals int32 [n, 26])."""
    lab = np.array([float(p[0] or 0) for p in lines], np.float32)
    dense = np.array([[float(x or 0) for x in p[1:14]] for p in lines], np.float64).reshape(-1, 13)
    dense = np.log(dense.clip(min=-2) + 3.0).astype(np.float32)
    cats = np.array([[int(x, 16) if x else 0 for x in p[14:40]] for p in lines], np.int64).reshape(-1, 26)
    return lab, dense, (cats % vocab_cap).astype(np.int32)


def main(argv=None) -> None:
    p = argparse.ArgumentParser("criteo_preprocess")
    p.add_argument("--input", required=True, help="criteo .tsv / .txt")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--vocab_cap", type=int, default=40_000_000)
    p.add_argument("--rows_per_file", type=int, default=2_000_000)
    p.add_argument("--max_rows", type=int, default=0)
    p.add_argument("--frequency-remap", action="store_true",
                   help="renumber each categorical vocabulary by descending frequency (id 0 = most "
                   "frequent), for the hot/cold split (Solver.hot_rows); changes speed, never results")
    a = p.parse_args(argv)

    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(a.out_dir, exist_ok=True)
    data_dir = os.path.join(a.out_dir, "file_list.txt.d")
    os.makedirs(data_dir, exist_ok=True)
    file_stats, paths = [], []
    total = 0
    for fi, lines in enumerate(_chunks(a.input, a.rows_per_file)):
        if a.max_rows and total >= a.max_rows:
            break
        lab, dense, cats = _columns(lines, a.vocab_cap)
        cols = [pa.array(lab)] + [pa.array(dense[:, i]) for i in range(13)] + [pa.array(cats[:, i])
                                                                               for i in range(26)]
        names = ["label0"] + [f"C{i}" for i in range(13)] + [f"CAT{i}" for i in range(26)]
        fname = f"part_{fi}.parquet"
        pq.write_table(pa.table(cols, names=names), os.path.join(data_dir, fname))
        file_stats.append({"file_name": fname, "num_rows": len(lines)})
        paths.append(os.path.join(data_dir, fname))
        total += len(lines)
        print(f"wrote {fname} rows={len(lines)} total={total}")

    meta = {
        "file_stats": file_stats,
        "labels": [{"col_name": "label0", "index": 0}],
        "conts": [{"col_name": f"C{i}", "index": 1 + i} for i in range(13)],
        "cats": [{"col_name": f"CAT{i}", "index": 14 + i} for i in range(26)],
    }
    with open(os.path.join(data_dir, "_metadata.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(a.out_dir, "file_list.txt"), "w") as f:
        f.write(f"{len(paths)}\n")
        f.writelines(q + "\n" for q in paths)
    print(f"done: {total} rows, {len(paths)} files")
    if a.frequency_remap:
        frequency_remap(paths)


def frequency_remap(paths) -> None:
    """Renumber the categorical ids of columns CAT0..CAT25 by descending
    frequency over all the files, ties in the order the ids were first
    counted (ascending within a file, files in order), as the JAX tool does."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    counts = {}
    for path in paths:
        tbl = pq.read_table(path)
        for name in tbl.column_names:
            if name.startswith("CAT"):
                u, c = np.unique(tbl[name].to_numpy(zero_copy_only=False), return_counts=True)
                acc = counts.setdefault(name, {})
                for k, n in zip(u.tolist(), c.tolist()):
                    acc[k] = acc.get(k, 0) + n
    remap = {name: {k: i for i, (k, _) in enumerate(sorted(acc.items(), key=lambda kv: -kv[1]))}
             for name, acc in counts.items()}
    for path in paths:
        tbl = pq.read_table(path)
        cols = []
        for name in tbl.column_names:
            if name.startswith("CAT"):
                m = remap[name]
                col = tbl[name].to_numpy(zero_copy_only=False)
                cols.append(pa.array(np.array([m[k] for k in col.tolist()], np.int32)))
            else:
                cols.append(tbl[name])
        pq.write_table(pa.table(cols, names=tbl.column_names), path, row_group_size=65536)
    print("frequency remap: done")


if __name__ == "__main__":
    main()
