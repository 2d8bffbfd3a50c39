"""Criteo TSV to Raw binary (counterpart of tools/criteo_to_raw.py).

Two engines, chosen with `--engine`: `native` (the default) builds the
multithreaded converter `csrc/criteo_convert.cpp` with g++ into
`build/native/` at first use and runs it; a failed build raises with the
compiler's message and does not fall back. `numpy` is the streaming Python
converter. Both write the same bytes: fixed-stride int32 rows [label][13
int dense][26 categorical] (the MLPerf raw layout, python_interface.md:
362-383), which the Raw readers read (they apply log(x + 1) to the dense
features); a categorical is its hex id modulo `--vocab_cap`.

`--remap` renumbers every categorical vocabulary by descending frequency
(id 0 = the most frequent, ties by id), so that the hot/cold split
(`Solver.hot_rows`) holds the most frequent rows; it changes speed, never
results.

    python -m hugectr_tpu_torch.tools.criteo_to_raw --input day_0.tsv --output day_0.bin [--remap]
"""
from __future__ import annotations

import argparse
import os
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "criteo_convert.cpp"
FLAGS = ["-O3", "-std=c++17", "-pthread"]


def build() -> Path:
    """The converter's executable, built at first use (or reused while its
    source and flags are unchanged); raises RuntimeError with g++'s output."""
    from ..data.native_reader import gxx_build

    return gxx_build(SOURCE, "criteo_convert", FLAGS, "the Criteo converter")


def convert_numpy(args) -> int:
    """Streaming converter: bounded memory whatever the input's size. Pass 1
    parses TSV lines into chunks appended to the output file; `--remap` then
    rewrites the file through a memmap, one categorical column at a time
    (bincount, rank table, chunked rewrite), as the native converter's two
    passes do. Returns the rows written."""
    import numpy as np

    chunk_rows = 1 << 18
    rows_written = 0
    with open(args.output, "wb") as out, open(args.input, "rb") as f:
        block = []
        for line in f:
            parts = line.rstrip(b"\n\r").split(b"\t")
            parts += [b""] * (40 - len(parts))
            row = np.zeros(40, np.int32)
            row[0] = int(parts[0] or 0)
            for j in range(13):
                row[1 + j] = int(parts[1 + j] or 0)
            for j in range(26):
                c = parts[14 + j]
                row[14 + j] = (int(c, 16) if c else 0) % args.vocab_cap
            block.append(row)
            rows_written += 1
            if len(block) >= chunk_rows:
                out.write(np.stack(block).tobytes())
                block.clear()
            if args.max_rows and rows_written >= args.max_rows:
                break
        if block:
            out.write(np.stack(block).tobytes())

    if args.remap and rows_written:
        mm = np.memmap(args.output, dtype=np.int32, mode="r+", shape=(rows_written, 40))
        for col in range(14, 40):
            maxv = max(int(np.asarray(mm[s : s + chunk_rows, col]).max(initial=0))
                       for s in range(0, rows_written, chunk_rows))
            counts = np.zeros(maxv + 1, np.int64)
            for s in range(0, rows_written, chunk_rows):
                counts += np.bincount(np.asarray(mm[s : s + chunk_rows, col]), minlength=maxv + 1)
            present = np.flatnonzero(counts)
            order = np.lexsort((present, -counts[present]))  # frequency descending, id ascending
            lut = np.zeros(maxv + 1, np.int32)
            lut[present[order]] = np.arange(len(present), dtype=np.int32)
            for s in range(0, rows_written, chunk_rows):
                mm[s : s + chunk_rows, col] = lut[np.asarray(mm[s : s + chunk_rows, col])]
        mm.flush()
        del mm
    return rows_written


def main(argv=None) -> None:
    p = argparse.ArgumentParser("criteo_to_raw")
    p.add_argument("--input", required=True, help="criteo day .tsv/.txt")
    p.add_argument("--output", required=True, help="raw .bin output")
    p.add_argument("--vocab_cap", type=int, default=40_000_000)
    p.add_argument("--threads", type=int, default=os.cpu_count() or 8)
    p.add_argument("--max_rows", type=int, default=0)
    p.add_argument("--remap", action="store_true")
    p.add_argument("--engine", default="native", choices=["native", "numpy"],
                   help="native: csrc/criteo_convert.cpp built with g++; numpy: the Python converter")
    args = p.parse_args(argv)
    if args.engine == "numpy":
        n = convert_numpy(args)
        print(f"criteo_to_raw (numpy): wrote {n} rows")
        return
    cmd = [str(build()), "--input", args.input, "--output", args.output, "--vocab_cap", str(args.vocab_cap),
           "--threads", str(args.threads)]
    if args.max_rows:
        cmd += ["--max_rows", str(args.max_rows)]
    if args.remap:
        cmd += ["--remap"]
    subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main()
