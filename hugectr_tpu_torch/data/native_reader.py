"""The threaded Raw reader over the C++ core `csrc/raw_reader.cpp`
(counterpart of hugectr_tpu/data/native_reader.py).

The core is built at first use, never at import: g++ (`-O3 -std=c++17
-shared -fPIC -pthread`) into `build/native/` under the repo root, the
library named by a hash of its source and flags, so an edit rebuilds it and
an unchanged tree reuses it. A failed build raises with the compiler's
output: there is no fallback to the Python reader.

The core reads whole global batches only: the rows past the last one are
never read, whatever `drop_incomplete_batch` says (raw_reader.cpp "drop
tail"), and it reads batches in file order (no shuffle), as the JAX
package's native reader does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

from .reader import BaseReader, Batch, BatchSpec, RawReader

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "raw_reader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None


def gxx_build(source: Path, stem: str, flags, what: str, suffix: str = "") -> Path:
    """Compile `source` with g++ and `flags` into `build/native/{stem}_{hash}{suffix}`
    (or reuse the file whose hash of source and flags matches) and return
    its path; raises RuntimeError with g++'s output if it fails."""
    digest = hashlib.sha256(" ".join(flags).encode())
    digest.update(source.read_bytes())
    out = BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}{suffix}"
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"{what} needs g++, which is not on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.name}.{os.getpid()}.tmp"  # processes that start together may each build
    r = subprocess.run([cxx, *flags, str(source), "-o", str(tmp)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"g++ failed to build {what} ({source}):\n{r.stderr}")
    os.replace(tmp, out)
    return out


def build() -> Path:
    """Compile the core (or reuse the library whose hash matches) and
    return its path; raises RuntimeError with g++'s output if it fails."""
    return gxx_build(SOURCE, "libraw_reader", FLAGS, "the native Raw reader", ".so")


def library() -> ctypes.CDLL:
    """The loaded core, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.rr_open.restype = ctypes.c_void_p
            lib.rr_open.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
                                    ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_long]
            lib.rr_num_batches.restype = ctypes.c_long
            lib.rr_num_batches.argtypes = [ctypes.c_void_p]
            lib.rr_next.restype = ctypes.c_long
            lib.rr_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.rr_reset.argtypes = [ctypes.c_void_p]
            lib.rr_close.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


class NativeRawReader(BaseReader):
    """Raw (RawAsync) batches from the C++ core's `n_threads` fill threads
    and its ring of `queue_depth` buffers (native_reader.py:96). Batch b of
    rank `process_index` is the file's rows [b * G + process_index * B, +B)
    of global batch G = B * `num_processes`; a batch decodes as
    `RawReader`'s do. Iterating again rewinds to batch 0; `close()` stops
    the threads."""

    def __init__(
        self,
        path: str,
        spec: BatchSpec,
        num_samples: int = 0,
        float_label_dense: bool = False,
        repeat: bool = True,
        n_threads: int = 4,
        queue_depth: int = 6,
        process_index: int = 0,
        num_processes: int = 1,
        fused: bool = False,
    ):
        self.lib = library()
        self.fused = fused
        self.spec = spec
        self.path = path
        self.float_label_dense = float_label_dense
        self.repeat = repeat
        self.row_width = spec.row_width
        limit = num_samples // (spec.batch_size * num_processes) if num_samples else 0
        self._handle = self.lib.rr_open(
            path.encode(), 4 * self.row_width, spec.batch_size, spec.batch_size * num_processes,
            process_index * spec.batch_size, n_threads, queue_depth, 1 if repeat else 0, limit,
        )
        if not self._handle:
            raise RuntimeError(f"native Raw reader: cannot open {path} or it holds no whole global batch "
                               f"of {spec.batch_size * num_processes} rows")
        self.num_batches = int(self.lib.rr_num_batches(self._handle))
        self._buf = np.empty((spec.batch_size, self.row_width), dtype=np.int32)
        self._consumed_any = False

    def __iter__(self) -> Iterator[Batch]:
        if self._handle is None:
            raise RuntimeError("native Raw reader: iterated after close()")
        if self._consumed_any:
            self.lib.rr_reset(self._handle)
        self._consumed_any = True
        served = 0
        while True:
            rows = self.lib.rr_next(self._handle, self._buf.ctypes.data_as(ctypes.c_void_p))
            if rows == 0:
                return
            served += 1
            yield self._decode(self._buf[:rows].copy())
            if not self.repeat and served >= self.num_batches:
                return

    _decode = RawReader._decode

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self.lib.rr_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

