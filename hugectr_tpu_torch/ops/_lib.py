"""Builds the hand-written CUDA kernels and binds them with ctypes.

Every `.cu` file of `hugectr_tpu_torch/csrc/` is compiled by its own `nvcc`
process for `sm_90a` (all started together), then linked into one shared
library with a plain C interface under `build/kernels/` at the repo root.
The library's name carries a hash of the sources and flags, so an edit to a
source rebuilds it and an unchanged tree reuses it. Nothing is built when a
module is imported: the first launch on a CUDA tensor builds and loads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# -Xptxas -v writes each kernel's registers and spills into the build log
FLAGS = ["-std=c++17", "-O3", ARCH, "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes of csrc/common.cuh
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
# name: (argument types, return type)
_SIGNATURES = {
    # dtype, out_dtype, vals, rowsrc (or null), heads, out, scratch, k, count (or null), e, vec, stream
    "hctr_segscan": ([_I, _I, _P, _P, _P, _P, _P, _I64, _P, _I, _I, _P], _I),
    # k, e -> scratch bytes (-1: e too wide)
    "hctr_segscan_scratch_bytes": ([_I64, _I], _I64),
    "hctr_segscan_tile_rows": ([], _I),
    # dtype, keys, table, out, b, h, v, e, stream
    "hctr_onehot_fwd": ([_I, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    # dtype, lookups (hctr_fwd_lookup array), n, table, out, b, e, ld, stream
    "hctr_onehot_fwd_group": ([_I, _P, _I, _P, _P, _I, _I, _I, _P], _I),
    # v, h, e -> the forward's route (0 gather, 1 counts matmul)
    "hctr_onehot_fwd_route": ([_I, _I, _I], _I),
    # d_dtype, keys, d, w (or null), grad32, cnt, out_bf16, scratch, scratch bytes, b, h, v, e,
    # accumulate, route, stream
    "hctr_onehot_bwd": ([_I, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _P], _I),
    # d_dtype, lookups (hctr_fwd_lookup array), n, d, ld, grad32, cnt, rows, scratch, scratch bytes,
    # b, e, accumulate, route, stream
    "hctr_onehot_bwd_group": ([_I, _P, _I, _P, _I, _P, _P, _I64, _P, _I64, _I, _I, _I, _I, _P], _I),
    # lookups, n, b, e, ld, route -> scratch bytes of the backward (-1: lookups not taken)
    "hctr_onehot_bwd_scratch": ([_P, _I, _I, _I, _I, _I], _I64),
    # e -> rows of one privatised backward block
    "hctr_onehot_bwd_tile_rows": ([_I], _I),
    # b, h, v, e, weighted -> the backward's route (0 global, 1 privatised, 2 counts matmul)
    "hctr_onehot_bwd_route": ([_I, _I, _I, _I, _I], _I),
    # vals_dtype, dst_dtype, vals, idx, src, dst, k, rows, e, stream
    "hctr_scatter_add_rows": ([_I, _I, _P, _P, _P, _P, _I64, _I64, _I, _P], _I),
    # table_dtype, accum_dtype, table, accum, sidx, g, count, lr, lr_dtype, k, rows, e, eps, rowwise, vec,
    # stream
    "hctr_adagrad_rows": ([_I, _I, _P, _P, _P, _P, _P, _P, _I, _I64, _I64, _I, ctypes.c_float, _I, _I, _P], _I),
    # dtype, table, n_rows, ld, rows, weights (or null), offsets, out, n_slots, e, vec, lanes, per, shift,
    # stream
    "hctr_ordered_pool": ([_I, _P, _I64, _I64, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _P], _I),
}

_lock = threading.Lock()
_lib = None
# what the last build did: {"seconds", "path", "log", "reused"}
build_info: dict = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")
    return nvcc


def build() -> Path:
    """Compile csrc/*.cu into one shared library (or reuse the one whose
    hash matches) and return its path."""
    cus = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for p in [*cus, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    tag = digest.hexdigest()[:16]
    so = BUILD_DIR / f"libhctr_kernels_{tag}.so"
    if so.exists():
        build_info.update(seconds=0.0, path=str(so), log="", reused=True)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for cu in cus:
        # objects named by process: ranks that start together may each build
        obj = BUILD_DIR / f"{cu.stem}_{tag}.{os.getpid()}.o"
        cmd = [nvcc, *FLAGS, "-c", str(cu), "-o", str(obj)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((cu, obj, proc))
    logs, failed = [], []
    for cu, _obj, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {cu.name}\n{out}")
        if proc.returncode:
            failed.append(cu.name)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = BUILD_DIR / f"{so.name}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", ARCH, "-o", str(tmp), *(str(o) for _c, o, _p in jobs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    so.with_suffix(".log").write_text(log)  # ptxas' registers and spills
    os.replace(tmp, so)
    for _c, o, _p in jobs:
        o.unlink()
    build_info.update(seconds=time.perf_counter() - t0, path=str(so), log=log, reused=False)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def vec_width(e: int, *tensors: torch.Tensor) -> int:
    """4 when every row starts on a 4-element boundary (one 16-byte f32 or
    8-byte bf16 access per lane), else 1."""
    ok = e % 4 == 0 and all(t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors)
    return 4 if ok else 1


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
