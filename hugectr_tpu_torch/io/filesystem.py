"""File layer of snapshots and weight files (counterpart of
hugectr_tpu/io/filesystem.py, of which it is a copy, plus the bfloat16
codec).

A local path takes the `os` fast path. A path with `://` (`hdfs://`,
`s3://`, `gs://`, `memory://`) goes through `fsspec`, imported only then;
a missing driver raises `RuntimeError`.

bfloat16. The JAX package writes a bfloat16 array with `np.save`, and the
file holds numpy's view of `ml_dtypes.bfloat16`: the header's descr is
`'<V2'` and each value is its two raw bytes. The port writes a
`torch.bfloat16` tensor (or an `ml_dtypes` array) as the same bytes, from
its int16 bits, and reads any 2-byte void array back as `torch.bfloat16`
(`decode`), with numpy and `Tensor.view` alone: no `ml_dtypes` is needed.
Every other array is written and read by numpy as it is, so each file keeps
its array's own dtype, as the JAX package's do.
"""
from __future__ import annotations

import io as _io
import os
from typing import Any, List

import numpy as np
import torch

# numpy's descr of ml_dtypes.bfloat16, as the JAX package's files hold it
BF16_DESCR = "<V2"


class FileSystem:
    """Thin fsspec wrapper with a local fast path (filesystem.py:19)."""

    def __init__(self, url_or_path: str = ""):
        self.is_remote = "://" in url_or_path
        if self.is_remote:
            import fsspec

            protocol = url_or_path.split("://", 1)[0]
            try:
                self.fs = fsspec.filesystem(protocol)
            except (ImportError, ValueError) as e:
                raise RuntimeError(
                    f"filesystem backend {protocol!r} needs its fsspec driver installed: {e}"
                ) from e
        else:
            self.fs = None

    def open(self, path: str, mode: str = "rb"):
        if self.fs is None:
            if "w" in mode:
                os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
            return open(path, mode)
        return self.fs.open(path, mode)

    def exists(self, path: str) -> bool:
        if self.fs is None:
            return os.path.exists(path)
        return self.fs.exists(path)

    def read(self, path: str) -> bytes:
        with self.open(path, "rb") as f:
            return f.read()


def makedirs(path: str) -> None:
    fs = FileSystem(path)
    if fs.fs is None:
        os.makedirs(path, exist_ok=True)
    else:
        fs.fs.makedirs(path, exist_ok=True)


def exists(path: str) -> bool:
    return FileSystem(path).exists(path)


def isdir(path: str) -> bool:
    fs = FileSystem(path)
    if fs.fs is None:
        return os.path.isdir(path)
    try:
        return fs.fs.isdir(path)
    except Exception:
        return fs.fs.exists(path)


def listdir(path: str) -> List[str]:
    """The names in a directory, sorted (a remote `ls` without details)."""
    fs = FileSystem(path)
    if fs.fs is None:
        return sorted(os.listdir(path))
    return sorted(os.path.basename(p.rstrip("/")) for p in fs.fs.ls(path, detail=False))


def open_file(path: str, mode: str = "rb"):
    return FileSystem(path).open(path, mode)


# ------------------------------------------------------------ bfloat16 codec
def _is_bf16_bits(a: Any) -> bool:
    """A numpy array of 2-byte voids: a bfloat16 file's array, or an
    `ml_dtypes.bfloat16` one."""
    return isinstance(a, np.ndarray) and a.dtype.kind == "V" and a.dtype.itemsize == 2


def decode(a: Any) -> Any:
    """A loaded array as the port holds it: 2-byte voids as
    `torch.bfloat16` (CPU), anything else unchanged."""
    if _is_bf16_bits(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return a


def host(arr: Any) -> np.ndarray:
    """A tensor or array as a host numpy array of its own dtype; bfloat16
    as its int16 bits viewed as 2-byte voids."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    a = np.asarray(arr)
    return a.view(np.dtype("V2")) if _is_bf16_bits(a) else a


def _write_npy(f, arr: Any) -> None:
    a = host(arr)
    if _is_bf16_bits(a):
        # np.save's header with the descr of ml_dtypes.bfloat16, then the bits
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False, "shape": a.shape})
        f.write(np.ascontiguousarray(a).tobytes())
    else:
        np.save(f, a)


def save_npy(path: str, arr: Any) -> None:
    with open_file(path, "wb") as f:
        _write_npy(f, arr)


def load_npy(path: str) -> Any:
    """A numpy array, or a `torch.bfloat16` tensor for a bfloat16 file."""
    fs = FileSystem(path)
    if fs.fs is None:
        return decode(np.load(path))
    return decode(np.load(_io.BytesIO(fs.read(path))))


def save_npz(path: str, **arrays: Any) -> None:
    """An `.npz` of numpy arrays or tensors; bfloat16 members are not
    taken (no `.npz` of the JAX package holds one)."""
    members = {k: host(v) for k, v in arrays.items()}
    bf16 = [k for k, a in members.items() if _is_bf16_bits(a)]
    if bf16:
        raise ValueError(f"save_npz: bfloat16 members {bf16}")
    with open_file(path, "wb") as f:
        np.savez(f, **members)


def load_npz(path: str):
    fs = FileSystem(path)
    if fs.fs is None:
        return np.load(path)
    # npz members need random access; buffer remote bytes
    return np.load(_io.BytesIO(fs.read(path)))
