"""The port's dataset writer and readers against the JAX package's, on the
same files, on the CPU.

The port's `DataGenerator` writes Raw (int and float layouts) and Norm
(`Check_t.Sum` and `Non`, u32 and i64 keys) files byte-equal to the JAX
generator's for the same parameters; for Parquet, the same columns, the
same `_metadata.json` and the same file lists. Every reader yields batches
`np.array_equal` to its JAX counterpart's: the Python Raw reader, the
native threaded one, Norm (the fixed-stride path and the record walk),
Parquet and the threaded Parquet reader, fused and per feature, with
`num_samples`, shuffle, repeat and a second pass, the padded tail and its
`ROWS_KEY`, and the per-rank blocks or file shards at W = 2. The on-device
split of a fused batch equals the JAX package's `_decode_batch`: bitwise in
the float layout; `log1p` of int dense within rtol 2e-7 (one float32 ulp:
two libm implementations).
"""
import filecmp
import itertools
import json
import os
import sys
import threading
import types

import jax
import numpy as np
import pytest
import torch

from hugectr_tpu.data import generator as jg
from hugectr_tpu.data import native_reader as jn
from hugectr_tpu.data import reader as jr
from hugectr_tpu.model.model import Model as JaxModel
from hugectr_tpu_torch.data import generator as tg
from hugectr_tpu_torch.data import native_reader as tn
from hugectr_tpu_torch.data import reader as tr
from hugectr_tpu_torch.model.model import Model as TorchModel

SLOTS = [10, 100, 1000, 50]
NNZ = [1, 2, 3, 1]


def gen_params(pkg, fmt: str, out: str, **kw):
    """Generator parameters of package `pkg` ("t" or "j") writing `fmt`
    train and eval data under `out`."""
    mod = tg if pkg == "t" else jg
    base = dict(format=fmt, label_dim=1, dense_dim=3, num_slot=4, slot_size_array=SLOTS, nnz_array=NNZ,
                num_files=3, eval_num_files=1, num_samples_per_file=150, num_samples=1000, eval_num_samples=300,
                source=os.path.join(out, "train.txt" if fmt != "raw_async" else "train.bin"),
                eval_source=os.path.join(out, "eval.txt" if fmt != "raw_async" else "eval.bin"))
    base.update(kw)
    return mod.DataGeneratorParams(**base)


def write_both(tmp_path, fmt: str, **kw):
    """The same dataset written by both packages; returns (port dir, JAX dir)."""
    dirs = []
    for pkg in ("t", "j"):
        d = str(tmp_path / pkg)
        (tg if pkg == "t" else jg).DataGenerator(gen_params(pkg, fmt, d, **kw)).generate()
        dirs.append(d)
    return dirs


def specs(batch: int, key_dtype=np.int32, nnz=NNZ):
    """(port BatchSpec, JAX BatchSpec) of the datasets above: one feature
    of 4 slots."""
    out = []
    for mod in (tr, jr):
        out.append(mod.BatchSpec(batch, (1,), ("label",), 3, "dense",
                                 (mod.SparseFeatureSpec("keys", tuple(nnz)),), key_dtype=key_dtype))
    return out


def assert_batches_equal(got, want):
    assert len(got) == len(want) and len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), i
        for k in w:
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, (i, k)
            assert np.array_equal(g[k], w[k]), (i, k)


def take(reader, n=None):
    return list(reader) if n is None else list(itertools.islice(iter(reader), n))


# ------------------------------------------------------------------- writer
@pytest.mark.parametrize("float_label_dense", [False, True], ids=["int", "float"])
def test_raw_files_are_byte_equal(tmp_path, float_label_dense):
    t, j = write_both(tmp_path, "raw_async", float_label_dense=float_label_dense)
    for name in ("train.bin", "eval.bin"):
        assert filecmp.cmp(os.path.join(t, name), os.path.join(j, name), shallow=False), name
    assert os.path.getsize(os.path.join(t, "train.bin")) == 1000 * 4 * (1 + 3 + sum(NNZ))


@pytest.mark.parametrize("check", ["sum", "none"])
@pytest.mark.parametrize("i64", [False, True], ids=["u32", "i64"])
def test_norm_files_are_byte_equal(tmp_path, check, i64):
    t, j = write_both(tmp_path, "norm", check_type=check, i64_input_key=i64)
    for lst in ("train.txt", "eval.txt"):
        tp = open(os.path.join(t, lst)).read().split()
        jp = open(os.path.join(j, lst)).read().split()
        assert tp[0] == jp[0] and [os.path.basename(p) for p in tp[1:]] == [os.path.basename(p) for p in jp[1:]]
        for a, b in zip(tp[1:], jp[1:]):
            assert filecmp.cmp(a, b, shallow=False), a


def test_parquet_columns_metadata_and_lists_are_equal(tmp_path):
    pq = pytest.importorskip("pyarrow.parquet")
    t, j = write_both(tmp_path, "parquet")
    for lst in ("train.txt", "eval.txt"):
        tp = open(os.path.join(t, lst)).read().split()
        jp = open(os.path.join(j, lst)).read().split()
        assert tp[0] == jp[0] and [os.path.relpath(p, t) for p in tp[1:]] == [os.path.relpath(p, j) for p in jp[1:]]
        ddir = lst + ".d"
        assert json.load(open(os.path.join(t, ddir, "_metadata.json"))) == json.load(
            open(os.path.join(j, ddir, "_metadata.json")))
        for a, b in zip(tp[1:], jp[1:]):
            ta, tb = pq.read_table(a), pq.read_table(b)
            assert ta.schema == tb.schema and ta.equals(tb), a


# ---------------------------------------------------------------- Raw readers
RAW_CASES = {
    # name: (constructor kwargs, batch, passes)
    "fused": (dict(fused=True), 128, 1),
    "split_int": (dict(), 128, 1),
    "split_float": (dict(float_label_dense=True), 128, 1),
    "num_samples": (dict(num_samples=700, fused=True), 128, 1),
    "tail": (dict(drop_incomplete=False, repeat=False), 128, 1),
    "tail_fused": (dict(drop_incomplete=False, repeat=False, fused=True), 128, 1),
    "shuffle_repeat": (dict(shuffle=True, seed=3), 128, 3),
}


@pytest.fixture(scope="module")
def raw_file(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("raw"))
    tg.DataGenerator(gen_params("t", "raw_async", d)).generate()
    return os.path.join(d, "train.bin")


@pytest.mark.parametrize("case", list(RAW_CASES))
def test_raw_reader_matches_jax(raw_file, case):
    kw, batch, passes = RAW_CASES[case]
    ts, js = specs(batch)
    got = take(tr.RawReader(raw_file, ts, **kw), 7 * passes + 1 if kw.get("repeat", True) else None)
    want = take(jr.RawReader(raw_file, js, **kw), 7 * passes + 1 if kw.get("repeat", True) else None)
    assert_batches_equal(got, want)
    if case.startswith("tail"):  # 1000 rows: 7 batches and a tail of 104 rows, padded
        assert len(got) == 8 and int(got[-1][tr.ROWS_KEY]) == 1000 - 7 * 128
        assert all(tr.ROWS_KEY not in b for b in got[:-1])
        rows = got[-1][tr.FUSED_KEY] if "fused" in case else got[-1]["keys"]
        assert (rows[104:] == rows[103]).all()  # the last row repeated


def test_raw_reader_blocks_at_two_ranks(raw_file):
    """Rank r of 2 reads rows [g * 256 + r * 128, +128): both ranks' blocks
    make the one-process reader's global batch of 256."""
    ts, _ = specs(128)
    _, js = specs(256)
    ranks = [take(tr.RawReader(raw_file, ts, fused=True, repeat=False, process_index=r, num_processes=2))
             for r in range(2)]
    whole = take(jr.RawReader(raw_file, js, fused=True, repeat=False))
    assert len(ranks[0]) == len(ranks[1]) == len(whole) == 3
    for g in range(3):
        np.testing.assert_array_equal(
            np.concatenate([ranks[0][g][tr.FUSED_KEY], ranks[1][g][tr.FUSED_KEY]]), whole[g][jr.FUSED_KEY])


@pytest.mark.parametrize("case", ["fused", "split_float", "num_samples", "two_ranks"])
def test_native_reader_matches_jax(raw_file, case):
    """The native reader (threads, ring, in-order hand-off) against the JAX
    package's on the same file, two passes (the second rewinds), then
    `close()`; the tail past the last whole batch is never read."""
    kw = dict(fused=True, repeat=False, n_threads=3, queue_depth=2)
    batch, ranks = 128, [(0, 1)]
    if case == "split_float":
        kw.update(fused=False, float_label_dense=True)
    elif case == "num_samples":
        kw.update(num_samples=700)
    elif case == "two_ranks":
        batch, ranks = 64, [(0, 2), (1, 2)]
    ts, js = specs(batch)
    for r, w in ranks:
        t = tn.NativeRawReader(raw_file, ts, process_index=r, num_processes=w, **kw)
        j = jn.NativeRawReader(raw_file, js, process_index=r, num_processes=w, **kw)
        try:
            first, second, want = take(t), take(t), take(j)
            assert_batches_equal(first, want)
            assert_batches_equal(second, want)
            n = (700 if case == "num_samples" else 1000) // (batch * w)
            assert t.num_batches == len(first) == n
            assert all(tr.ROWS_KEY not in b for b in first)
        finally:
            t.close()
            j.close()
    with pytest.raises(RuntimeError, match="after close"):
        next(iter(t))


def test_native_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s message; nothing
    falls back to the Python reader."""
    bad = tmp_path / "raw_reader.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(tn, "SOURCE", bad)
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*error"):
        tn.build()
    assert not list((tmp_path / "build").glob("*.so"))


# ------------------------------------------------------------------ Norm
def write_variable_norm(path: str, n: int, nnz_max, seed: int = 0, i64: bool = False):
    """A Check_t.Sum Norm file whose records have 0..nnz_max[s] keys in slot
    s (the record walk's input; the generator writes fixed nnz only)."""
    rng = np.random.default_rng(seed)
    kdt = np.dtype("<i8") if i64 else np.dtype("<u4")

    def unit(payload: bytes) -> bytes:
        return (np.int32(len(payload)).tobytes() + payload
                + np.uint8(np.frombuffer(payload, np.uint8).sum(dtype=np.uint64) & 0xFF).tobytes())

    with open(path, "wb") as f:
        f.write(unit(np.array([1, n, 1, 3, len(nnz_max), 0, 0, 0], "<i8").tobytes()))
        for _ in range(n):
            rec = [rng.random(4).astype("<f4").tobytes()]
            for m in nnz_max:
                k = int(rng.integers(0, m + 1))
                rec.append(np.int32(k).tobytes())
                rec.append(rng.integers(0, 2**40 if i64 else 2**31, size=k).astype(kdt).tobytes())
            f.write(unit(b"".join(rec)))


@pytest.fixture(scope="module")
def norm_lists(tmp_path_factory):
    """{name: file list} of Norm datasets: fixed nnz framed (u32, i64) and
    unframed, and variable nnz framed (the walk)."""
    d = tmp_path_factory.mktemp("norm")
    out = {}
    for name, kw in (("sum_u32", dict(check_type="sum")), ("sum_i64", dict(check_type="sum", i64_input_key=True)),
                     ("none_u32", dict(check_type="none"))):
        p = gen_params("t", "norm", str(d / name), **kw)
        tg.DataGenerator(p).generate()
        out[name] = p.source
    files = []
    for i in range(2):
        files.append(str(d / f"var_{i}.data"))
        write_variable_norm(files[-1], 130 + 20 * i, [1, 2, 3, 1], seed=i)
    out["walk"] = str(d / "var.txt")
    with open(out["walk"], "w") as f:
        f.write(f"{len(files)}\n" + "".join(p + "\n" for p in files))
    return out


NORM_CASES = {
    "sum_u32": ("sum_u32", dict(), np.int32),
    "sum_i64": ("sum_i64", dict(), np.int64),
    "none_u32": ("none_u32", dict(), np.int32),
    "offsets": ("sum_u32", dict(slot_size_array=SLOTS), np.int32),
    "wider_hotness": ("sum_u32", dict(nnz=[2, 2, 4, 1]), np.int32),
    "walk": ("walk", dict(), np.int32),
    "tail": ("sum_u32", dict(drop_incomplete=False, repeat=False), np.int32),
    "shuffle_repeat": ("sum_u32", dict(shuffle=True, seed=5), np.int32),
}


@pytest.mark.parametrize("case", list(NORM_CASES))
def test_norm_reader_matches_jax(norm_lists, case):
    name, kw, kdt = NORM_CASES[case]
    kw = dict(kw)
    ts, js = specs(64, kdt, kw.pop("nnz", NNZ))
    n = None if not kw.get("repeat", True) else 12
    got, want = take(tr.NormReader(norm_lists[name], ts, **kw), n), take(jr.NormReader(norm_lists[name], js, **kw), n)
    assert_batches_equal(got, want)
    if case == "tail":  # 450 records: 7 batches of 64 and a padded tail of 2
        assert len(got) == 8 and int(got[-1][tr.ROWS_KEY]) == 2
    if case == "walk":
        assert (got[0]["keys"] == -1).any() and (got[0]["keys"] >= 0).any()
    if case == "offsets":
        assert got[0]["keys"].max() < max(SLOTS)


def test_norm_file_shards_at_two_ranks(norm_lists):
    ts, js = specs(32)
    for r in range(2):
        got = take(tr.NormReader(norm_lists["sum_u32"], ts, repeat=False, process_index=r, num_processes=2))
        want = take(jr.NormReader(norm_lists["sum_u32"], js, repeat=False, process_index=r, num_processes=2))
        assert_batches_equal(got, want)
        assert len(got) == 4  # min over the ranks' shards: 300 and 150 rows


def test_corrupt_norm_record_raises(norm_lists, tmp_path):
    src = open(norm_lists["sum_u32"]).read().split()[1]
    raw = bytearray(open(src, "rb").read())
    raw[69 + 4 + 7] ^= 0x5A  # a byte of the first record's payload
    bad = tmp_path / "bad.data"
    bad.write_bytes(bytes(raw))
    lst = tmp_path / "bad.txt"
    lst.write_text(f"1\n{bad}\n")
    ts, js = specs(64)
    for mod, spec in ((tr, ts), (jr, js)):
        with pytest.raises(mod.NormCheckError, match="record 0 checksum"):
            next(iter(mod.NormReader(str(lst), spec)))


# ---------------------------------------------------------------- Parquet
@pytest.fixture(scope="module")
def parquet_list(tmp_path_factory):
    pytest.importorskip("pyarrow")
    d = str(tmp_path_factory.mktemp("pq"))
    p = gen_params("t", "parquet", d, num_files=3, num_samples_per_file=150)
    tg.DataGenerator(p).generate()
    return p.source


PARQUET_CASES = {
    "fused": dict(fused=True),
    "split": dict(),
    "tail": dict(drop_incomplete=False, repeat=False),
    "tail_fused": dict(drop_incomplete=False, repeat=False, fused=True),
    "shuffle_repeat": dict(shuffle=True, seed=2),
}


@pytest.mark.parametrize("cls", ["ParquetReader", "AsyncParquetReader"])
@pytest.mark.parametrize("case", list(PARQUET_CASES))
def test_parquet_reader_matches_jax(parquet_list, cls, case):
    kw = PARQUET_CASES[case]
    if cls == "AsyncParquetReader":
        kw = dict(kw, n_threads=2, prefetch=2)
    ts, js = specs(64)
    n = None if not kw.get("repeat", True) else 15
    got = take(getattr(tr, cls)(parquet_list, ts, **kw), n)
    want = take(getattr(jr, cls)(parquet_list, js, **kw), n)
    assert_batches_equal(got, want)
    if case.startswith("tail"):  # 450 rows: 7 batches and a tail of 2
        assert len(got) == 8 and int(got[-1][tr.ROWS_KEY]) == 2


def test_parquet_file_shards_at_two_ranks(parquet_list):
    ts, js = specs(32)
    for r in range(2):
        got = take(tr.AsyncParquetReader(parquet_list, ts, repeat=False, process_index=r, num_processes=2))
        want = take(jr.AsyncParquetReader(parquet_list, js, repeat=False, process_index=r, num_processes=2))
        assert_batches_equal(got, want)
        assert len(got) == 4


def test_parquet_without_pyarrow_raises_import_error(parquet_list, monkeypatch):
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError):
        tr.ParquetReader(parquet_list, specs(64)[0])


# ------------------------------------------------------- on-device split
def _decoder(spec, fused_float: bool):
    return types.SimpleNamespace(batch_spec=spec, _fused_float=fused_float)


@pytest.mark.parametrize("fused_float", [True, False], ids=["float", "int"])
def test_device_split_matches_jax_decode(fused_float):
    """`Model._decode_batch` on a fused batch against the JAX package's
    (jax.lax bitcasts and slices): labels, dense and keys."""
    rng = np.random.default_rng(0)
    ts, js = specs(256)
    rows = rng.integers(-50, 10**6, size=(256, ts.row_width)).astype(np.int32)
    if fused_float:
        rows[:, :4] = rng.standard_normal((256, 4)).astype(np.float32).view(np.int32)
    got = TorchModel._decode_batch(_decoder(ts, fused_float), {tr.FUSED_KEY: torch.from_numpy(rows)})
    want = JaxModel._decode_batch(_decoder(js, fused_float), {jr.FUSED_KEY: jax.numpy.asarray(rows)})
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        if k == "dense" and not fused_float:
            np.testing.assert_allclose(g, w, rtol=2e-7, atol=0)
        else:
            assert np.array_equal(g.view(np.int32) if g.dtype == np.float32 else g,
                                  w.view(np.int32) if w.dtype == np.float32 else w), k


# ------------------------------------------------------------ DeviceFeeder
class _ListReader(tr.BaseReader):
    def __init__(self, items, fail_at=None):
        self.items, self.fail_at = items, fail_at

    def __iter__(self):
        for i, x in enumerate(self.items):
            if i == self.fail_at:
                raise ValueError(f"bad batch {i}")
            yield x


def test_device_feeder_order_errors_and_stop():
    """Order kept; the reader's error reaches the consumer; the end of the
    reader ends the iteration; `stop()` on a blocked producer joins it."""
    up = tr.Uploader("cpu")
    items = [{"x": np.full((2, 3), i, np.int32)} for i in range(10)]
    f = tr.DeviceFeeder(_ListReader(items), up, depth=2)
    got = [int(b["x"][0, 0]) for b in f]
    assert got == list(range(10)) and up.bytes == 10 * 24
    f = tr.DeviceFeeder(_ListReader(items, fail_at=4), up, depth=2)
    with pytest.raises(ValueError, match="bad batch 4"):
        list(f)
    f.stop()
    forever = _ListReader(itertools.repeat({"x": np.zeros((1, 1), np.int32)}))
    f = tr.DeviceFeeder(forever, up, depth=2)
    next(iter(f))
    f.stop()
    assert not f._thread.is_alive()
    assert all(t.name != "hctr-device-feeder" for t in threading.enumerate())


def test_uploader_copies_read_only_arrays():
    """A memmap's read-only rows become a tensor of their own."""
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    a.flags.writeable = False
    b = tr.Uploader("cpu")({"x": a})
    b["x"][0, 0] = 7
    assert a[0, 0] == 0 and b.ready() is b
