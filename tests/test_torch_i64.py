"""64-bit input keys (`Solver.i64_input_key`) against the JAX package on the
CPU.

The fold (model.py:927-1130) runs on the host in numpy in both packages: a
static table takes `k mod vocab`, a dynamic table the exact fold that gives
every distinct 64-bit key its own 31-bit id, two keys whose `_splitmix31`
probes collide included (tests/test_dynamic_table.py:313-368). The same
windows over the same batches give the same int32 keys and the same maps,
in the same insertion order (exact).

The tiny dynamic DLRM-FTRL reads Norm files with i64 keys (the slots'
offsets in the keys, two slots of 2^40 rows, so that keys lie above 2^31)
in both packages from the same carried state: 3 steps within the
tolerances of tests/test_torch_dlrm_ftrl.py, key stores and maps equal.
Its snapshot's `i64_fold_maps.npz` has the JAX package's members, dtypes,
shapes and bytes, and a snapshot of either package loads in the other with
its maps. At W = 2 over gloo, both ranks' maps equal the JAX package's
one-process maps after the same batches of a Raw file.
"""
import json
import os
import threading
import types

import jax
import numpy as np
import pytest
import torch

import hugectr_tpu as jh
import hugectr_tpu_torch as th
from hugectr_tpu.model.model import Model as JaxModel
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.model.model import Model as TorchModel
from hugectr_tpu_torch.tools import flagship as tflagship
from hugectr_tpu_torch.tools import hybrid
from hugectr_tpu_torch.tools.carry import export_state, load_jax_state

from test_dynamic_table import _find_splitmix_collision
from test_torch_file_model import close
from test_torch_file_model_more import ftrl_sample
from test_torch_optimizers import assert_ftrl_close

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
LAMBDA1 = 0.01
EMPTY = 2**31 - 1
CAP = tflagship.TINY_FTRL["vocab_cap"]
# the tiny FTRL slots with tables 20 and 21 at 2^40 rows: with the Norm
# offsets every key of slots 21-25 lies above 2^31
I64_SLOTS = [2**40 if i in (20, 21) else min(v, CAP) for i, v in enumerate(tflagship.FTRL_SLOT_SIZES)]


# ------------------------------------------------------------------ the fold
WINDOWS = {"f": [(0, 2, 100, False, "s"), (2, 4, 0, True, "d"), (4, 6, 0, True, "d"), (6, 7, 0, True, "e")]}


def folder(cls, world: int = 1):
    """An object with what the fold functions of `cls` read."""
    ns = types.SimpleNamespace(_i64_fold=WINDOWS, _i64_maps={}, _i64_rev={}, world=world,
                               _splitmix31=cls._splitmix31, _i64_lock=threading.Lock())
    for name in ("_i64_exact_fold", "_fold_i64_keys", "_i64_fold_maps_arrays", "_restore_i64_fold_maps"):
        setattr(ns, name, getattr(cls, name).__get__(ns))
    return ns


def i64_batches(n: int = 4, seed: int = 0):
    """[16, 7] int64 key batches: a static window, two windows of dynamic
    table "d" and one of "e"; keys up to 2^62, -1 padding, a colliding
    pair, repeats across batches."""
    rng = np.random.default_rng(seed)
    k1, k2 = _find_splitmix_collision()
    out = []
    for i in range(n):
        k = rng.integers(0, 2**62, size=(16, 7), dtype=np.int64)
        k[:, :2] = rng.integers(-1, 500, size=(16, 2))
        k[rng.random((16, 7)) < 0.1] = -1
        k[0, 2], k[1, 4] = k1, k2
        if i:
            k[2:6, 2:5] = out[-1][2:6, 2:5]
        out.append(k)
    return out


def test_fold_gives_the_jax_keys_and_maps():
    t, j = folder(TorchModel), folder(JaxModel)
    for b in i64_batches():
        got, want = t._fold_i64_keys({"f": b})["f"], j._fold_i64_keys({"f": b})["f"]
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert ((got == -1) == (b < 0)).all()
    assert t._i64_maps == j._i64_maps and list(t._i64_maps["d"]) == list(j._i64_maps["d"])
    k1, k2 = _find_splitmix_collision()
    assert t._i64_maps["d"][k1] != t._i64_maps["d"][k2]  # the colliding pair: two ids
    ids = list(t._i64_maps["d"].values())
    assert len(set(ids)) == len(ids) and EMPTY not in ids
    arrays = t._i64_fold_maps_arrays()
    for k, v in j._i64_fold_maps_arrays().items():
        assert arrays[k].dtype == v.dtype and np.array_equal(arrays[k], v), k
    again = folder(TorchModel)
    again._restore_i64_fold_maps(arrays)
    assert again._i64_maps == t._i64_maps and again._i64_rev == t._i64_rev


def test_splitmix_is_the_jax_mix():
    w = np.random.default_rng(1).integers(-(2**63), 2**63 - 1, size=10000, dtype=np.int64)
    np.testing.assert_array_equal(TorchModel._splitmix31(w), JaxModel._splitmix31(w))


# -------------------------------------------------------- the dynamic model
@pytest.fixture(scope="module")
def norm_i64(tmp_path_factory):
    """Norm files with i64 keys: 3 train batches of 32 (one file) and 2
    eval batches."""
    d = tmp_path_factory.mktemp("norm_i64")
    p = th.DataGeneratorParams(format="norm", num_slot=26, slot_size_array=I64_SLOTS, check_type="sum",
                               i64_input_key=True, num_files=1, eval_num_files=1, num_samples_per_file=96,
                               source=str(d / "train.txt"), eval_source=str(d / "eval.txt"), seed=5)
    th.DataGenerator(p).generate()
    return dict(data_reader_type="norm", source=[p.source], eval_source=p.eval_source)


@pytest.fixture(scope="module")
def trained(norm_i64, tmp_path_factory):
    """The JAX and port tiny dynamic DLRM-FTRL with i64 keys after 3 steps
    from the same state, each snapshot written."""
    mp = pytest.MonkeyPatch()
    jm = ftrl_sample(mp, jh.DataReaderParams(**norm_i64), dynamic=True, i64=True)
    tm = tflagship.build_tiny_dlrm_ftrl(ResourceManager.create(device="cpu"), dynamic=True, i64_input_key=True,
                                        reader=th.DataReaderParams(**norm_i64))
    load_jax_state(tm, jax.device_get(jm.state))
    losses = [(tm.train(), jm.train()) for _ in range(3)]
    d = tmp_path_factory.mktemp("snap")
    jm.download_params_to_files(str(d / "jax"), 3)
    tm.download_params_to_files(str(d / "port"), 3)
    yield jm, tm, losses, str(d / "jax_iter3"), str(d / "port_iter3")
    close(jm, tm)
    mp.undo()


def test_dynamic_ftrl_from_i64_norm_matches_jax(trained):
    jm, tm, losses, _, _ = trained
    for step, (tl, jl) in enumerate(losses):
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"loss at step {step + 1}")
    batch = next(iter(tm.train_reader))
    keys = np.concatenate([batch[f"data{i}"] for i in range(26)], axis=1)
    assert keys.dtype == np.int64 and (keys >= 2**31).sum() >= 5 * 32  # slots 21-25, every row
    state = jax.device_get(jm.state)
    np.testing.assert_array_equal(tm.tables["mp_ev128#keys"].numpy(), state["emb_tables"]["mp_ev128#keys"])
    for g, arr in state["emb_tables"].items():
        if not g.endswith("#keys"):
            assert_ftrl_close(tm.tables[g].numpy(), np.asarray(arr), np.asarray(state["eopt"][g]["z"]), LAMBDA1,
                              TOL, f"table {g}")
    assert tm._i64_maps == jm._i64_maps
    assert {t for t in tm._i64_maps} == {str(i) for i in range(26)}
    for m in tm._i64_maps.values():
        assert len(set(m.values())) == len(m)  # injective


def test_i64_fold_maps_file_matches_jax_and_cross_loads(trained):
    jm, tm, _, jdir, tdir = trained
    a, b = np.load(os.path.join(tdir, "i64_fold_maps.npz")), np.load(os.path.join(jdir, "i64_fold_maps.npz"))
    assert a.files == b.files and len(a.files) == 52
    for m in b.files:
        assert a[m].dtype.str == b[m].dtype.str and a[m].shape == b[m].shape and a[m].tobytes() == b[m].tobytes(), m
    with open(os.path.join(tdir, "meta.json")) as f, open(os.path.join(jdir, "meta.json")) as g:
        assert json.load(f) == json.load(g)
    # each package loads the other's snapshot, maps included
    tm2 = tflagship.build_tiny_dlrm_ftrl(ResourceManager.create(device="cpu"), dynamic=True, i64_input_key=True,
                                         seed=9)
    assert tm2._i64_maps == {}
    tm2.load_params_from_files(jdir)
    assert tm2._i64_maps == jm._i64_maps and tm2._i64_rev == jm._i64_rev
    np.testing.assert_array_equal(tm2.tables["mp_ev128#keys"].numpy(),
                                  jax.device_get(jm.state)["emb_tables"]["mp_ev128#keys"])
    jm._i64_maps, jm._i64_rev = {}, {}
    jm.load_params_from_files(tdir)
    assert jm._i64_maps == tm._i64_maps
    assert export_state(tm)["i64_fold_maps"].keys() == jm._i64_fold_maps_arrays().keys()


def test_two_ranks_hold_the_one_process_maps(tmp_path, monkeypatch):
    """The tiny dynamic DLRM-FTRL with i64 keys from a Raw file on 2 gloo
    ranks (each reads its block of every global batch; the ranks' new keys
    are all-gathered) against the JAX package on one device reading the
    whole batches: after 3 steps and an eval over the eval file, each
    rank's maps equal the JAX model's, entry for entry and in order."""
    sizes = [2**30 if i in (20, 21) else min(v, CAP) for i, v in enumerate(tflagship.FTRL_SLOT_SIZES)]
    b = tflagship.TINY_FTRL["batchsize"]
    p = th.DataGeneratorParams(format="raw_async", num_slot=26, slot_size_array=sizes, num_samples=3 * b,
                               eval_num_samples=2 * b, float_label_dense=True, source=str(tmp_path / "train.bin"),
                               eval_source=str(tmp_path / "eval.bin"), seed=2)
    th.DataGenerator(p).generate()
    fields = dict(data_reader_type="raw_async", source=[p.source], eval_source=p.eval_source,
                  float_label_dense=True)
    jm = ftrl_sample(monkeypatch, jh.DataReaderParams(**fields), dynamic=True, i64=True)
    try:
        for _ in range(3):
            jm.train()
        jm.eval()
        want = jm._i64_fold_maps_arrays()
    finally:
        close(jm)
    cfg = dict(builder="build_tiny_dlrm_ftrl", steps=3, eval=True, export=False,
               kwargs=dict(dynamic=True, i64_input_key=True), reader=fields)
    ranks = hybrid.run(hybrid.train_model, 2, {"config": json.dumps(cfg)}, device="cpu")
    assert len(want) == 52
    for r, res in enumerate(ranks):
        got = res["i64_fold_maps"]
        assert list(got) == list(want), r
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), (r, k)
    assert int(want["21.orig"].max()) > 2**20  # the wide slots' keys spread
