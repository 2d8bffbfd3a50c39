"""Snapshots and weight files: the port against the JAX package on the CPU.

The same state (the JAX model's after one step, carried with
`tools/carry.py`) is written by both packages; the files must be the same,
file for file: the same relative paths, the same `.npz` member names in the
same order, for every array the same dtype string, shape and bytes, and the
same `meta.json`. The models: the tiny DLRM-DCNv2 (f32), the tiny
DLRM-FTRL static and dynamic (key stores), and the tiny bench-configured
model (bf16 tables and state, the hot/cold/superhot split, so the merged
views of split tables).

Cross-loading: a snapshot of either package loads in the other with every
table (in key order), the sparse and dense optimizer state, the key stores,
the dense parameters and the step bitwise equal; two more steps then agree
within rtol 1e-4 on the loss, the tolerance of `tests/test_torch_model.py`
for the tiny f32 model (float32 sums in another order).

bfloat16: the JAX package writes `ml_dtypes` arrays (descr '<V2') and
cannot read them back (`jnp.asarray` of a 2-byte void array raises); the
port reads them bitwise and writes the same bytes.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import hugectr_tpu as jh
from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.tools import flagship as jflagship
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.io import filesystem as iofs
from hugectr_tpu_torch.tools import flagship as tflagship
from hugectr_tpu_torch.tools.carry import load_jax_state

from test_torch_bench import JAX_ENV as BENCH_ENV
from test_torch_bench import SPLIT as BENCH_SPLIT
from test_torch_bench import TINY as BENCH_TINY
from test_torch_dlrm_ftrl import _sample_model
from test_torch_model import ENGINE as F32_ENGINE
from test_torch_model import JAX_ENV as F32_ENV

torch.set_num_threads(1)
LOSS_RTOL = 1e-4
EMPTY = 2**31 - 1
CONFIGS = ("f32", "ftrl_static", "ftrl_dynamic", "bench_bf16")


def cpu():
    return ResourceManager.create(device="cpu")


def jax_model(mp, config: str):
    """The JAX model of `config` on one device (the environment stays set
    through `mp` while it trains)."""
    if config == "f32":
        for k, v in F32_ENV.items():
            mp.setenv(k, v)
        mp.delenv("HCTR_TPU_EMB_DTYPE", raising=False)
        return jflagship.build_tiny_dlrm(JaxResourceManager.create(num_devices=1), batchsize=64)
    if config.startswith("ftrl"):
        return _sample_model(mp, dynamic=config == "ftrl_dynamic")
    for k, v in BENCH_ENV.items():
        mp.setenv(k, v)
    reader = jh.DataReaderParams(data_reader_type="synthetic", synthetic_num_batches=3, synthetic_alpha=1.05,
                                 synthetic_learnable=True)
    return jflagship.build_dlrm_dcnv2(JaxResourceManager.create(num_devices=1), reader=reader, **BENCH_TINY)


def port_model(config: str, rm=None):
    rm = rm or cpu()
    if config == "f32":
        return tflagship.build_tiny_dlrm(rm, batchsize=64, **F32_ENGINE)
    if config.startswith("ftrl"):
        return tflagship.build_tiny_dlrm_ftrl(rm, dynamic=config == "ftrl_dynamic")
    # the unique-cap windows off, as BENCH_ENV sets them for the JAX package
    kw = dict(tflagship.bench_settings(), **BENCH_TINY, **BENCH_SPLIT, unique_cap_factor=0)
    return tflagship.build_dlrm_dcnv2(rm, onehot_vocab=64, synthetic_learnable=True, **kw)


def skip_batches(model, n: int) -> None:
    """Advance a model's cycled train batches by `n` (to the batch another
    model trains next)."""
    model.start_data_reading()
    for _ in range(n):
        next(model._train_iter)


def files(root: str) -> dict:
    """{relative path: absolute path} of every file under `root`."""
    out = {}
    for d, _dirs, names in os.walk(root):
        for n in names:
            out[os.path.relpath(os.path.join(d, n), root)] = os.path.join(d, n)
    return out


def arrays_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype.str == b.dtype.str and a.shape == b.shape and a.tobytes() == b.tobytes()


def assert_same_snapshot(got_dir: str, want_dir: str) -> list:
    """The two snapshot directories hold the same files: paths, `.npz`
    member names in order, each array's dtype string, shape and bytes, and
    `meta.json` byte for byte. Returns the relative paths."""
    got, want = files(got_dir), files(want_dir)
    assert sorted(got) == sorted(want)
    for rel in sorted(want):
        if rel.endswith(".npy"):
            a, b = np.load(got[rel]), np.load(want[rel])
            assert arrays_equal(a, b), (rel, a.dtype.str, b.dtype.str, a.shape, b.shape)
        elif rel.endswith(".npz"):
            a, b = np.load(got[rel]), np.load(want[rel])
            assert a.files == b.files, rel
            for m in b.files:
                assert arrays_equal(a[m], b[m]), (rel, m)
        else:
            with open(got[rel], "rb") as f, open(want[rel], "rb") as g:
                assert f.read() == g.read(), rel
    return sorted(want)


def f32(a) -> np.ndarray:
    """An array or tensor as float32 numpy (exact for bfloat16)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_state_equal(tm, jm) -> None:
    """Every table in key order, every key store, the sparse and dense
    optimizer state, the dense parameters and the step of the two models,
    bitwise."""
    s = jax.device_get(jm.state)
    for g in jm.ec.plan.groups:
        for t in g.tables:
            np.testing.assert_array_equal(tm.ec.export_table(tm.tables, t.name),
                                          f32(jm.ec.export_table(jm.state["emb_tables"], t.name)), err_msg=t.name)
    keys = sorted(n for n in s["emb_tables"] if n.endswith("#keys"))
    assert keys == sorted(n for n in tm.tables if n.endswith("#keys"))
    for n in keys:
        np.testing.assert_array_equal(tm.tables[n].numpy(), s["emb_tables"][n], err_msg=n)
    for gname, st in s["eopt"].items():
        for k, arr in st.items():
            np.testing.assert_array_equal(f32(tm.eopt[gname][k]), f32(arr), err_msg=f"{gname}.{k}")
    params = tm.network.param_tree()
    for layer, ps in s["dense_params"].items():
        for k, arr in ps.items():
            np.testing.assert_array_equal(f32(params[layer][k]), arr, err_msg=f"{layer}/{k}")
    for slot, tree in s["dopt"].items():
        for layer, ps in tree.items():
            for k, arr in ps.items():
                np.testing.assert_array_equal(f32(tm.dopt[slot][layer][k]), arr, err_msg=f"{slot}/{layer}/{k}")
    assert tm._step == int(s["step"])


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per config, made once: the JAX model after one step (its step
    compiled under its environment), its host state then and its snapshot
    `<config>_iter3` of that state. Tests that train the model further or
    load into it come after the tests that need it at step 1, or reload
    the snapshot first."""
    root = tmp_path_factory.mktemp("jax_snapshots")
    cache = {}

    def get(config: str):
        if config not in cache:
            with pytest.MonkeyPatch.context() as mp:
                jm = jax_model(mp, config)
                jm.train()
            jm.download_params_to_files(str(root / config), 3)
            cache[config] = dict(model=jm, state=jax.device_get(jm.state), snap=str(root / f"{config}_iter3"))
        return cache[config]

    return get


def carried(run, config: str):
    """A port model carrying the JAX model's state after its step."""
    tm = port_model(config)
    load_jax_state(tm, run["state"])
    return tm


@pytest.mark.parametrize("config", CONFIGS)
def test_snapshot_files_match_jax_file_for_file(jax_runs, tmp_path, config):
    """Both packages write the same carried state at iteration 3: the same
    files, members, dtypes, shapes, bytes and meta.json."""
    run = jax_runs(config)
    tm = carried(run, config)
    tm.download_params_to_files(str(tmp_path / "port"), 3)
    rels = assert_same_snapshot(str(tmp_path / "port_iter3"), run["snap"])
    assert "meta.json" in rels and "dense_model.npz" in rels
    assert any(r.startswith("emb_opt_states/") for r in rels)
    with open(tmp_path / "port_iter3" / "meta.json") as f:
        assert json.load(f) == {"iteration": 3, "step": 1, "shard_rotation": 0}
    if config == "ftrl_dynamic":
        assert "keystore_mp_ev128.npy" in rels
    if config == "bench_bf16":
        assert tm.ec.plan.table_splits
        for user in tm.ec.plan.table_splits:  # the merged user-level views
            assert f"sparse_{user}/emb_vector.npy" in rels
        with open(tmp_path / "port_iter3" / rels[-1], "rb") as f:  # a table's file
            assert b"'descr': '<V2'" in f.read(128)


def test_f32_snapshots_cross_load_both_ways(jax_runs, tmp_path):
    """A JAX snapshot loads in a fresh port model, and a port snapshot in
    the JAX model, with the state bitwise equal; two more steps agree
    within rtol 1e-4."""
    run = jax_runs("f32")
    jm = run["model"]
    tm = port_model("f32")
    tm.load_params_from_files(run["snap"])
    assert_state_equal(tm, jm)
    assert tm._iter == 3
    skip_batches(tm, 1)
    for step in range(2):
        np.testing.assert_allclose(tm.train(), jm.train(), rtol=LOSS_RTOL, err_msg=f"step {step + 2}")

    tm.download_params_to_files(str(tmp_path / "port"), 5)
    for _ in range(2):  # move the JAX model's state away from the snapshot's
        jm.train()
    jm.load_params_from_files(str(tmp_path / "port_iter5"))
    assert_state_equal(tm, jm)
    assert jm._iter == 5
    skip_batches(tm, 2)
    for step in range(2):
        np.testing.assert_allclose(tm.train(), jm.train(), rtol=LOSS_RTOL, err_msg=f"step {step + 4}")


def test_dynamic_snapshot_cross_loads_key_stores(jax_runs, tmp_path):
    """The tiny dynamic DLRM-FTRL: the JAX snapshot (key store included)
    loads in a fresh port model bitwise, and the port's rewrite of it is the
    same files."""
    run = jax_runs("ftrl_dynamic")
    tm = port_model("ftrl_dynamic")
    tm.load_params_from_files(run["snap"])
    assert_state_equal(tm, run["model"])
    assert (tm.tables["mp_ev128#keys"] != EMPTY).sum() > 50
    tm.download_params_to_files(str(tmp_path / "port"), 3)
    assert_same_snapshot(str(tmp_path / "port_iter3"), run["snap"])


def test_bf16_snapshot_reads_bitwise_and_the_reference_cannot(jax_runs):
    """The bench-configured model's bf16 files: the port reads the JAX
    package's bitwise (tables, merged split views, bf16 state); the JAX
    package's own loader raises on them (the reference's defect, recorded
    in ROADMAP Queue 3: a later fix there shows here)."""
    run = jax_runs("bench_bf16")
    jm, snap = run["model"], run["snap"]
    raw = np.load(os.path.join(snap, "emb_opt_states", f"{jm.ec.plan.groups[0].name}.accum.npy"))
    assert raw.dtype.str == "|V2"
    tm = port_model("bench_bf16")
    tm.load_params_from_files(snap)
    assert all(t.dtype == torch.bfloat16 for t in tm.tables.values())
    assert_state_equal(tm, jm)
    for user in tm.ec.plan.table_splits:
        loaded = iofs.load_npy(os.path.join(snap, f"sparse_{user}", "emb_vector.npy"))
        assert loaded.dtype == torch.bfloat16
        assert torch.equal(loaded.view(torch.int16), tm.ec.export_rows(tm.tables, user).view(torch.int16))
    with pytest.raises((TypeError, ValueError)):
        jm.load_params_from_files(snap)


def test_partial_loaders_take_their_slice_of_a_jax_snapshot(jax_runs):
    """load_dense_weights, load_dense_optimizer_states, load_sparse_weights
    (snapshot dir, list of sparse_<table> dirs, {table: path}) and
    load_sparse_optimizer_states (dir, emb_opt_states/, {group.slot:
    path}) each restore the slice they name (tests/test_api_parity.py:182)."""
    run = jax_runs("f32")
    snap, s = run["snap"], run["state"]
    tm = port_model("f32")
    params = tm.network.param_tree()
    layer, key = "l0_MLP", "weight_0"
    dopt0 = tm.dopt["accum"][layer][key].clone()
    table0 = tm.ec.export_table(tm.tables, "0")

    tm.load_dense_weights(snap)
    np.testing.assert_array_equal(params[layer][key].detach().numpy(), s["dense_params"][layer][key])
    assert torch.equal(tm.dopt["accum"][layer][key], dopt0)
    np.testing.assert_array_equal(tm.ec.export_table(tm.tables, "0"), table0)
    tm.load_dense_optimizer_states(os.path.join(snap, "dense_model.npz"))
    np.testing.assert_array_equal(tm.dopt["accum"][layer][key].numpy(), s["dopt"]["accum"][layer][key])

    names = [t.name for g in tm.ec.plan.groups for t in g.tables]
    forms = {"dir": snap, "list": [os.path.join(snap, f"sparse_{n}") for n in names],
             "dict": {n: os.path.join(snap, f"sparse_{n}", "emb_vector.npy") for n in names}}
    for form, src in forms.items():
        fresh = port_model("f32")
        fresh.load_sparse_weights(src)
        for n in names:
            np.testing.assert_array_equal(fresh.ec.export_table(fresh.tables, n),
                                          np.load(os.path.join(snap, f"sparse_{n}", "emb_vector.npy")),
                                          err_msg=f"{form} {n}")
    eopt_forms = {"dir": snap, "emb_opt_states": os.path.join(snap, "emb_opt_states"),
                  "dict": {f"{g}.accum": os.path.join(snap, "emb_opt_states", f"{g}.accum.npy") for g in tm.eopt}}
    for form, src in eopt_forms.items():
        fresh = port_model("f32")
        fresh.load_sparse_optimizer_states(src)
        for g, st in s["eopt"].items():
            np.testing.assert_array_equal(fresh.eopt[g]["accum"].numpy(), st["accum"], err_msg=f"{form} {g}")


def test_embedding_dump_and_load_across_packages(jax_runs, tmp_path):
    """embedding_dump / embedding_load of a dynamic table with its
    key_store.npy (tests/test_dynamic_table.py:372): the JAX package's dump
    loads in the port, key store and rows bitwise, and the port's dump is
    the same files; a fresh port model then reads the same rows for the same
    keys. The JAX package's own reload turns the store's empty rows into
    key 2^31 - 2 (its `_fold_reserved_key` on import; ROADMAP Queue 3); the
    port keeps them empty."""
    jm = jax_runs("ftrl_dynamic")["model"]
    names = [t.name for t in jm.ec.plan.groups[0].tables]
    jm.embedding_dump(str(tmp_path / "jax"), names[:2])
    dumped = {n: jm.ec.export_key_store(jm.state["emb_tables"], n) for n in names[:2]}
    tm = port_model("ftrl_dynamic")
    tm.embedding_load(str(tmp_path / "jax"))
    for n in names[:2]:
        assert os.path.exists(tmp_path / "jax" / n / "key_store.npy")
        assert (dumped[n] == EMPTY).any() and (dumped[n] != EMPTY).any()
        np.testing.assert_array_equal(tm.ec.export_key_store(tm.tables, n), dumped[n], err_msg=n)
        np.testing.assert_array_equal(tm.ec.export_table(tm.tables, n),
                                      jm.ec.export_table(jm.state["emb_tables"], n), err_msg=n)
    tm.embedding_dump(str(tmp_path / "port"), names[:2])
    assert_same_snapshot(str(tmp_path / "port"), str(tmp_path / "jax"))
    jm.embedding_load(str(tmp_path / "port"))
    reloaded = jm.ec.export_key_store(jm.state["emb_tables"], names[0])
    np.testing.assert_array_equal(reloaded, np.where(dumped[names[0]] == EMPTY, EMPTY - 1, dumped[names[0]]))
    # the same rows for the same keys, through the key store
    batch = tm._put_batch(next(iter(tm.train_reader)))
    fresh = port_model("ftrl_dynamic")
    fresh.embedding_load(str(tmp_path / "port"))
    fk = tm._feature_keys(batch)
    with torch.no_grad():
        want, got = tm.ec.forward(tm.tables, fk), fresh.ec.forward(fresh.tables, fk)
    g = tm.ec.plan.groups[0]
    lookups = [lm.top_name for lm in g.lookups if g.tables[lm.table_index].name in names[:2]]
    assert lookups
    for top in lookups:
        assert torch.equal(got[top], want[top]), top


def test_fit_snapshots_every_k_iterations(jax_runs, tmp_path):
    """fit(snapshot=2, max_iter=4) writes _iter2 and _iter4 in both
    packages, with the same meta.json."""
    run = jax_runs("f32")
    jm, tm = run["model"], carried(run, "f32")
    jm.load_params_from_files(run["snap"])
    jm.fit(max_iter=4, display=0, eval_interval=0, snapshot=2, snapshot_prefix=str(tmp_path / "jax"))
    tm.fit(max_iter=4, display=0, eval_interval=0, snapshot=2, snapshot_prefix=str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path)) == ["jax_iter2", "jax_iter4", "port_iter2", "port_iter4"]
    for it in (2, 4):
        with open(tmp_path / f"jax_iter{it}" / "meta.json") as f, open(tmp_path / f"port_iter{it}" / "meta.json") as g:
            assert f.read() == g.read() == json.dumps({"iteration": it, "step": it + 1, "shard_rotation": 0})
        assert sorted(files(str(tmp_path / f"port_iter{it}"))) == sorted(files(str(tmp_path / f"jax_iter{it}")))
    import inspect

    assert inspect.signature(type(tm).fit).parameters["snapshot_prefix"].default == "./snapshot"


def test_layout_stamp_mismatch_raises_in_both(jax_runs, tmp_path):
    """A meta.json with the other shard_rotation raises before any array is
    read, in both packages (tests/test_model_e2e.py:620)."""
    run = jax_runs("f32")
    jm, tm = run["model"], carried(run, "f32")
    tm.download_params_to_files(str(tmp_path / "snap"), 1)
    path = tmp_path / "snap_iter1" / "meta.json"
    meta = json.loads(path.read_text())
    tm.load_params_from_files(str(tmp_path / "snap_iter1"))  # the same stamp loads
    meta["shard_rotation"] = 1
    path.write_text(json.dumps(meta))
    for model in (tm, jm):
        with pytest.raises(ValueError, match="shard_rotation"):
            model.load_params_from_files(str(tmp_path / "snap_iter1"))


def test_memory_filesystem_round_trip(jax_runs):
    """A snapshot and a dump through `memory://` (tests/test_model_e2e.py:411);
    the JAX package reads the port's remote snapshot. Skips where fsspec
    does not import."""
    try:
        import fsspec  # noqa: F401
    except ImportError:
        pytest.skip("fsspec is not installed")
    run = jax_runs("f32")
    jm, tm = run["model"], carried(run, "f32")
    tm.download_params_to_files("memory://port_ckpt/snap", 1)
    ref = tm.ec.export_table(tm.tables, "0").copy()
    tm.train()
    assert not np.array_equal(ref, tm.ec.export_table(tm.tables, "0"))
    tm.load_params_from_files("memory://port_ckpt/snap_iter1")
    np.testing.assert_array_equal(ref, tm.ec.export_table(tm.tables, "0"))
    names = iofs.listdir("memory://port_ckpt/snap_iter1")
    assert "dense_model.npz" in names and "sparse_0" in names
    jm.train()
    jm.load_params_from_files("memory://port_ckpt/snap_iter1")
    assert_state_equal(tm, jm)
    tm.embedding_dump("memory://port_ckpt/emb", ["0"])
    tm.embedding_load("memory://port_ckpt/emb")
    np.testing.assert_array_equal(ref, tm.ec.export_table(tm.tables, "0"))


@pytest.mark.parametrize("name, item", [("packed_mp_ev16.npy", "Left out on purpose")])
def test_files_the_port_cannot_represent_raise(monkeypatch, tmp_path, name, item):
    """The JAX package's packed table-and-state file, which every loader
    once refused, now loads: a snapshot of the JAX tiny model with
    HCTR_TPU_PACKED_STATE (AdaGrad [R, 2E], `name`) restores the port's
    packed storage bitwise through `load_params_from_files`, and the
    loaders of the weights and of the sparse state read the same snapshot
    without raising, keeping the accumulators as the JAX package's do. The
    ROADMAP section `item` no longer holds the packed layouts."""
    for k, v in dict(F32_ENV, HCTR_BENCH_OPT="adagrad", HCTR_TPU_PACKED_STATE="1").items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("HCTR_TPU_EMB_DTYPE", raising=False)
    jm = jflagship.build_tiny_dlrm(JaxResourceManager.create(num_devices=1), batchsize=64)
    jm.train()
    jm.download_params_to_files(str(tmp_path / "snap"), 0)
    snap = str(tmp_path / "snap_iter0")
    assert name in os.listdir(snap)
    group = name[len("packed_"):-len(".npy")]
    want = np.asarray(jax.device_get(jm.state)["emb_tables"][group])
    tm = tflagship.build_tiny_dlrm(cpu(), batchsize=64, optimizer="adagrad", packed_state=True, **F32_ENGINE)
    assert group in tm.ec.packed_groups and tuple(tm.tables[group].shape) == want.shape
    tm.load_params_from_files(snap)
    np.testing.assert_array_equal(tm.tables[group].numpy(), want)
    acc = tm.tables[group][:, 16:].clone()
    with torch.no_grad():
        tm.tables[group][:, :16] = 0
    tm.load_sparse_weights(snap)
    tm.load_sparse_optimizer_states(snap)
    tm.load_sparse_optimizer_states(os.path.join(snap, "emb_opt_states"))
    np.testing.assert_array_equal(tm.tables[group].numpy(), want)
    assert torch.equal(tm.tables[group][:, 16:], acc)
    roadmap = open(os.path.join(os.path.dirname(__file__), "..", "ROADMAP.md")).read()
    section = roadmap[roadmap.index(item):]
    section = section[: section.find("\n#", 1) if "\n#" in section[1:] else len(section)]
    assert "HCTR_TPU_PACKED_STATE" not in section and "HCTR_TPU_ROWWISE_PACK" not in section