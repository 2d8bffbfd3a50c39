"""Modules of the PyTorch port against their JAX counterparts, at small widths.

Tolerances: plan fields and synthetic batches are exact; the sparse update
routes and the collection rtol 1e-4 / atol 1e-5 (float32 sums in another
order, as tests/test_onehot_engine.py); dense layers rtol 1e-5 / atol 1e-6
(the same fp32 products; only reduction order differs).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hugectr_tpu.core import config as jcfg
from hugectr_tpu.core.types import Combiner_t as JComb
from hugectr_tpu.core.types import Optimizer_t as JOpt
from hugectr_tpu.data import reader as jreader
from hugectr_tpu.embedding import sparse_optimizer as jso
from hugectr_tpu.embedding.collection import EmbeddingCollection as JEC
from hugectr_tpu.layers.base import LAYER_REGISTRY as JLAYERS
from hugectr_tpu.layers.base import LayerCtx
from hugectr_tpu.optim.dense import DenseOptimizer as JDenseOpt
from hugectr_tpu.optim.params import OptParams as JOptParams
from hugectr_tpu.parallel import plan as jplan
from hugectr_tpu.tools.flagship import MLPERF_MULTI_HOT_SIZES, MLPERF_TABLE_SIZES

from hugectr_tpu_torch import ops
from hugectr_tpu_torch.core import config as tcfg
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Combiner_t as TComb
from hugectr_tpu_torch.core.types import Optimizer_t as TOpt
from hugectr_tpu_torch.data import reader as treader
from hugectr_tpu_torch.embedding import sparse_optimizer as tso
from hugectr_tpu_torch.embedding.collection import EmbeddingCollection as TEC
from hugectr_tpu_torch.layers.base import LAYER_REGISTRY as TLAYERS
from hugectr_tpu_torch.ops import onehot_matmul as oh
from hugectr_tpu_torch.optim.dense import DenseOptimizer as TDenseOpt
from hugectr_tpu_torch.optim.params import OptParams as TOptParams
from hugectr_tpu_torch.parallel import plan as tplan

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
DENSE_TOL = dict(rtol=1e-5, atol=1e-6)
CPU = ResourceManager.create(device="cpu")


# ------------------------------------------------------------------ plan
def _flagship_lookups(pkg, comb, cap):
    return [
        pkg.LookupConfig(
            i, pkg.EmbeddingTableConfig(str(i), min(v, cap), 128),
            f"sparse_embedding:{i}", f"sparse_embedding:{i}", comb.Sum, MLPERF_MULTI_HOT_SIZES[i],
        )
        for i, v in enumerate(MLPERF_TABLE_SIZES)
    ]


@pytest.mark.parametrize("cap,onehot", [(2_000_000, 8192), (1000, 100)])
def test_compile_plan_matches_jax(monkeypatch, cap, onehot):
    monkeypatch.setenv("HCTR_TPU_ONEHOT_VOCAB", str(onehot))
    monkeypatch.setenv("HCTR_TPU_SPLIT_VOCAB", str(256 * 1024))
    names = [str(i) for i in range(26)]
    counts = {n: 1 for n in names}
    jp = jplan.compile_plan(
        _flagship_lookups(jplan, JComb, cap), jplan.ShardingPlan([("mp", names)]), 1, counts
    )
    tp = tplan.compile_plan(
        _flagship_lookups(tplan, TComb, cap), tplan.ShardingPlan([("mp", names)]), 1, counts,
        onehot_vocab=onehot, split_vocab=256 * 1024,
    )
    assert [g.name for g in tp.groups] == [g.name for g in jp.groups]
    for jg, tg in zip(jp.groups, tp.groups):
        assert (tg.compute_kind, tg.placement.value, tg.ev_size) == (jg.compute_kind, jg.placement.value, jg.ev_size)
        assert [t.name for t in tg.tables] == [t.name for t in jg.tables]
        for f in ("num_shards", "mesh_size", "total_local_rows", "hotness_total", "out_width"):
            assert getattr(tg, f) == getattr(jg, f), f
        for f in ("table_vocab", "rows_per_shard", "local_offsets", "slot_table",
                  "slot_local_offset", "slot_vocab"):
            np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f), err_msg=f)
        for jl, tl in zip(jg.lookups, tg.lookups):
            for f in ("lookup_id", "table_index", "slot_begin", "slot_end", "out_begin", "out_end", "top_name"):
                assert getattr(tl, f) == getattr(jl, f), f


def test_flagship_route_map_at_batch_16384():
    """The flagship's groups and the update route each takes at batch 16384
    (13 one-hot tables; mid-size tables, 11 and 20 on the dense sweep; 0, 9,
    10, 19, 21, 22 on the sorted segscan route)."""
    names = [str(i) for i in range(26)]
    plan = tplan.compile_plan(
        _flagship_lookups(tplan, TComb, 2_000_000), tplan.ShardingPlan([("mp", names)]), 1,
        {n: 1 for n in names},
    )
    routes = {}
    for g in plan.groups:
        tabs = tuple(int(t.name) for t in g.tables)
        if g.compute_kind == "onehot":
            routes[tabs] = "onehot"
        else:
            routes[tabs] = tso.update_route(g.total_local_rows, 16384 * g.hotness_total, 262144, 0.3)
    assert routes.pop((3, 5, 6, 7, 8, 12, 13, 15, 16, 17, 18, 24, 25)) == "onehot"
    assert routes.pop((1, 2, 4, 14, 23)) == "dense"
    assert {t[0]: r for t, r in routes.items()} == {
        0: "sorted", 9: "sorted", 10: "sorted", 11: "dense", 19: "sorted",
        20: "dense", 21: "sorted", 22: "sorted",
    }


# ------------------------------------------------------------------ data
def test_synthetic_reader_batches_bit_identical():
    def spec(mod):
        return mod.BatchSpec(
            batch_size=64, label_dims=(1,), label_names=("label",), dense_dim=13,
            dense_name="dense",
            sparse=tuple(mod.SparseFeatureSpec(f"data{i}", (h,)) for i, h in enumerate((3, 1, 7))),
        )

    vocabs = {"data0": [1000], "data1": [3], "data2": [40000]}
    jr = iter(jreader.SyntheticReader(spec(jreader), vocabs, num_batches=2, alpha=1.05, seed=1234))
    tr = iter(treader.SyntheticReader(spec(treader), vocabs, num_batches=2, alpha=1.05, seed=1234))
    for _ in range(3):  # across the epoch boundary
        jb, tb = next(jr), next(tr)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])


# -------------------------------------------------------- sparse optimizer
def test_dedup_rows_scan_contract_matches_jax():
    rng = np.random.default_rng(2)
    k, e, rows = 1500, 8, 300
    idx = rng.integers(0, rows + 1, k).astype(np.int32)
    src = rng.integers(0, 400, k).astype(np.int32)
    dsrc = rng.normal(size=(400, e)).astype(np.float32)
    js, jsum, jtail, _ = jso.dedup_rows(
        jnp.asarray(idx), jnp.asarray(src), jnp.asarray(dsrc), sentinel=rows, segsum="scan"
    )
    ops.reset_counts()
    ts, tsum, ttail = tso.dedup_rows(
        torch.from_numpy(idx).long(), torch.from_numpy(src).long(), torch.from_numpy(dsrc)
    )
    assert ops.plain_counts()["segscan"] == 1
    valid = ts.numpy() < rows  # the JAX result is padded to 512 rows past K
    np.testing.assert_array_equal(ts.numpy()[valid], np.asarray(js)[:k][valid])
    np.testing.assert_array_equal(ttail.numpy()[valid], np.asarray(jtail)[:k][valid])
    np.testing.assert_allclose(tsum.numpy()[valid], np.asarray(jsum)[:k][valid], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", ["dense", "sorted"])
@pytest.mark.parametrize("kind", ["rowwise_adagrad", "adagrad"])
def test_apply_sparse_matches_jax(route, kind):
    rng = np.random.default_rng(4)
    rows, e, k, s = 300, 8, 2000, 500
    table = rng.normal(size=(rows, e)).astype(np.float32)
    idx = rng.integers(0, rows + 20, k).astype(np.int32)
    idx[idx >= rows] = rows  # sentinel: invalid keys
    src = rng.integers(0, s, k).astype(np.int32)
    dsrc = rng.normal(size=(s, e)).astype(np.float32)
    dense_rows = 1000 if route == "dense" else 0
    jopt = JOptParams(JOpt(kind), initial_accu_value=0.1)
    topt = TOptParams(TOpt(kind), initial_accu_value=0.1)
    jstate = jso.init_state(jopt, rows, e)
    jt, js = jso.apply_sparse(
        jopt, jnp.asarray(table), jstate, jnp.asarray(idx), jnp.asarray(src), jnp.asarray(dsrc),
        jnp.asarray(0.05, jnp.float32), jnp.asarray(1), segsum="scan", dense_rows=dense_rows,
        dense_ratio=0.0,
    )
    tt = torch.from_numpy(table.copy())
    ts = tso.init_state(topt, rows, e)
    got = tso.apply_sparse(
        topt, tt, ts, torch.from_numpy(idx).long(), torch.from_numpy(src).long(),
        torch.from_numpy(dsrc), torch.tensor(0.05), dense_rows=dense_rows, dense_ratio=0.0,
    )
    assert got == route
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(ts["accum"].numpy(), np.asarray(js["accum"]), **TOL)


# ------------------------------------------------------------ collection
def _ec_lookups(pkg, comb):
    t0 = pkg.EmbeddingTableConfig("t0", 57, 8)
    t1 = pkg.EmbeddingTableConfig("t1", 100, 8)
    t2 = pkg.EmbeddingTableConfig("t2", 3000, 8)
    t3 = pkg.EmbeddingTableConfig("t3", 700, 8)
    return [
        pkg.LookupConfig(0, t0, "f0", "e0", comb.Sum, 3),
        pkg.LookupConfig(1, t1, "f1", "e1", comb.Mean, 2),
        pkg.LookupConfig(2, t2, "f2", "e2", comb.Sum, 4),
        pkg.LookupConfig(3, t3, "f3", "e3", comb.Mean, 2),
        pkg.LookupConfig(4, t2, "f4", "e4", comb.Sum, 1),
    ]


EC_HOT = {"f0": (3, 57), "f1": (2, 100), "f2": (4, 3000), "f3": (2, 700), "f4": (1, 3000)}


def _edge_keys(rng, b, hot=EC_HOT, int64=False):
    """Keys with -1 padding, negative keys, keys >= V and, as int64, keys
    >= 2^31 (2^32 - 1 cuts to -1, padding in the JAX package). Sample 0 is
    all padding. Returns numpy views: column slices of one [B, sum h]
    array, as the batch's key tensor is cut."""
    cols = []
    for h, v in hot.values():
        k = rng.integers(0, v, size=(b, h)).astype(np.int64)
        r = rng.random((b, h))
        k[r < 0.15] = -1
        neg = (r >= 0.15) & (r < 0.25)
        k[neg] = -rng.integers(2, 3 * v, size=int(neg.sum()))
        big = (r >= 0.25) & (r < 0.32)
        k[big] = v + rng.integers(0, 3 * v, size=int(big.sum()))
        if int64:
            wide = (r >= 0.32) & (r < 0.42)
            k[wide] = 2**31 + rng.integers(0, 2**31, size=int(wide.sum()))
            k[(r >= 0.42) & (r < 0.45)] = 2**32 - 1
            k[:4, 0] = [2**31 + 5, 2**32 - 1, -7, v + 5]
        k[0] = -1
        cols.append(k)
    allk = np.concatenate(cols, axis=1)
    if not int64:
        allk = allk.astype(np.int32)
    feats, c = {}, 0
    for f, (h, _v) in hot.items():
        feats[f] = allk[:, c : c + h]
        c += h
    return allk, feats


def _torch_views(allk, hot=EC_HOT):
    """The same column views, of one torch tensor."""
    t = torch.from_numpy(allk)
    out, c = {}, 0
    for f, (h, _v) in hot.items():
        out[f] = t[:, c : c + h]
        c += h
    return out


@pytest.mark.parametrize("route", ["sorted", "dense"])
def test_collection_forward_and_update_match_jax(mesh1, monkeypatch, route):
    """forward + backward_and_update on one device with one-hot groups and
    rowop groups sent to (a) the sorted segscan route or (b) the dense
    sweep."""
    rng = np.random.default_rng(11)
    b = 48
    feats = {}
    for f, (h, v) in EC_HOT.items():
        k = rng.integers(0, v, size=(b, h)).astype(np.int32)
        k[rng.random((b, h)) < 0.2] = -1
        feats[f] = k
    counts = _collection_matches_jax(mesh1, monkeypatch, route, rng, feats,
                                     {k: torch.from_numpy(v) for k, v in feats.items()})
    assert counts["onehot_fwd"] == 1 and counts["onehot_bwd"] == 1  # one call each for the group
    assert counts["segscan"] == (1 if route == "sorted" else 0)


@pytest.mark.parametrize("route", ["sorted", "dense"])
def test_int64_keys_placed_as_jax(mesh1, monkeypatch, route):
    """int64 keys >= 2^31 (2^31 + 5, 2^32 - 1, ...), negative keys and keys
    >= V land on the JAX package's rows, which casts keys to int32 before
    the wrap (collection.py:433), in the one-hot group and the rowop group:
    forward outputs, updated tables and optimizer state."""
    rng = np.random.default_rng(12)
    allk, feats = _edge_keys(rng, 40, int64=True)
    _collection_matches_jax(mesh1, monkeypatch, route, rng, feats, _torch_views(allk))


def _collection_matches_jax(mesh1, monkeypatch, route, rng, feats, tfeats):
    """Runs forward + backward_and_update in both packages from the same
    tables on `feats` (numpy, for JAX) and `tfeats` (torch, for the port),
    asserts they agree, and returns the port's plain-version call counts."""
    env = {
        "HCTR_TPU_ONEHOT_VOCAB": "128", "HCTR_TPU_SEGSUM": "scan", "HCTR_TPU_ONEHOT_KERNEL": "pallas",
        "HCTR_TPU_DENSE_UPDATE_ROWS": "0" if route == "sorted" else "262144",
        "HCTR_TPU_DENSE_KEY_RATIO": "0" if route == "sorted" else "0.3",
    }
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    b = next(iter(feats.values())).shape[0]
    values = {n: rng.normal(size=(v, 8)).astype(np.float32) * 0.1
              for n, v in (("t0", 57), ("t1", 100), ("t2", 3000), ("t3", 700))}
    d_outs = {f"e{i}": rng.normal(size=(b, 8)).astype(np.float32) for i in range(5)}

    jopt = JOptParams(JOpt.RowWiseAdaGrad, initial_accu_value=0.0)
    jpl = jplan.compile_plan(_ec_lookups(jplan, JComb), jplan.ShardingPlan([]), 1)
    jec = JEC(jpl, mesh1, jopt)
    jt = jec.init(jax.random.key(0))
    for n, v in values.items():
        jt = jec.import_table(jt, n, v)
    js = jec.init_optimizer(jt)
    jout = jax.jit(jec.forward)(jt, feats)
    jt, js = jax.jit(jec.backward_and_update)(jt, js, feats, d_outs, jnp.asarray(0.3), jnp.asarray(1))

    topt = TOptParams(TOpt.RowWiseAdaGrad, initial_accu_value=0.0)
    tpl = tplan.compile_plan(_ec_lookups(tplan, TComb), tplan.ShardingPlan([]), 1, onehot_vocab=128)
    tec = TEC(
        tpl, CPU, topt,
        dense_update_rows=int(env["HCTR_TPU_DENSE_UPDATE_ROWS"]),
        dense_key_ratio=float(env["HCTR_TPU_DENSE_KEY_RATIO"]),
    )
    tt = tec.init(CPU.generator(0))
    for n, v in values.items():
        tt = tec.import_table(tt, n, v)
    ts = tec.init_optimizer(tt)
    ops.reset_counts()
    tout = tec.forward(tt, tfeats)
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), **TOL, err_msg=k)
    tec.backward_and_update(tt, ts, tfeats, {k: torch.from_numpy(v) for k, v in d_outs.items()},
                            torch.tensor(0.3))
    assert tec.group_routes == {"onehot_ev8": "onehot", "mp_ev8": route}
    for n in values:
        np.testing.assert_allclose(tec.export_table(tt, n), jec.export_table(jt, n), **TOL, err_msg=n)
    for g in ts:
        np.testing.assert_allclose(ts[g]["accum"].numpy(), np.asarray(js[g]["accum"]), **TOL)
    return ops.plain_counts()


@pytest.mark.parametrize("keys", ["int32_views", "int64"])
@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_onehot_fwd_group_plain_matches_jax(mesh1, monkeypatch, kernel, keys):
    """`onehot_fwd_group_plain` (and the wrapper, one call per group) on the
    raw feature keys against the JAX package's `_onehot_fwd` with the
    Pallas kernel (interpret mode) or the XLA counts form, on a group with
    Sum and Mean lookups, -1 padding, negative keys, keys >= V, strided
    int32 column views or int64 keys >= 2^31."""
    monkeypatch.setenv("HCTR_TPU_ONEHOT_VOCAB", "128")
    monkeypatch.setenv("HCTR_TPU_ONEHOT_KERNEL", kernel)
    rng = np.random.default_rng(31)
    allk, feats = _edge_keys(rng, 64, int64=keys == "int64")
    jpl = jplan.compile_plan(_ec_lookups(jplan, JComb), jplan.ShardingPlan([]), 1)
    jec = JEC(jpl, mesh1, JOptParams(JOpt.RowWiseAdaGrad))
    tpl = tplan.compile_plan(_ec_lookups(tplan, TComb), tplan.ShardingPlan([]), 1, onehot_vocab=128)
    tec = TEC(tpl, CPU, TOptParams(TOpt.RowWiseAdaGrad))
    jg = next(g for g in jpl.groups if g.compute_kind == "onehot")
    tg = next(g for g in tpl.groups if g.compute_kind == "onehot")
    assert [lm.combiner for lm in tg.lookups] == [TComb.Sum, TComb.Mean]
    table = rng.normal(size=(tg.total_storage_rows, 8)).astype(np.float32)
    want = np.asarray(jec._onehot_fwd(
        jg.name, jnp.asarray(table), jec._group_keys(jg, {k: jnp.asarray(v) for k, v in feats.items()})
    ))
    tkeys = tec._lookup_keys(tg, _torch_views(allk))
    assert tkeys[0].stride() == (allk.shape[1], 1)  # column views, not copies
    lookups = tec._meta[tg.name].fwd_lookups
    got = oh.onehot_fwd_group_plain(tkeys, lookups, torch.from_numpy(table), tg.out_width)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ops.reset_counts()
    got = oh.onehot_fwd_group(tkeys, lookups, torch.from_numpy(table), tg.out_width)
    assert ops.plain_counts()["onehot_fwd"] == 1
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got.numpy()[0], 0.0)  # all padding, Mean divides by 1


def test_onehot_grad_accumulates_like_jax_pallas(mesh1, monkeypatch):
    """The one-hot group's gradient and counts, one backward call for the
    group's lookups on the raw feature keys, against the JAX package's
    Pallas form (`_onehot_grad_pallas`, interpret mode, each table's kernel
    adding into the group's buffers), sum and mean lookups."""
    monkeypatch.setenv("HCTR_TPU_ONEHOT_VOCAB", "128")
    rng = np.random.default_rng(21)
    b = 64
    feats = {}
    for f, (h, v) in {"f0": (3, 57), "f1": (2, 100), "f2": (4, 3000), "f3": (2, 700), "f4": (1, 3000)}.items():
        k = rng.integers(0, v, size=(b, h)).astype(np.int32)
        k[rng.random((b, h)) < 0.2] = -1
        feats[f] = k
    jpl = jplan.compile_plan(_ec_lookups(jplan, JComb), jplan.ShardingPlan([]), 1)
    jec = JEC(jpl, mesh1, JOptParams(JOpt.RowWiseAdaGrad))
    tpl = tplan.compile_plan(_ec_lookups(tplan, TComb), tplan.ShardingPlan([]), 1, onehot_vocab=128)
    tec = TEC(tpl, CPU, TOptParams(TOpt.RowWiseAdaGrad))
    jg = next(g for g in jpl.groups if g.compute_kind == "onehot")
    tg = next(g for g in tpl.groups if g.compute_kind == "onehot")
    d_group = rng.normal(size=(b, tg.out_width)).astype(np.float32)
    jgrad, jcnt = jec._onehot_grad_pallas(
        jg.name, jnp.float32, jec._group_keys(jg, feats), jnp.asarray(d_group)
    )
    ops.reset_counts()
    tgrad, tcnt = tec._onehot_grad(
        tg.name, torch.float32, {k: torch.from_numpy(v) for k, v in feats.items()}, torch.from_numpy(d_group),
    )
    assert len(tg.lookups) == 2 and ops.plain_counts()["onehot_bwd"] == 1  # one call for the group
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), **TOL)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))


# ---------------------------------------------------------------- layers
def _port_layer(cfg, in_shapes, params):
    layer = TLAYERS[cfg.layer_type](cfg, in_shapes, CPU.generator(0), CPU.device)
    with torch.no_grad():
        for k, v in params.items():
            getattr(layer, k).copy_(torch.from_numpy(v))
    return layer


def _check_layer(jcfg_obj, tcfg_obj, in_shapes, params, inputs):
    """Forward outputs and d(sum(out * r))/d(params, inputs) agree."""
    rng = np.random.default_rng(0)
    ctx = LayerCtx(training=True, compute_dtype=jnp.float32)
    japply = JLAYERS[jcfg_obj.layer_type].apply
    jout = japply({k: jnp.asarray(v) for k, v in params.items()}, {}, [jnp.asarray(x) for x in inputs],
                  jcfg_obj, ctx)[0][0]
    r = rng.normal(size=jout.shape).astype(np.float32)

    def jloss(p, xs):
        return jnp.sum(japply(p, {}, xs, jcfg_obj, ctx)[0][0] * r)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, [jnp.asarray(x) for x in inputs]
    )
    layer = _port_layer(tcfg_obj, in_shapes, params)
    xs = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    tout = layer(xs, torch.float32)[0]
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **DENSE_TOL)
    (tout * torch.from_numpy(r)).sum().backward()
    for k in params:
        np.testing.assert_allclose(getattr(layer, k).grad.numpy(), np.asarray(jgp[k]), rtol=1e-5, atol=1e-5)
    for x, g in zip(xs, jgx):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-5)


def test_mlp_matches_jax():
    rng = np.random.default_rng(1)
    kw = dict(layer_type="MLP", bottom_names=["x"], top_names=["y"], num_outputs=[32, 16, 1],
              activations=["relu", "relu", "none"])
    params = {}
    fan_in = 13
    for i, n in enumerate([32, 16, 1]):
        params[f"weight_{i}"] = rng.normal(size=(fan_in, n)).astype(np.float32) * 0.3
        params[f"bias_{i}"] = rng.normal(size=(n,)).astype(np.float32) * 0.1
        fan_in = n
    x = rng.normal(size=(24, 13)).astype(np.float32)
    _check_layer(jcfg.DenseLayer(**kw), tcfg.DenseLayer(**kw), [(24, 13)], params, [x])


def test_concat_matches_jax():
    rng = np.random.default_rng(2)
    kw = dict(layer_type="Concat", bottom_names=["a", "b"], top_names=["y"])
    a = rng.normal(size=(24, 16)).astype(np.float32)
    b = rng.normal(size=(24, 5)).astype(np.float32)
    _check_layer(jcfg.DenseLayer(**kw), tcfg.DenseLayer(**kw), [(24, 16), (24, 5)], {}, [a, b])


def test_multicross_projection_matches_jax():
    rng = np.random.default_rng(3)
    n, k = 20, 8
    kw = dict(layer_type="MultiCross", bottom_names=["x"], top_names=["y"], projection_dim=k, num_layers=2)
    params = {}
    for i in range(2):
        params[f"U_{i}"] = rng.normal(size=(n, k)).astype(np.float32) * 0.3
        params[f"V_{i}"] = rng.normal(size=(k, n)).astype(np.float32) * 0.3
        params[f"b_{i}"] = rng.normal(size=(n,)).astype(np.float32) * 0.1
    x = rng.normal(size=(24, n)).astype(np.float32)
    _check_layer(jcfg.DenseLayer(**kw), tcfg.DenseLayer(**kw), [(24, n)], params, [x])


def test_bce_matches_jax():
    rng = np.random.default_rng(4)
    kw = dict(layer_type="BinaryCrossEntropyLoss", bottom_names=["l", "y"], top_names=["loss"])
    logits = (rng.normal(size=(64, 1)) * 4).astype(np.float32)
    logits[:4] = 0.0  # the exact-gradient point of the logaddexp form
    labels = rng.integers(0, 2, size=(64, 1)).astype(np.float32)
    _check_layer(jcfg.DenseLayer(**kw), tcfg.DenseLayer(**kw), [(64, 1), (64, 1)], {}, [logits, labels])


def test_dense_adagrad_matches_jax():
    rng = np.random.default_rng(5)
    params = {"l0_MLP": {"weight_0": rng.normal(size=(6, 4)).astype(np.float32),
                         "bias_0": rng.normal(size=(4,)).astype(np.float32)}}
    grads = {l: {k: rng.normal(size=v.shape).astype(np.float32) for k, v in ps.items()}
             for l, ps in params.items()}
    jopt = JDenseOpt(JOptParams(JOpt.RowWiseAdaGrad, initial_accu_value=0.01))
    jp = jax.tree.map(jnp.asarray, params)
    jst = jopt.init(jp)
    topt = TDenseOpt(TOptParams(TOpt.RowWiseAdaGrad, initial_accu_value=0.01))
    tp = {l: {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in ps.items()}
          for l, ps in params.items()}
    tst = topt.init(tp)
    for step in (1, 2):
        jp, jst = jopt.update(jp, jst, jax.tree.map(jnp.asarray, grads), jnp.asarray(0.05), jnp.asarray(step))
        for l, ps in tp.items():
            for k, p in ps.items():
                p.grad = torch.from_numpy(grads[l][k])
        topt.update(tp, tst, torch.tensor(0.05))
    for l, ps in tp.items():
        for k, p in ps.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[l][k]), **DENSE_TOL)
            np.testing.assert_allclose(tst["accum"][l][k].numpy(), np.asarray(jst["accum"][l][k]), **DENSE_TOL)
