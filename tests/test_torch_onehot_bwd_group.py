"""The grouped one-hot backward's plain version (`onehot_bwd_group_plain`,
which the CUDA kernel `onehot_bwd_group` is held against on the card in
test_torch_gpu.py) against the JAX package: per lookup and for the group
against the Pallas `onehot_matmul_bwd` (interpret mode) on each lookup's
placed keys, and through `EmbeddingCollection._onehot_grad` against the
JAX package's XLA counts form (its default off the TPU), with a windowed
tier, a Mean lookup, a frozen table and a weighted lookup whose signed
weights cancel within a sample.

Tolerances: float32 rtol 1e-4 / atol 1e-5 (sums in another order, as
tests/test_torch_kernels.py); unweighted touch counts exact; weighted
touch counts rtol 1e-6 (float32 sums of |summed weights|, JAX's in another
order) and their touched rows exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugectr_tpu.core.types import Combiner_t as JComb
from hugectr_tpu.core.types import Optimizer_t as JOpt
from hugectr_tpu.embedding.collection import EmbeddingCollection as JEC
from hugectr_tpu.ops.pallas.onehot_matmul import onehot_matmul_bwd as j_bwd
from hugectr_tpu.optim.params import OptParams as JOptParams
from hugectr_tpu.parallel import plan as jplan

from hugectr_tpu_torch import ops
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Combiner_t as TComb
from hugectr_tpu_torch.core.types import Optimizer_t as TOpt
from hugectr_tpu_torch.embedding.collection import EmbeddingCollection as TEC
from hugectr_tpu_torch.ops import onehot_matmul as oh
from hugectr_tpu_torch.optim.params import OptParams as TOptParams
from hugectr_tpu_torch.parallel import plan as tplan

torch.set_num_threads(1)
CPU = ResourceManager.create(device="cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
B, E = 64, 16


def _power_law(rng, vocab, size, alpha=1.05):
    y = ((float(vocab) ** (1 - alpha) - 1.0) * rng.random(size) + 1.0) ** (1 / (1 - alpha))
    return np.clip(np.round(y) - 1, 0, vocab - 1).astype(np.int64)


def _place(keys, lk):
    """The JAX package's placement of a lookup's keys as numpy: cut to
    int32, the window (outside it: padding; inside: shifted down by
    key_lo), -1 padding, floor modulo into the vocabulary."""
    k = keys.astype(np.int32).astype(np.int64)
    if lk.windowed:
        hi = lk.key_hi if lk.key_hi >= 0 else 2**31 - 1
        k = np.where((k >= lk.key_lo) & (k < hi), k - lk.key_lo, -1)
    return np.where(k == -1, -1, np.mod(k, lk.vocab)).astype(np.int32)


def _pallas(keys, d, lk, e):
    """(grad [V, E], counts [V]) of one lookup by the Pallas kernel
    (interpret mode): placed keys, the lookup's columns of d, a Mean's
    division by the count of non-padding keys (at least 1)."""
    k = _place(keys, lk)
    dd = d[:, lk.out_begin : lk.out_begin + e]
    if lk.mean:
        dd = dd / np.maximum((k >= 0).sum(axis=1, keepdims=True), 1).astype(np.float32)
    vb = min(512, ((lk.vocab + 127) // 128) * 128)  # as the JAX collection picks it
    g, c = j_bwd(jnp.asarray(k), jnp.asarray(dd), lk.vocab, jnp.float32, vb=vb)
    return np.asarray(g), np.asarray(c)


def _group(rng):
    """A group of four lookups into 239 rows: a windowed tier [0, 32) of raw
    power-law keys over 5,000 (h 6, Sum); int64 keys with bits past 2^31,
    keys that wrap (negative, and past V) and -1 padding (h 3, Mean, V 57);
    int32 keys with padding (h 4, Sum, V 100); a Mean tier [32, 82) of the
    same raw keys (h 6, V 50). The keys are column views of one tensor."""
    raw = _power_law(rng, 5000, (B, 6))
    wrap = rng.integers(-400, 400, size=(B, 3)).astype(np.int64) + (2**33) * rng.integers(0, 2, size=(B, 3))
    wrap[rng.random(wrap.shape) < 0.2] = -1
    plain = rng.integers(0, 100, size=(B, 4)).astype(np.int64)
    plain[rng.random(plain.shape) < 0.2] = -1
    allk = np.concatenate([raw, wrap, plain], axis=1)
    lookups = [oh.GroupLookup(0, 32, 0, False, 0, 32), oh.GroupLookup(32, 57, E, True),
               oh.GroupLookup(89, 100, 2 * E, False), oh.GroupLookup(189, 50, 3 * E, True, 32, 82)]
    cols = [(0, 6), (6, 9), (9, 13), (0, 6)]
    return allk, cols, lookups, 239


@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
def test_group_plain_matches_pallas_per_lookup_and_group(key_dtype):
    rng = np.random.default_rng(5)
    allk, cols, lookups, rows = _group(rng)
    d = rng.normal(size=(B, 4 * E + 5)).astype(np.float32)[:, 5:]  # read through a row stride
    tk = torch.from_numpy(allk).to(key_dtype)
    keys = [tk[:, a:b] for a, b in cols]
    td = torch.from_numpy(d)
    want_g = np.zeros((rows, E), np.float32)
    want_c = np.zeros((rows,), np.float32)
    for (a, b), k, lk in zip(cols, keys, lookups):
        pg, pc = _pallas(k.numpy(), d, lk, E)
        want_g[lk.row_off : lk.row_off + lk.vocab] += pg
        want_c[lk.row_off : lk.row_off + lk.vocab] += pc
        # per lookup: a one-lookup group
        g1, c1 = oh.onehot_bwd_group([k], [lk], td, rows, E)
        np.testing.assert_allclose(g1[lk.row_off : lk.row_off + lk.vocab].numpy(), pg, **TOL)
        np.testing.assert_array_equal(c1[lk.row_off : lk.row_off + lk.vocab].numpy(), pc)
        assert float(g1.abs().sum() - g1[lk.row_off : lk.row_off + lk.vocab].abs().sum()) == 0.0
    ops.reset_counts()
    grad, cnt = oh.onehot_bwd_group(keys, lookups, td, rows, E)
    assert ops.plain_counts()["onehot_bwd"] == 1 and ops.launch_counts()["onehot_bwd"] == 0
    assert grad.dtype == cnt.dtype == torch.float32 and tuple(grad.shape) == (rows, E)
    np.testing.assert_allclose(grad.numpy(), want_g, **TOL)
    np.testing.assert_array_equal(cnt.numpy(), want_c)
    assert want_c[:32].sum() > 0 and want_c[189:].sum() > 0  # both windows take keys


def test_group_plain_accumulates_and_rejects_bad_lookups():
    rng = np.random.default_rng(6)
    allk, cols, lookups, rows = _group(rng)
    keys = [torch.from_numpy(allk[:, a:b]) for a, b in cols]
    d = torch.from_numpy(rng.normal(size=(B, 4 * E)).astype(np.float32))
    want_g, want_c = oh.onehot_bwd_group(keys, lookups, d, rows, E)
    base = torch.from_numpy(rng.normal(size=(rows, E)).astype(np.float32))
    g, c = base.clone(), torch.arange(rows, dtype=torch.float32)
    oh.onehot_bwd_group(keys, lookups, d, rows, E, out=g, cnt_out=c)
    np.testing.assert_allclose((g - base).numpy(), want_g.numpy(), **TOL)
    np.testing.assert_array_equal((c - torch.arange(rows, dtype=torch.float32)).numpy(), want_c.numpy())
    with pytest.raises(ValueError):  # rows past the storage
        oh.onehot_bwd_group(keys, lookups, d, 200, E)
    with pytest.raises(ValueError):  # columns past d
        oh.onehot_bwd_group(keys, lookups, d[:, : 3 * E], rows, E)
    with pytest.raises(ValueError):  # float keys
        oh.onehot_bwd_group([k.float() for k in keys], lookups, d, rows, E)


def test_hundred_lookups_in_three_calls_equal_one_call_per_lookup():
    rng = np.random.default_rng(7)
    n, v = 100, 40
    allk = rng.integers(-2, v + 5, size=(B, n)).astype(np.int32)
    keys = [torch.from_numpy(allk)[:, i : i + 1] for i in range(n)]
    lookups = [oh.GroupLookup(v * i, v, E * i, i % 7 == 0) for i in range(n)]
    w = [torch.from_numpy(rng.normal(size=(B, 1)).astype(np.float32)) if i % 5 == 0 else None for i in range(n)]
    d = torch.from_numpy(rng.normal(size=(B, E * n)).astype(np.float32))
    for weights in (None, w):
        ops.reset_counts()
        grad, cnt = oh.onehot_bwd_chunked(keys, lookups, d, v * n, E, weights)
        assert ops.plain_counts()["onehot_bwd"] == 3  # ceil(100 / 48)
        for i, lk in enumerate(lookups):
            wi = None if weights is None else [weights[i]]
            g1, c1 = oh.onehot_bwd_group([keys[i]], [lk], d, v * n, E, wi)
            sl = slice(lk.row_off, lk.row_off + v)
            np.testing.assert_array_equal(grad[sl].numpy(), g1[sl].numpy())
            np.testing.assert_array_equal(cnt[sl].numpy(), c1[sl].numpy())
    g0, c0 = oh.onehot_bwd_chunked([], [], d, 7, E)  # every table frozen: zeros, no call
    assert float(g0.abs().sum()) == float(c0.sum()) == 0.0 and tuple(g0.shape) == (7, E)


# ------------------------------------------------------ the collection
def _lookups(pkg, comb):
    big = pkg.EmbeddingTableConfig("big", 3000, E)
    small = pkg.EmbeddingTableConfig("small", 57, E)
    mid = pkg.EmbeddingTableConfig("mid", 100, E)
    frz = pkg.EmbeddingTableConfig("frz", 40, E)
    return [
        pkg.LookupConfig(0, big, "f0", "e0", comb.Sum, 6),
        pkg.LookupConfig(1, small, "f1", "e1", comb.Mean, 3),
        pkg.LookupConfig(2, mid, "f2", "e2", comb.Sum, 4),
        pkg.LookupConfig(3, frz, "f3", "e3", comb.Sum, 2),
    ]


def _feats(rng):
    f0 = _power_law(rng, 3000, (B, 6)).astype(np.int32)
    f1 = rng.integers(-120, 200, size=(B, 3)).astype(np.int32)
    f1[rng.random(f1.shape) < 0.2] = -1
    f2 = rng.integers(0, 100, size=(B, 4)).astype(np.int32)
    f2[rng.random(f2.shape) < 0.2] = -1
    f3 = rng.integers(0, 40, size=(B, 2)).astype(np.int32)
    return {"f0": f0, "f1": f1, "f2": f2, "f3": f3}


def test_collection_onehot_grad_matches_jax_xla(mesh1, monkeypatch):
    """`_onehot_grad` of a one-hot group holding the superhot tier [0, 32)
    of a split 3,000-row table (its raw power-law keys through the window),
    a Mean lookup with wrapping keys, a Sum lookup and a frozen table,
    against the JAX package's XLA form: one plain call for the group, the
    frozen table's rows 0."""
    for k, v in dict(HCTR_TPU_ONEHOT_VOCAB=128, HCTR_TPU_HOT_ROWS=256, HCTR_TPU_SUPERHOT_ROWS=32,
                     HCTR_TPU_SPLIT_VOCAB=1024).items():
        monkeypatch.setenv(k, str(v))
    rng = np.random.default_rng(9)
    feats = _feats(rng)
    jpl = jplan.compile_plan(_lookups(jplan, JComb), jplan.ShardingPlan([]), 1)
    jec = JEC(jpl, mesh1, JOptParams(JOpt.SGD, lr=0.1))
    tpl = tplan.compile_plan(_lookups(tplan, TComb), tplan.ShardingPlan([]), 1, onehot_vocab=128,
                             split_vocab=1024, hot_rows=256, superhot_rows=32)
    tec = TEC(tpl, CPU, TOptParams(TOpt.SGD, lr=0.1))
    jg = next(g for g in jpl.groups if g.compute_kind == "onehot")
    tg = next(g for g in tpl.groups if g.compute_kind == "onehot")
    assert [lm.top_name for lm in tg.lookups] == [lm.top_name for lm in jg.lookups]
    assert any(lm.windowed for lm in tg.lookups) and any(lm.combiner == TComb.Mean for lm in tg.lookups)
    jec.frozen_tables = {"frz"}
    tec.frozen_tables = {"frz"}
    d_group = rng.normal(size=(B, tg.out_width)).astype(np.float32)
    jgrad, jcnt = jec._onehot_grad(jg.name, jnp.float32, jec._group_keys(jg, feats), jnp.asarray(d_group))
    ops.reset_counts()
    tgrad, tcnt = tec._onehot_grad(tg.name, torch.float32, {k: torch.from_numpy(v) for k, v in feats.items()},
                                   torch.from_numpy(d_group))
    assert ops.plain_counts()["onehot_bwd"] == 1
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), **TOL)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    ti = next(i for i, t in enumerate(tg.tables) if t.name == "frz")
    off, v = int(tg.local_offsets[ti]), int(tg.table_vocab[ti])
    assert float(tgrad[off : off + v].abs().sum()) == float(tcnt[off : off + v].sum()) == 0.0


def _weighted_lookups(pkg, comb):
    t0 = pkg.EmbeddingTableConfig("t0", 100, E)
    t1 = pkg.EmbeddingTableConfig("t1", 60, E)
    return [pkg.LookupConfig(0, t0, "f0", "e0", comb.Sum, 4, sp_weight_name="w0"),
            pkg.LookupConfig(1, t0, "f1", "e1", comb.Mean, 3, sp_weight_name="w1"),
            pkg.LookupConfig(2, t1, "f2", "e2", comb.Mean, 2)]


def test_collection_weighted_onehot_grad_matches_jax_xla(mesh1, monkeypatch):
    """Weighted Sum and Mean lookups and an unweighted Mean one in one
    group against the JAX package's XLA counts path: the gradient, the
    touched rows, and the touch counts sum_b |sum_h w|, so a row that one
    sample holds twice with weights +w and -w (and no other sample holds)
    is not touched."""
    monkeypatch.setenv("HCTR_TPU_ONEHOT_VOCAB", "128")
    rng = np.random.default_rng(21)
    feats = {"f0": rng.integers(0, 100, size=(B, 4)).astype(np.int32),
             "f1": rng.integers(-1, 100, size=(B, 3)).astype(np.int32),
             "f2": rng.integers(-1, 60, size=(B, 2)).astype(np.int32)}
    feats["f0"][feats["f0"] == 7] = 8
    feats["f1"][feats["f1"] == 7] = 8
    feats["f0"][3] = [7, 7, 9, -1]  # row 7 twice in one sample, weights that cancel
    w = {"w0": rng.normal(size=(B, 4)).astype(np.float32), "w1": (rng.random((B, 3)) + 0.1).astype(np.float32)}
    w["w0"][3, :2] = [0.75, -0.75]
    w["w1"][2] = 0.0  # a weighted Mean whose weights sum to 0 divides by 1
    jpl = jplan.compile_plan(_weighted_lookups(jplan, JComb), jplan.ShardingPlan([]), 1)
    jec = JEC(jpl, mesh1, JOptParams(JOpt.SGD, lr=0.1))
    tpl = tplan.compile_plan(_weighted_lookups(tplan, TComb), tplan.ShardingPlan([]), 1, onehot_vocab=128)
    tec = TEC(tpl, CPU, TOptParams(TOpt.SGD, lr=0.1))
    (jg,), (tg,) = jpl.groups, tpl.groups
    assert tg.compute_kind == jg.compute_kind == "onehot"
    keys = np.concatenate([feats[lm.bottom_name] for lm in jg.lookups], axis=1)
    wg = np.concatenate([w[lm.sp_weight_name] if lm.sp_weight_name else np.ones((B, lm.hotness), np.float32)
                         for lm in jg.lookups], axis=1) * (keys != -1)
    d = rng.normal(size=(B, tg.out_width)).astype(np.float32)
    jgrad, jcnt = jec._onehot_grad(jg.name, jnp.float32, jnp.asarray(keys), jnp.asarray(d),
                                   weights=jnp.asarray(wg))
    ops.reset_counts()
    tgrad, tcnt = tec._onehot_grad(tg.name, torch.float32, {k: torch.from_numpy(v) for k, v in feats.items()},
                                   torch.from_numpy(d), {k: torch.from_numpy(v) for k, v in w.items()})
    assert ops.plain_counts()["onehot_bwd"] == 1
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), **TOL)
    np.testing.assert_array_equal(tcnt.numpy() > 0, np.asarray(jcnt) > 0)
    np.testing.assert_allclose(tcnt.numpy(), np.asarray(jcnt), rtol=1e-6)
    row7 = int(tg.local_offsets[0]) + 7
    assert float(tcnt[row7]) == 0.0 and float(tgrad[row7].abs().sum()) == 0.0
