"""Plain versions of the port's kernels against the JAX package's Pallas
kernels (interpret mode on the CPU) and their XLA forms. The CUDA kernels
are held against these plain versions on the card in test_torch_gpu.py.

Tolerances: float32 throughout. Segmented scan rtol 1e-5 / atol 1e-5, as
tests/test_pallas_segscan.py; one-hot rtol 1e-4 / atol 1e-5, as
tests/test_onehot_engine.py (sums taken in another order).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hugectr_tpu.embedding import sparse_optimizer as jso
from hugectr_tpu.ops.pallas.onehot_matmul import onehot_matmul_bwd as j_bwd
from hugectr_tpu.ops.pallas.onehot_matmul import onehot_matmul_fwd as j_fwd
from hugectr_tpu.ops.pallas.segscan import segmented_sum_sorted as j_segscan
from hugectr_tpu_torch import ops
from hugectr_tpu_torch.embedding import sparse_optimizer as tso
from hugectr_tpu_torch.ops import onehot_matmul as oh
from hugectr_tpu_torch.ops import segscan as ss

torch.set_num_threads(1)
SEG_TOL = dict(rtol=1e-5, atol=1e-5)
OH_TOL = dict(rtol=1e-4, atol=1e-5)


def _sorted_heads(rng, k, nseg):
    seg = np.sort(rng.integers(0, nseg, k))
    return np.concatenate([[True], seg[1:] != seg[:-1]])


@pytest.mark.parametrize("k,e,block", [(1024, 8, 128), (2048, 128, 512)])
def test_segscan_plain_matches_pallas(k, e, block):
    rng = np.random.default_rng(0)
    heads = _sorted_heads(rng, k, k // 3)
    vals = rng.normal(size=(k, e)).astype(np.float32)
    want = np.asarray(j_segscan(jnp.asarray(vals), jnp.asarray(heads), block=block))
    ops.reset_counts()
    got = ss.segmented_sum_sorted(torch.from_numpy(vals), torch.from_numpy(heads))
    assert ops.plain_counts()["segscan"] == 1
    np.testing.assert_allclose(got.numpy(), want, **SEG_TOL)


@pytest.mark.parametrize("case", ["one_segment", "all_heads"])
def test_segscan_plain_edge_cases_match_pallas(case):
    k, e = 256, 16
    vals = np.ones((k, e), np.float32)
    heads = np.zeros(k, bool) if case == "one_segment" else np.ones(k, bool)
    heads[0] = True
    want = np.asarray(j_segscan(jnp.asarray(vals), jnp.asarray(heads), block=64))
    got = ss.segmented_sum_sorted(torch.from_numpy(vals), torch.from_numpy(heads)).numpy()
    np.testing.assert_allclose(got, want, **SEG_TOL)
    if case == "one_segment":
        np.testing.assert_allclose(got[:, 0], np.arange(1, k + 1))


def test_segscan_ragged_k_needs_no_padding():
    """K = 1000 is no multiple of the Pallas block; the port takes it as is
    and agrees with the padded Pallas run on the first K rows."""
    rng = np.random.default_rng(3)
    k, e = 1000, 8
    heads = _sorted_heads(rng, k, 200)
    vals = rng.normal(size=(k, e)).astype(np.float32)
    pad = 24
    hp = np.concatenate([heads, np.ones(pad, bool)])
    vp = np.concatenate([vals, np.zeros((pad, e), np.float32)])
    want = np.asarray(j_segscan(jnp.asarray(vp), jnp.asarray(hp), block=128))[:k]
    got = ss.segmented_sum_sorted(torch.from_numpy(vals), torch.from_numpy(heads)).numpy()
    np.testing.assert_allclose(got, want, **SEG_TOL)


def test_segscan_tails_match_xla_segment_sum():
    """Tail rows of the scan contract == the XLA contract's unique-row sums
    (dedup_rows segsum="xla", sparse_optimizer.py:151-173)."""
    rng = np.random.default_rng(1)
    k, e, rows = 3000, 16, 500
    idx = rng.integers(0, rows + 1, k).astype(np.int32)  # rows == sentinel
    src = rng.integers(0, 700, k).astype(np.int32)
    dsrc = rng.normal(size=(700, e)).astype(np.float32)
    urow, summed, _tail, _u = jso.dedup_rows(
        jnp.asarray(idx), jnp.asarray(src), jnp.asarray(dsrc), sentinel=rows, segsum="xla"
    )
    urow, summed = np.asarray(urow), np.asarray(summed)
    sidx, tsum, tail = tso.dedup_rows(
        torch.from_numpy(idx).long(), torch.from_numpy(src).long(), torch.from_numpy(dsrc)
    )
    keep = (tail & (sidx < rows)).numpy()
    real = urow < rows
    np.testing.assert_array_equal(sidx.numpy()[keep], urow[real])
    np.testing.assert_allclose(tsum.numpy()[keep], summed[real], **SEG_TOL)


def _keys(rng, b, h, v, pad=0.2):
    k = rng.integers(0, v, size=(b, h)).astype(np.int32)
    k[rng.random((b, h)) < pad] = -1
    return k


def _xla_counts(keys, v):
    """The XLA one-hot counts matrix (collection.py:1283-1292)."""
    k = jnp.asarray(keys)
    iota = jnp.arange(v, dtype=jnp.int32)[None, :]
    return sum(((k[:, h : h + 1] == iota) & (k[:, h : h + 1] >= 0)).astype(jnp.float32)
               for h in range(k.shape[1]))


ONEHOT_CASES = [(300, 57, 1), (300, 100, 3), (300, 600, 6)]


@pytest.mark.parametrize("b,v,h", ONEHOT_CASES)
def test_onehot_fwd_plain_matches_pallas_and_xla(b, v, h):
    rng = np.random.default_rng(v + h)
    keys = _keys(rng, b, h, v)
    table = rng.normal(size=(v, 16)).astype(np.float32)
    vb = min(512, ((v + 127) // 128) * 128)  # as collection.py:1329
    pallas = np.asarray(j_fwd(jnp.asarray(keys), jnp.asarray(table), vb=vb))
    xla = np.asarray(_xla_counts(keys, v) @ jnp.asarray(table))
    ops.reset_counts()
    got = oh.onehot_matmul_fwd(torch.from_numpy(keys), torch.from_numpy(table)).numpy()
    assert ops.plain_counts()["onehot_fwd"] == 1
    np.testing.assert_allclose(got, pallas, **OH_TOL)
    np.testing.assert_allclose(got, xla, **OH_TOL)


@pytest.mark.parametrize("b,v,h", ONEHOT_CASES)
def test_onehot_bwd_plain_matches_pallas_and_xla(b, v, h):
    rng = np.random.default_rng(10 * v + h)
    keys = _keys(rng, b, h, v)
    d = rng.normal(size=(b, 16)).astype(np.float32)
    vb = min(512, ((v + 127) // 128) * 128)
    pg, pc = j_bwd(jnp.asarray(keys), jnp.asarray(d), v, jnp.float32, vb=vb)
    counts = _xla_counts(keys, v)
    xg, xc = np.asarray(counts.T @ jnp.asarray(d)), np.asarray(counts.sum(axis=0))
    ops.reset_counts()
    grad, cnt = oh.onehot_matmul_bwd(torch.from_numpy(keys), torch.from_numpy(d), v, torch.float32)
    assert ops.plain_counts()["onehot_bwd"] == 1
    np.testing.assert_allclose(grad.numpy(), np.asarray(pg), **OH_TOL)
    np.testing.assert_allclose(grad.numpy(), xg, **OH_TOL)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(pc))
    np.testing.assert_array_equal(cnt.numpy(), xc)


@pytest.mark.parametrize("b,v,h", ONEHOT_CASES)
def test_onehot_bwd_plain_accumulates_into_caller_buffers(b, v, h):
    """out=/cnt_out=: the Pallas gradient and counts are added into slices of
    a caller's float32 buffers; the rest of the buffers stays as it was."""
    rng = np.random.default_rng(20 * v + h)
    keys = _keys(rng, b, h, v)
    d = rng.normal(size=(b, 16)).astype(np.float32)
    pg, pc = j_bwd(jnp.asarray(keys), jnp.asarray(d), v, jnp.float32, vb=min(512, ((v + 127) // 128) * 128))
    off = 5
    base = rng.normal(size=(off + v + 3, 16)).astype(np.float32)
    cbase = np.arange(off + v + 3, dtype=np.float32)
    grad, cnt = torch.from_numpy(base.copy()), torch.from_numpy(cbase.copy())
    g, c = oh.onehot_matmul_bwd(torch.from_numpy(keys), torch.from_numpy(d), v, torch.float32,
                                out=grad[off : off + v], cnt_out=cnt[off : off + v])
    assert g.data_ptr() == grad[off].data_ptr() and c.data_ptr() == cnt[off].data_ptr()
    np.testing.assert_allclose(grad.numpy()[off : off + v] - base[off : off + v], np.asarray(pg), **OH_TOL)
    np.testing.assert_array_equal(cnt.numpy()[off : off + v], cbase[off : off + v] + np.asarray(pc))
    np.testing.assert_array_equal(grad.numpy()[:off], base[:off])
    np.testing.assert_array_equal(grad.numpy()[off + v :], base[off + v :])
    with pytest.raises(ValueError, match="out/cnt_out"):
        oh.onehot_matmul_bwd(torch.from_numpy(keys), torch.from_numpy(d), v, torch.bfloat16,
                             out=grad[off : off + v], cnt_out=cnt[off : off + v])


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="int32"):
        oh.onehot_matmul_fwd(torch.zeros((4, 2), dtype=torch.int64), torch.zeros((3, 8)))
    with pytest.raises(ValueError, match="f32/bf16"):
        oh.onehot_matmul_fwd(torch.zeros((4, 2), dtype=torch.int32), torch.zeros((3, 8), dtype=torch.float64))
    with pytest.raises(ValueError, match="heads"):
        ss.segmented_sum_sorted(torch.zeros((4, 8)), torch.ones(4, dtype=torch.uint8))
