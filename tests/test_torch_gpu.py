"""The port's CUDA kernels against their plain PyTorch versions on the card.

Runs only where there is a card; elsewhere each test skips. The card's
machine has no JAX, so run this file without the suite's conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q -p no:randomly

Tolerance: |kernel - plain| / (sum of |inputs| into the element) <= 1e-4 in
float32 (sums in another order, with atomics in the backward) and 1e-2 in
bfloat16 (one more rounding of the output). Touch counts are exact, and the
segmented scan is bitwise the same from run to run.
"""
import numpy as np
import pytest
import torch

from hugectr_tpu_torch import ops
from hugectr_tpu_torch.ops import onehot_matmul as oh
from hugectr_tpu_torch.ops import segscan as ss

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# (B, V, h): ragged shapes with padding, and table 3 of the flagship
ONEHOT_CASES = [(300, 57, 1), (300, 100, 3), (300, 600, 6), (4096, 7424, 2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _scaled(got, want, scale):
    return float(((got.double() - want.double()).abs() / (scale.double() + 1e-30)).max())


def _keys(rng, b, h, v, pad=0.2):
    k = rng.integers(0, v, size=(b, h)).astype(np.int32)
    k[rng.random((b, h)) < pad] = -1
    return k


def _check_bwd(keys, d, v, dtype):
    g, c = oh.onehot_matmul_bwd(keys, d, v, dtype)
    assert g.dtype == dtype and g.shape == (v, d.shape[1]) and c.dtype == torch.float32
    wg, wc = oh.onehot_matmul_bwd_plain(keys, d, v, dtype)
    sg, _ = oh.onehot_matmul_bwd_plain(keys, d.float().abs(), v, torch.float32)
    assert _scaled(g, wg, sg) <= TOL[dtype]
    assert torch.equal(c, wc)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onehot_kernels_match_plain_versions(cuda, dtype):
    rng = np.random.default_rng(5)
    for b, v, h in ONEHOT_CASES:
        keys = torch.from_numpy(_keys(rng, b, h, v)).to(cuda)
        table = torch.from_numpy(rng.normal(size=(v, 128)).astype(np.float32)).to(cuda, dtype)
        d = torch.from_numpy(rng.normal(size=(b, 128)).astype(np.float32)).to(cuda, dtype)
        ops.reset_counts()
        out = oh.onehot_matmul_fwd(keys, table)
        g, c = oh.onehot_matmul_bwd(keys, d, v, dtype)
        assert ops.launch_counts()["onehot_fwd"] == 1 and ops.launch_counts()["onehot_bwd"] == 1
        assert out.dtype == dtype and g.dtype == dtype and c.dtype == torch.float32
        scale = oh.onehot_matmul_fwd_plain(keys, table.float().abs())
        assert _scaled(out, oh.onehot_matmul_fwd_plain(keys, table), scale) <= TOL[dtype]
        wg, wc = oh.onehot_matmul_bwd_plain(keys, d, v, dtype)
        sg, _ = oh.onehot_matmul_bwd_plain(keys, d.float().abs(), v, torch.float32)
        assert _scaled(g, wg, sg) <= TOL[dtype]
        assert torch.equal(c, wc)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onehot_bwd_hot_row_and_tile_edges(cuda, dtype):
    """Every key on one row; V one below, at and one above the most rows the
    privatised route holds in shared memory; the engine's largest table; all
    padding; a width that is no multiple of 4. Both routes are taken."""
    rng = np.random.default_rng(8)
    vt = oh.bwd_tile_rows(128, cuda)
    assert vt >= 64
    hot = np.full((16384, 40), 5, np.int32)
    cases = [(hot, 108, 128)]
    for v in (vt - 1, vt, vt + 1):  # privatised, privatised, global
        cases.append((_keys(rng, 4096, 40, v, pad=0.1), v, 128))
    for v, h in ((8192, 300), (8192, 2)):  # global
        cases.append((_keys(rng, 8192, h, v, pad=0.1), v, 128))
    cases.append((np.full((1000, 3), -1, np.int32), 100, 128))
    cases.append((_keys(rng, 777, 5, 1000), 1000, 37))
    routes = set()
    for keys_np, v, e in cases:
        routes.add(oh.bwd_route(keys_np.shape[0], keys_np.shape[1], v, e, cuda))
        keys = torch.from_numpy(keys_np).to(cuda)
        d = torch.from_numpy(rng.normal(size=(keys_np.shape[0], e)).astype(np.float32))
        _check_bwd(keys, d.to(cuda, dtype), v, dtype)
    assert routes == {"privatised", "global"}


@pytest.mark.gpu
def test_onehot_bwd_accumulates_into_caller_buffers(cuda):
    rng = np.random.default_rng(9)
    v, e, off = 300, 128, 40
    keys = torch.from_numpy(_keys(rng, 2000, 4, v)).to(cuda)
    d = torch.from_numpy(rng.normal(size=(2000, e)).astype(np.float32)).to(cuda)
    base = torch.from_numpy(rng.normal(size=(off + v + 7, e)).astype(np.float32)).to(cuda)
    cbase = torch.arange(off + v + 7, dtype=torch.float32, device=cuda)
    grad, cnt = base.clone(), cbase.clone()
    g, c = oh.onehot_matmul_bwd(keys, d, v, torch.float32, out=grad[off : off + v],
                                cnt_out=cnt[off : off + v])
    assert g.data_ptr() == grad[off].data_ptr() and c.data_ptr() == cnt[off].data_ptr()
    wg, wc = oh.onehot_matmul_bwd_plain(keys, d, v, torch.float32)
    sg, _ = oh.onehot_matmul_bwd_plain(keys, d.abs(), v, torch.float32)
    assert _scaled(grad[off : off + v] - base[off : off + v], wg, sg) <= 1e-4
    assert torch.equal(grad[:off], base[:off]) and torch.equal(grad[off + v :], base[off + v :])
    assert torch.equal(cnt[off : off + v], cbase[off : off + v] + wc)
    assert torch.equal(cnt[:off], cbase[:off])


def _heads(rng, k, nseg):
    seg = np.sort(rng.integers(0, nseg, k))
    return np.concatenate([[True], seg[1:] != seg[:-1]])[:k]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segscan_kernel_matches_plain_version(cuda, dtype):
    rng = np.random.default_rng(6)
    for k, nseg in ((1, 1), (1000, 1), (1000, 1000), (100_003, 20_000)):
        seg = np.sort(rng.integers(0, nseg, k))
        heads = torch.from_numpy(np.concatenate([[True], seg[1:] != seg[:-1]])).to(cuda)
        vals = torch.from_numpy(rng.normal(size=(k, 128)).astype(np.float32)).to(cuda, dtype)
        got = ss.segmented_sum_sorted(vals, heads)
        scale = ss.segmented_sum_sorted_plain(vals.float().abs(), heads)
        assert _scaled(got, ss.segmented_sum_sorted_plain(vals, heads), scale) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segscan_tile_edges_and_long_segments(cuda, dtype):
    """K one below, at and one above a tile and two tiles; K below a tile;
    one segment across every tile; all heads; a head missing on row 0 (row 0
    always starts a segment); widths that are no multiple of 4."""
    rng = np.random.default_rng(12)
    t = ss.tile_rows()
    cases = [(k, _heads(rng, k, k // 3 + 1), 128) for k in (t - 1, t, t + 1, 2 * t + 1, 17)]
    cases.append((200_000, np.eye(1, 200_000, dtype=bool)[0], 128))
    cases.append((5000, np.ones(5000, bool), 128))
    cases.append((3000, np.zeros(3000, bool), 128))
    cases.append((3001, _heads(rng, 3001, 50), 37))
    cases.append((2 * t + 3, _heads(rng, 2 * t + 3, 9), 8))
    for k, heads_np, e in cases:
        heads = torch.from_numpy(heads_np).to(cuda)
        vals = torch.from_numpy(rng.normal(size=(k, e)).astype(np.float32)).to(cuda, dtype)
        got = ss.segmented_sum_sorted(vals, heads)
        assert got.shape == (k, e) and got.dtype == dtype
        scale = ss.segmented_sum_sorted_plain(vals.float().abs(), heads)
        err = _scaled(got, ss.segmented_sum_sorted_plain(vals, heads), scale)
        assert err <= TOL[dtype], (k, e, err)
    empty = torch.zeros((0, 128), device=cuda, dtype=dtype)
    assert ss.segmented_sum_sorted(empty, torch.zeros(0, dtype=torch.bool, device=cuda)).shape == (0, 128)


@pytest.mark.gpu
def test_segscan_is_bitwise_deterministic(cuda):
    rng = np.random.default_rng(13)
    for k, nseg in ((300_001, 30_000), (300_001, 1), (300_001, 40)):
        heads = torch.from_numpy(_heads(rng, k, nseg)).to(cuda)
        vals = torch.from_numpy(rng.normal(size=(k, 128)).astype(np.float32)).to(cuda)
        first = ss.segmented_sum_sorted(vals, heads)
        for _ in range(3):
            assert torch.equal(ss.segmented_sum_sorted(vals, heads), first)
