"""The port's CUDA kernels against their plain PyTorch versions on the card.

Runs only where there is a card; elsewhere each test skips. The card's
machine has no JAX, so run this file without the suite's conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q -p no:randomly

Tolerance: |kernel - plain| / (sum of |inputs| into the element) <= 1e-4 in
float32 (sums in another order, with atomics in the backward) and 1e-2 in
bfloat16 (one more rounding of the output); the grouped backward's float32
sums of values exact in d's type within 1e-4 in either type. Touch counts
are exact, and the segmented scan and the backward's counts matmul are
bitwise the same from run to run. The sorted route's row update
(`adagrad_rows`) is bitwise its plain version for AdaGrad and within its
row sum's spread for RowWiseAdaGrad; FTRL's (`ftrl_rows`) and Adam's
(`adam_rows`) are bitwise. The tiny DLRM-FTRL's captured steps agree with
its eager ones within rtol 1e-4 / atol 1e-5 (atomic sums), its replayed
eval bitwise; so do a tiny WDL's (Dropout 0.5) and MMoE's (SGD). Dropout's
mask kernel is bitwise its plain version, and two consecutive replays of a
captured draw give two masks. The last tests run the embedding collection
and train the tiny model on 2 spawned ranks against one card.
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from hugectr_tpu_torch import ops
from hugectr_tpu_torch.ops import onehot_matmul as oh
from hugectr_tpu_torch.ops import ordered_pool as op
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


def _check_bwd(keys, d, v, dtype, route=None):
    g, c = oh.onehot_matmul_bwd(keys, d, v, dtype, route=route)
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
    padding; a width that is no multiple of 4. The launcher takes the counts
    matmul and the global atomics here; each shape then runs on every route
    that can take it."""
    rng = np.random.default_rng(8)
    vt = oh.bwd_tile_rows(128, cuda)
    assert vt >= 64
    hot = np.full((16384, 40), 5, np.int32)
    cases = [(hot, 108, 128)]
    for v in (vt - 1, vt, vt + 1):  # around the privatised route's limit
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
        for route in oh.BWD_ROUTES:
            if ((route == "privatised" and v > oh.bwd_tile_rows(e, cuda))
                    or (route == "mma" and (e % 8 or keys_np.shape[1] > 128))):
                with pytest.raises(ValueError):
                    oh.onehot_matmul_bwd(keys, d.to(cuda, dtype), v, dtype, route=route)
                continue
            _check_bwd(keys, d.to(cuda, dtype), v, dtype, route)
    assert routes == {"mma", "global"}


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


def _check_group(keys, lookups, table, width):
    ops.reset_counts()
    got = oh.onehot_fwd_group(keys, lookups, table, width)
    assert ops.launch_counts()["onehot_fwd"] == 1
    assert got.dtype == table.dtype and got.shape == (keys[0].shape[0], width)
    want = oh.onehot_fwd_group_plain(keys, lookups, table, width)
    scale = oh.onehot_fwd_group_plain(keys, lookups, table.float().abs(), width)
    err = _scaled(got, want, scale)
    assert err <= TOL[table.dtype], err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onehot_fwd_group_at_the_flagship_group(cuda, dtype):
    """The flagship's 13-table group at batch 16,384, power-law keys as
    int32 column views of one [B, 62] tensor, one launch per call: table
    24 on the counts matmul, the other 12 gathered."""
    from hugectr_tpu_torch.tools.flagship import onehot_group_inputs

    keys, lookups, table, width = onehot_group_inputs(np.random.default_rng(3), 16384, 128, dtype, cuda)
    assert keys[0].stride(1) == 1 and keys[0].stride(0) == 62
    routes = [oh.fwd_route(lk.vocab, k.shape[1], 128, cuda) for k, lk in zip(keys, lookups)]
    assert routes.count("mma") == 1 and routes.count("gather") == 12
    _check_group(keys, lookups, table, width)


def _edge_group(rng, b, spec, e, dtype, cuda, int64=False):
    """spec: (V, h, mean) per lookup. Keys: -1 padding, negative, >= V and,
    as int64, >= 2^31; sample 0 all padding."""
    cols, lookups, row = [], [], 0
    for i, (v, h, mean) in enumerate(spec):
        k = rng.integers(0, v, size=(b, h)).astype(np.int64)
        r = rng.random((b, h))
        k[r < 0.1] = -1
        k[(r >= 0.1) & (r < 0.2)] = -rng.integers(2, 5 * v, size=int(((r >= 0.1) & (r < 0.2)).sum()))
        k[(r >= 0.2) & (r < 0.3)] += v * rng.integers(1, 4)
        if int64:
            k[(r >= 0.3) & (r < 0.4)] = 2**31 + rng.integers(0, 2**31, size=int(((r >= 0.3) & (r < 0.4)).sum()))
            k[(r >= 0.4) & (r < 0.45)] = 2**32 - 1
        k[0] = -1
        cols.append(k)
        lookups.append(oh.GroupLookup(row + 3, v, i * e, mean))
        row += v
    allk = torch.from_numpy(np.concatenate(cols, axis=1).astype(np.int64 if int64 else np.int32)).to(cuda)
    keys, c = [], 0
    for v, h, _m in spec:
        keys.append(allk[:, c : c + h])
        c += h
    table = torch.from_numpy(rng.normal(size=(row + 5, e)).astype(np.float32)).to(cuda, dtype)
    return keys, lookups, table, len(spec) * e


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onehot_fwd_group_edge_cases(cuda, dtype):
    """Sum and Mean lookups on both routes; negative and >= V keys; int64
    keys >= 2^31; h 1 beside h 128; a width that is no multiple of 4; all
    padding; a group of small tables only; a one-lookup group equal to the
    per-table forward."""
    rng = np.random.default_rng(14)
    mixed = [(108, 40, True), (7424, 2, False), (3, 1, True), (100, 128, False), (63, 1, False),
             (57, 16, True)]
    for int64 in (False, True):
        keys, lookups, table, width = _edge_group(rng, 3000, mixed, 128, dtype, cuda, int64)
        _check_group(keys, lookups, table, width)
    assert [oh.fwd_route(v, h, 128, cuda) for v, h, _m in mixed] == [
        "mma", "gather", "gather", "mma", "gather", "mma"]
    small = [(108, 40, True), (3, 1, False), (120, 20, False)]
    keys, lookups, table, width = _edge_group(rng, 1000, small, 128, dtype, cuda)
    _check_group(keys, lookups, table, width)
    keys, lookups, table, width = _edge_group(rng, 777, [(100, 5, True), (40, 17, False)], 37, dtype, cuda)
    _check_group(keys, lookups, table, width)
    # counts matmul at a width that is no multiple of its 32-column slices
    keys, lookups, table, width = _edge_group(rng, 500, [(100, 20, True), (7, 1, False)], 40, dtype, cuda)
    assert oh.fwd_route(100, 20, 40, cuda) == "mma"
    _check_group(keys, lookups, table, width)
    pad = [torch.full((500, 3), -1, dtype=torch.int32, device=cuda)] * 2
    lk = [oh.GroupLookup(0, 50, 0, False), oh.GroupLookup(0, 50, 128, True)]
    table = torch.ones((50, 128), device=cuda, dtype=dtype)
    assert torch.equal(oh.onehot_fwd_group(pad, lk, table, 256), torch.zeros((500, 256), device=cuda, dtype=dtype))
    k1 = torch.from_numpy(_keys(rng, 2000, 40, 108)).to(cuda)
    t1 = torch.from_numpy(rng.normal(size=(108, 128)).astype(np.float32)).to(cuda, dtype)
    g1 = oh.onehot_fwd_group([k1], [oh.GroupLookup(0, 108, 0, False)], t1, 128)
    assert _scaled(oh.onehot_matmul_fwd(k1, t1), g1,
                   oh.onehot_matmul_fwd_plain(k1, t1.float().abs())) <= TOL[dtype]


def _heads(rng, k, nseg):
    seg = np.sort(rng.integers(0, nseg, k))
    return np.concatenate([[True], seg[1:] != seg[:-1]])[:k]


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [49, 96, 100])
def test_onehot_fwd_chunked_past_48_lookups(cuda, n, dtype, weighted):
    """A one-hot group of n > 48 lookups (the 510-table case's group of
    1,000-row tables at hotness 1-3, Sum and Mean): ceil(n / 48) launches,
    each writing its lookups' columns, against one plain call."""
    rng = np.random.default_rng(n)
    b, v, e = 512, 1000, 32
    lookups = [oh.GroupLookup(v * i, v, e * i, i % 7 == 0) for i in range(n)]
    keys = [torch.from_numpy(_keys(rng, b, 1 + i % 3, v + 50)).to(cuda) for i in range(n)]
    ws = [torch.rand(k.shape, device=cuda) for k in keys] if weighted else None
    table = torch.randn((v * n, e), device=cuda).to(dtype)
    before = oh.LAUNCHES["onehot_fwd"]
    got = oh.onehot_fwd_chunked(keys, lookups, table, e * n, ws)
    assert oh.LAUNCHES["onehot_fwd"] - before == -(-n // oh.MAX_GROUP_LOOKUPS)
    want = oh.onehot_fwd_group_plain(keys, lookups, table, e * n, ws)
    scale = oh.onehot_fwd_group_plain(keys, lookups, table.float().abs(), e * n, ws)
    assert got.dtype == dtype and got.shape == want.shape
    assert _scaled(got, want, scale) <= TOL[dtype]
    with pytest.raises(ValueError, match="at most 48"):
        oh.onehot_fwd_group(keys, lookups, table, e * n, ws)


def _peak_partial_sums(idx, vals, rows):
    """[rows, E] float64: for each element, the largest |partial sum| that
    the ordered adds (by row, then by position) pass through."""
    o = torch.sort(idx, stable=True).indices
    sidx, sv = idx[o], vals[o].double()
    head = torch.ones_like(sidx, dtype=torch.bool)
    head[1:] = sidx[1:] != sidx[:-1]
    pos = torch.arange(sidx.numel())
    start = torch.cummax(torch.where(head, pos, 0), 0).values
    cs = sv.cumsum(0)
    part = (cs - cs[start] + sv[start]).abs()
    return torch.zeros((rows, sv.shape[1]), dtype=torch.float64).scatter_reduce_(
        0, sidx.unsqueeze(1).expand_as(part), part, "amax")


@pytest.mark.gpu
def test_bf16_dense_grad_buffer_on_the_card(cuda):
    """The dense sweep's bf16 buffer: `index_add_` into bf16 on the card
    against the ordered adds on the CPU. Each add rounds the running sum
    by at most 2^-8 of it, so one element's n adds carry a rounding of
    about lim = 2^-8 x sqrt(n) x (the largest |partial sum| of the ordered
    adds). Three limits, all held: an element within 2^-7 x sqrt(n) x
    sum |g| (the bound for rows of few adds), and within 8 lim (4.2 lim at
    most in 28 random orders of such inputs, simulated on the CPU); each
    row of at least 256 adds within 0.5 of lim in its rms over the columns
    (at most 0.39 there; dropping a tenth of the hottest row's adds gives
    0.55-0.65)."""
    from hugectr_tpu_torch.embedding import sparse_optimizer as so

    rng = np.random.default_rng(9)
    rows, k = 4096, 50000
    idx = torch.from_numpy(np.minimum(rng.pareto(1.1, k) * 3, rows - 1).astype(np.int64)).to(cuda)
    src = torch.arange(k, device=cuda)
    vals = torch.randn((k, 64), device=cuda)
    got = so.bf16_row_sums(idx, src, vals, rows)
    want = so.bf16_row_sums(idx.cpu(), src.cpu(), vals.cpu(), rows)
    idx, vals = idx.cpu(), vals.cpu()
    n = torch.bincount(idx, minlength=rows).double().unsqueeze(1)
    absum = torch.zeros((rows, 64), dtype=torch.float64).index_add_(0, idx, vals.abs().double())
    lim = 2.0**-8 * n.sqrt() * _peak_partial_sums(idx, vals, rows)
    diff = (got.cpu().double() - want.double()).abs()
    hot = n[:, 0] >= 256
    assert got.dtype == torch.bfloat16 and int(hot.sum()) > 0
    assert float((diff / (n.sqrt() * absum + 1e-30)).max()) <= 2.0**-7
    assert float((diff / lim.clamp_min(1e-30)).max()) <= 8
    assert float(((diff[hot] ** 2).mean(1).sqrt() / (lim[hot] ** 2).mean(1).sqrt()).max()) <= 0.5


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


def _row_update_edges(rng, k, rows, pad):
    """Sorted ids: a negative one first, runs across the 32-id tiles' edges
    (28-36, 60-70, 220-230), the last `pad` the sentinel rows."""
    ids = np.sort(rng.integers(0, rows, size=k - pad))
    ids[0] = -1
    for lo, hi in ((28, 37), (60, 71), (220, 231)):
        ids[lo:hi] = ids[lo]
    return np.concatenate([ids, np.full(pad, rows)])


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _row_update_within(kind, table, t1, a1, t2, a2):
    """AdaGrad bitwise; RowWiseAdaGrad within the spread of its row mean's
    sum order: the tolerance of chip_smoke.row_update_agrees, taken from
    there so that the test and the smoke hold the kernel to one bound."""
    ok_t, ok_a, _bitwise, _d_t, _d_a = _chip_smoke().row_update_agrees(torch, kind, table.dtype, table, t1, a1,
                                                                        t2, a2)
    return ok_t and ok_a


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["adagrad", "rowwise_adagrad"])
def test_adagrad_rows_edges_and_capture(cuda, kind, dtype):
    """The sorted route's row update against its plain version at its
    design's edges: E 1, 11, 16, 18 (the samples'), 128 and 256 (a
    RowWiseAdaGrad row walked twice), and 128 on rows that start off 4
    elements (one column a lane); counts 0, 31, 32, 33, 64, 65, 224 (inside
    a run over 220-230) and the list's length K; a bfloat16 or float32 lr;
    runs across the tiles' edges and a negative id. AdaGrad bitwise,
    RowWiseAdaGrad within its tolerance, two runs bitwise, and a replay of
    the captured launch bitwise the eager one."""
    from hugectr_tpu_torch.core.types import Optimizer_t
    from hugectr_tpu_torch.ops import row_scatter as rs
    from hugectr_tpu_torch.optim.params import OptParams

    rng = np.random.default_rng(21)
    opt = OptParams(optimizer=Optimizer_t(kind), initial_accu_value=0.0)
    k, rows = 1000, 3000
    sidx = torch.from_numpy(_row_update_edges(rng, k, rows, 100)).to(cuda)
    for i, (e, shift) in enumerate(((1, 0), (11, 0), (16, 0), (18, 0), (128, 0), (256, 0), (128, 1))):
        width = 1 if kind == "rowwise_adagrad" else e
        table = torch.from_numpy(rng.normal(size=(rows, e)).astype(np.float32) * 0.01).to(cuda, dtype)
        accum = torch.from_numpy(rng.random((rows, width), dtype=np.float32) * 1e-3).to(cuda, dtype)
        g = torch.from_numpy(rng.normal(size=(k, e)).astype(np.float32)).to(cuda)
        lr = torch.tensor(0.005, device=cuda).to(dtype if i % 2 else torch.float32)

        def copy():  # the table's copy `shift` elements past an aligned start
            t = torch.empty(rows * e + shift, device=cuda, dtype=dtype)[shift:].view(rows, e)
            return t.copy_(table), accum.clone()

        for n in (0, 31, 32, 33, 64, 65, 224, k):
            count = torch.tensor(n, device=cuda)
            (t1, a1), (t2, a2), (t3, a3) = copy(), copy(), copy()
            rs.adagrad_rows(opt, t1, a1, sidx, g, count, lr)
            rs.adagrad_rows(opt, t3, a3, sidx, g, count, lr)
            rs.adagrad_rows_plain(opt, t2, a2, sidx, g, count, lr)
            torch.cuda.synchronize()
            assert _row_update_within(opt.optimizer, table, t1, a1, t2, a2), (e, shift, n)
            assert torch.equal(t1, t3) and torch.equal(a1, a3), (e, shift, n)
            assert (n == 0) == torch.equal(t1, table), (e, shift, n)
        # a captured launch, replayed, against an eager one from the same state
        t4, a4 = copy()
        before = rs.LAUNCHES["adagrad_rows"]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            rs.adagrad_rows(opt, t4, a4, sidx, g, count, lr)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(t4, t1) and torch.equal(a4, a1), (e, shift)
        assert rs.LAUNCHES["adagrad_rows"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("tdt,sdt", [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)], ids=["f32", "bf16_table", "bf16_state"])
def test_ftrl_rows_bitwise_and_captured(cuda, tdt, sdt):
    """FTRL's row update against its plain version at the design's edges:
    E 1, 11, 16, 18, 128, and 128 on rows that start off 4 elements (one
    column a lane); counts 0, 31, 32, 33, 64, 65, 224 (inside a run over
    220-230) and K; a bfloat16 or float32 lr; a negative id and the
    sentinels. Bitwise in every case (the arithmetic is torch's op by op),
    two runs bitwise, a replay of the captured launch bitwise the eager
    one."""
    from hugectr_tpu_torch.core.types import Optimizer_t
    from hugectr_tpu_torch.ops import row_scatter as rs
    from hugectr_tpu_torch.optim.params import OptParams

    rng = np.random.default_rng(22)
    opt = OptParams(optimizer=Optimizer_t.FTRL, lambda1=0.01, lambda2=0.01, ftrl_beta=0.5)
    k, rows = 1000, 3000
    sidx = torch.from_numpy(_row_update_edges(rng, k, rows, 100)).to(cuda)
    for i, (e, shift) in enumerate(((1, 0), (11, 0), (16, 0), (18, 0), (128, 0), (128, 1))):
        w0, z0 = (torch.from_numpy(rng.normal(size=(rows, e)).astype(np.float32) * 0.02).to(cuda) for _ in "wz")
        n0 = torch.from_numpy(rng.random((rows, e), dtype=np.float32) * 0.1).to(cuda)
        g = torch.from_numpy(rng.normal(size=(k, e)).astype(np.float32) * 0.05).to(cuda)
        lr = torch.tensor(0.05, device=cuda).to(tdt if i % 2 else torch.float32)

        def copy():  # the table's copy `shift` elements past an aligned start
            t = torch.empty(rows * e + shift, device=cuda, dtype=tdt)[shift:].view(rows, e)
            return t.copy_(w0), z0.to(sdt, copy=True), n0.to(sdt, copy=True)

        for n in (0, 31, 32, 33, 64, 65, 224, k):
            count = torch.tensor(n, device=cuda)
            got, again, want = copy(), copy(), copy()
            rs.ftrl_rows(opt, *got, sidx, g, count, lr)
            rs.ftrl_rows(opt, *again, sidx, g, count, lr)
            rs.ftrl_rows_plain(opt, *want, sidx, g, count, lr)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (e, shift, n)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), (e, shift, n)
            assert (n == 0) == torch.equal(got[0], copy()[0]), (e, shift, n)
        replayed = copy()
        before = rs.LAUNCHES["ftrl_rows"]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            rs.ftrl_rows(opt, *replayed, sidx, g, count, lr)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(replayed, got)), (e, shift)
        assert rs.LAUNCHES["ftrl_rows"] == before + 1


def _ftrl_state(model):
    out = {f"t/{k}": v.clone() for k, v in model.tables.items()}
    out.update({f"s/{g}/{k}": v.clone() for g, st in model.eopt.items() for k, v in st.items()})
    out.update({f"p/{lay}/{k}": p.detach().clone() for lay, ps in model.network.param_tree().items()
                for k, p in ps.items()})
    out.update({f"d/{s}/{lay}/{k}": t.clone() for s, tree in model.dopt.items() for lay, ps in tree.items()
                for k, t in ps.items()})
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_tiny_ftrl_captured_steps_and_eval_equal_the_eager_ones(cuda, dynamic):
    """The tiny DLRM-FTRL from one seed, eager and captured, 4 steps: the
    losses within rtol 1e-4, key stores bitwise, every other array within
    rtol 1e-4 / atol 1e-5 (the dense sweep's and the one-hot backward's
    atomic adds sum in no fixed order), the weights whose z lies within
    1e-6 of lambda1 left out (at most 1%); then the eval forward of the same
    weights bitwise the eager one."""
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools.flagship import build_tiny_dlrm_ftrl

    eager, graph = (build_tiny_dlrm_ftrl(ResourceManager.create(device="cuda"), dynamic=dynamic,
                                         use_cuda_graph=g) for g in (False, True))
    assert eager.step_mode == "eager: use_cuda_graph=False" and graph.step_mode == "graph"
    se, sg = _ftrl_state(eager), _ftrl_state(graph)
    assert all(torch.equal(se[k], sg[k]) for k in se)
    le = [float(eager.train_async()) for _ in range(4)]
    ops.reset_counts()
    lg = [float(graph.train_async()) for _ in range(4)]
    assert "train" in graph._graphs
    if not dynamic:
        assert ops.launch_counts()["ftrl_rows"] == 4 * list(graph.ec.group_routes.values()).count("sorted") > 0
    np.testing.assert_allclose(lg, le, rtol=1e-4)
    se, sg = _ftrl_state(eager), _ftrl_state(graph)
    lambda1 = eager.opt_params.lambda1
    for k in se:
        if k.endswith("#keys"):
            assert torch.equal(sg[k], se[k]), k
            continue
        # a weight's z: its table's state, or its parameter's dense state
        z = se.get(f"s/{k[2:]}/z") if k.startswith("t/") else se.get(f"d/z/{k[2:]}")
        near = (z.float().abs() - lambda1).abs() <= 1e-6 if z is not None else torch.zeros_like(se[k], dtype=bool)
        assert int(near.sum()) <= max(2, near.numel() // 100), k
        got, want = torch.where(near, 0, sg[k].float()), torch.where(near, 0, se[k].float())
        np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=1e-4, atol=1e-5, err_msg=k)
    for m in (eager, graph):  # the same weights for both evals
        for name, t in m.tables.items():
            t.copy_(se[f"t/{name}"])
        for lay, ps in m.network.param_tree().items():
            for n, p in ps.items():
                p.data.copy_(se[f"p/{lay}/{n}"])
    ve, vg = eager.eval(), graph.eval()
    assert "eval" in graph._graphs
    assert torch.equal(graph.metrics._preds, eager.metrics._preds) and ve == vg


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onehot_fwd_group_key_windows(cuda, dtype):
    """Windowed lookups (tiers of a split table) beside unwindowed ones in
    one launch: keys lo - 1, lo, hi - 1, hi, past the table and below -1
    are dropped by a tier and wrapped by an unsplit lookup; int32 and int64
    keys; the bench plan's 20-lookup group at batch 16,384 (seven superhot
    tiers on the gather route, table 24 on the counts matmul)."""
    from hugectr_tpu_torch.tools.flagship import BENCH_PLAN, onehot_group_inputs

    rng = np.random.default_rng(21)
    b = 3000
    spec = [(1024, 100, False, 0, 1024), (108, 40, True, 0, -1), (1024, 7, True, 0, 1024),
            (130048, 3, False, 1024, 131072), (57, 16, True, 0, -1), (3, 1, False, 0, -1)]
    for int64 in (False, True):
        cols, lookups, row = [], [], 0
        for i, (v, h, mean, lo, hi) in enumerate(spec):
            top = 3 * hi if hi >= 0 else 3 * v
            k = rng.integers(-5 * v, top, size=(b, h)).astype(np.int64)
            k[rng.random((b, h)) < 0.1] = -1
            edges = [lo - 1, lo, (hi if hi >= 0 else v) - 1, hi if hi >= 0 else v, -2, 2**31 - 1]
            k[1 : 1 + len(edges), 0] = edges
            if int64:
                k[-5:, 0] = [2**31 + 5, 2**32 - 1, 2**32 + lo, -(2**33), 2**40 + 3]
            k[0] = -1
            cols.append(k)
            lookups.append(oh.GroupLookup(row, v, i * 128, mean, lo, hi))
            row += v
        allk = torch.from_numpy(np.concatenate(cols, axis=1).astype(np.int64 if int64 else np.int32)).to(cuda)
        keys, c = [], 0
        for _v, h, *_ in spec:
            keys.append(allk[:, c : c + h])
            c += h
        table = torch.from_numpy(rng.normal(size=(row, 128)).astype(np.float32)).to(cuda, dtype)
        _check_group(keys, lookups, table, len(spec) * 128)
    keys, lookups, table, width = onehot_group_inputs(np.random.default_rng(3), 16384, 128, dtype, cuda,
                                                      **BENCH_PLAN)
    assert len(lookups) == 20 and sum(lk.windowed for lk in lookups) == 7
    assert [oh.fwd_route(lk.vocab, k.shape[1], 128, cuda) for k, lk in zip(keys, lookups)].count("mma") == 1
    _check_group(keys, lookups, table, width)


@pytest.mark.gpu
@pytest.mark.parametrize("h", [100, 3])
def test_onehot_bwd_superhot_power_law(cuda, h):
    """The superhot tier's backward: V 1,024, power-law keys of a 2M-row
    table through the window [0, 1024) (about 57% valid, 4% on row 0), bf16
    d and float32 sums, as the step gives it: h 100 on the counts matmul,
    two calls bitwise equal; h 3 (48 keys a row) on the global atomics,
    which the card measured faster there."""
    from hugectr_tpu_torch.data.generator import power_law_keys

    rng = np.random.default_rng(22)
    raw = torch.from_numpy(power_law_keys(rng, 2_000_000, (16384, h), 1.05).astype(np.int32)).to(cuda)
    ok, local = oh.place_keys(oh.window_keys(raw, 0, 1024), 1024)
    keys = torch.where(ok, local, -1).to(torch.int32)
    route = oh.bwd_route(16384, h, 1024, 128, cuda)
    assert route == ("mma" if h == 100 else "global")
    d = torch.from_numpy(rng.normal(size=(16384, 128)).astype(np.float32)).to(cuda, torch.bfloat16)
    _check_bwd(keys, d, 1024, torch.float32)
    g, c = oh.onehot_matmul_bwd(keys, d, 1024, torch.float32)
    assert float(c.sum()) == float(ok.sum())
    g2, c2 = oh.onehot_matmul_bwd(keys, d, 1024, torch.float32, route="mma")
    g3, c3 = oh.onehot_matmul_bwd(keys, d, 1024, torch.float32, route="mma")
    assert torch.equal(g2.view(torch.int32), g3.view(torch.int32)) and torch.equal(c2, c3) and torch.equal(c, c2)


@pytest.mark.gpu
def test_segscan_bf16_rows_float32_sums(cuda):
    """bf16 rows summed into float32 outputs (the sorted update of bf16
    tables), within the float32 tolerance; f32 rows into bf16 sums refused."""
    rng = np.random.default_rng(23)
    t = ss.tile_rows()
    for k, nseg in ((229_001, 60_000), (t + 1, 3), (17, 17)):
        heads = torch.from_numpy(_heads(rng, k, nseg)).to(cuda)
        vals = torch.from_numpy(rng.normal(size=(k, 128)).astype(np.float32)).to(cuda, torch.bfloat16)
        got = ss.segmented_sum_sorted(vals, heads, torch.float32)
        assert got.dtype == torch.float32
        scale = ss.segmented_sum_sorted_plain(vals.float().abs(), heads)
        assert _scaled(got, ss.segmented_sum_sorted_plain(vals, heads, torch.float32), scale) <= 1e-4
        assert torch.equal(ss.segmented_sum_sorted(vals, heads, torch.float32), got)
    with pytest.raises(ValueError):
        ss.segmented_sum_sorted(vals.float(), heads, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e", [16, 128, 13])
def test_ordered_pool_kernel_is_bitwise_its_plain_version(cuda, dtype, e):
    """Slots of 0 to 100 rows, the rows of a slot in ascending order,
    repeated rows, keys of other shards (the sentinel row 2000); E 13 takes
    the kernel's one-element accesses."""
    rng = np.random.default_rng(e)
    n_slots = 5000
    lens = rng.integers(0, 12, size=n_slots)
    lens[:3] = (100, 0, 1)
    slots = torch.from_numpy(np.repeat(np.arange(n_slots), lens))
    rows = torch.from_numpy(np.minimum(rng.integers(0, 2200, size=slots.numel()), 2000))
    table = torch.from_numpy(rng.normal(size=(2000, e)).astype(np.float32)).to(dtype)
    srows, offsets = op.segments(rows, slots, n_slots, 2000)
    want = op.ordered_pool_plain(table, srows, offsets)
    ops.reset_counts()
    got = op.ordered_pool(table.to(cuda), srows.to(cuda), offsets.to(cuda))
    torch.cuda.synchronize()
    assert ops.launch_counts()["ordered_pool"] == 1
    assert torch.equal(got.cpu().view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [129, 256])
def test_ordered_pool_reads_a_packed_view(cuda, stride):
    """The first 128 columns of [R, 129] (rowwise pack) and [R, 256]
    (AdaGrad pack) bf16 rows, read through the row stride: bitwise the
    plain version on the same view and the kernel on a contiguous copy."""
    rng = np.random.default_rng(stride)
    n_slots = 4000
    lens = rng.integers(0, 30, size=n_slots)
    slots = torch.from_numpy(np.repeat(np.arange(n_slots), lens))
    rows = torch.from_numpy(np.minimum(rng.integers(0, 1100, size=slots.numel()), 1000))
    full = torch.from_numpy(rng.normal(size=(1000, stride)).astype(np.float32)).to(torch.bfloat16)
    srows, offsets = op.segments(rows, slots, n_slots, 1000)
    view = full[:, :128]
    want = op.ordered_pool_plain(view, srows, offsets)
    got = op.ordered_pool(full.to(cuda)[:, :128], srows.to(cuda), offsets.to(cuda))
    dense = op.ordered_pool(view.contiguous().to(cuda), srows.to(cuda), offsets.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
    assert torch.equal(got.view(torch.int16), dense.view(torch.int16))


def _pool_edge_case(rng, dtype, e, stride, slots, rows=70):
    """The kernel's design edges (as tests/test_torch_ordered_pool.py's
    `edge_case`): long slots (31, 32, 33, 64, 65, 0 and 1 rows, then slots
    of 40 ids whose first foreign id stands at 0, 31, 32 and 33) or short
    ones (0, 1, 2, 3, 7, 8, 9 and 17 rows, then slots of 9 ids, the first
    foreign id at 0, 1, 7 and 8); a [rows, stride] table whose first e
    columns are pooled."""
    lens, foreign_at, n_ids = {"long": ((31, 32, 33, 64, 65, 0, 1), (0, 31, 32, 33), 40),
                               "short": ((0, 1, 2, 3, 7, 8, 9, 17), (0, 1, 7, 8), 9)}[slots]
    ids = [np.sort(rng.integers(0, rows, size=n)) for n in lens]
    for at in foreign_at:
        r = np.sort(rng.integers(0, rows, size=n_ids))
        r[at:] = rows + np.arange(n_ids - at) % 3
        ids.append(r)
    offsets = np.concatenate([[0], np.cumsum([len(x) for x in ids])])
    table = (rng.normal(size=(rows, stride)) * np.exp2(rng.integers(-8, 4, size=(rows, 1)))).astype(np.float32)
    return torch.from_numpy(table).to(dtype), torch.from_numpy(np.concatenate(ids)), torch.from_numpy(offsets)


@pytest.mark.gpu
@pytest.mark.parametrize("slots", ["long", "short"])
@pytest.mark.parametrize("dtype, stride, e", [
    *((dt, stride, e) for dt in (torch.float32, torch.bfloat16) for stride in (128, 129, 130, 132)
      for e in (13, 16, 64, 128)),
    (torch.float32, 256, 256), (torch.float32, 260, 256), (torch.bfloat16, 512, 512), (torch.bfloat16, 516, 512)])
def test_ordered_pool_edges_are_bitwise_its_plain_version(cuda, dtype, stride, e, slots):
    """Slots across the id batches of 8, 16 and 32 lanes, the first foreign
    id at 0, 1, 7, 8, 31, 32 and 33, every row stride's access width, at
    the plan's choice: one access a lane for long slots, several for short
    ones where the accesses are aligned 16-byte ones; E 256 f32 and 512
    bf16 take two walks; weighted at E 128. One launch a call."""
    rng = np.random.default_rng(stride * 1000 + e)
    full, rows, offsets = _pool_edge_case(rng, dtype, e, stride, slots)
    w = torch.from_numpy((rng.random(rows.numel()) * 3).astype(np.float32)) if e == 128 else None
    view = full[:, :e]
    want = op.ordered_pool_plain(view, rows, offsets, w)
    dview, drows, doffs = full.to(cuda)[:, :e], rows.to(cuda), offsets.to(cuda)
    dw = w.to(cuda) if w is not None else None
    as_int = torch.int16 if dtype == torch.bfloat16 else torch.int32
    ops.reset_counts()
    got = op.ordered_pool(dview, drows, doffs, dw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ordered_pool"] == 1
    assert torch.equal(got.cpu().view(as_int), want.view(as_int)), op.pool_plan(
        e, full.element_size(), stride, dview.data_ptr(), got.data_ptr(), rows.numel() / (offsets.numel() - 1))


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_tiny_hybrid_model_matches_one_card(cuda, backend):
    """The tiny DLRM-DCNv2 (sorted route on) at W = 2 against one card from
    one carried state, 3 steps and an eval (`tools/hybrid.py::parity_runs`):
    NCCL with a card per rank, or gloo with both ranks on one card (every
    collective staged through the host). Losses rtol 1e-4, tables and dense
    parameters rtol 1e-4 / atol 1e-5, AUC within 1e-4, replicas bitwise
    equal across the ranks, every kernel launched on each rank."""
    from hugectr_tpu_torch.tools import hybrid

    if backend == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip(f"NCCL over 2 ranks needs 2 cards; this machine has {torch.cuda.device_count()}")
    one, ranks = hybrid.parity_runs(2, backend)
    rep = hybrid.parity_report(one, ranks)
    assert rep["loss_rel_diff"] <= 1e-4 and rep["worst_excess"] <= 0 and rep["auc_diff"] <= 1e-4, rep
    assert rep["replicas_equal"]
    assert ranks[0]["routes"] == {"mp_ev16": "sorted", "onehot_ev16": "onehot"}
    for r in ranks:
        assert min(r["launches"].values()) > 0, r["launches"]


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_collection_replicas_bitwise_on_two_ranks(cuda, backend):
    """The collection of `tests/torch_rank_fns.py` (one-hot, model-parallel
    sorted and dense sweep, data-parallel rowop) at W = 2 on the card, a
    global batch of 4,096 so that `index_add_`'s atomics meet on every
    row of the data-parallel table: the replicated groups' storage and
    state hold the same bits on both ranks after 2 updates, and the tables
    agree with one card (rtol 1e-4 / atol 1e-5)."""
    import torch_rank_fns as fns
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools import hybrid

    if backend == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip(f"NCCL over 2 ranks needs 2 cards; this machine has {torch.cuda.device_count()}")
    inputs = fns.ec_inputs("rowwise_adagrad", 4096, 2, 0.3)
    one = fns.collection_steps(ResourceManager.create(), inputs)
    ranks = hybrid.run(fns.collection_steps, 2, inputs, backend=backend)
    for g in ("onehot_ev8", "dp_ev8"):
        np.testing.assert_array_equal(ranks[1]["storage"][g], ranks[0]["storage"][g], err_msg=g)
        for k, v in ranks[0]["state"][g].items():
            np.testing.assert_array_equal(ranks[1]["state"][g][k], v, err_msg=f"{g}/{k}")
    for res in ranks:
        for t, want in one["tables"].items():
            np.testing.assert_allclose(res["tables"][t], want, rtol=1e-4, atol=1e-5, err_msg=t)


@pytest.mark.gpu
def test_partial_placement_replicas_bitwise_on_four_ranks(cuda):
    """The partial placement of `tests/torch_rank_fns.py` (t0 on 2 shards,
    each on 2 ranks, on the dense sweep; t1 on 1 shard, on all 4 ranks, on
    the sorted route) on 4 gloo ranks sharing the card, 3 steps of a global
    batch of 4,096, so that `index_add_`'s atomics meet on every row: every
    replica of a shard holds the same bits as the others (the lowest
    replica's update is broadcast), and the tables agree with one card
    (rtol 1e-4 / atol 1e-5)."""
    import torch_rank_fns as fns
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools import hybrid

    inputs = fns.ec_inputs("rowwise_adagrad", 4096, 3, 0.3, case="partial")
    one = fns.collection_steps(ResourceManager.create(), inputs)
    ranks = hybrid.run(fns.collection_steps, 4, inputs, backend="gloo")
    assert ranks[0]["routes"] == {"mp_ev8_x2": "dense", "mp_ev8_x1": "sorted"}
    for g, f in (("mp_ev8_x2", 2), ("mp_ev8_x1", 1)):
        for r in range(f, 4):
            np.testing.assert_array_equal(ranks[r]["storage"][g], ranks[r % f]["storage"][g], err_msg=f"{g} {r}")
            for k, v in ranks[r % f]["state"][g].items():
                np.testing.assert_array_equal(ranks[r]["state"][g][k], v, err_msg=f"{g}/{k} {r}")
    for res in ranks:
        for t, want in one["tables"].items():
            np.testing.assert_allclose(res["tables"][t], want, rtol=1e-4, atol=1e-5, err_msg=t)


@pytest.mark.gpu
def test_device_feeder_stages_through_pinned_memory(cuda):
    """The feeder on the card: each batch goes through a pinned staging
    buffer and a copy on the uploader's stream; the consumer's stream waits
    on the copy's event. 24 batches through a ring of 3 staging sets, each
    consumed with device work on the default stream, arrive in order and
    bitwise (a staging buffer reused before its copy ended, or a batch read
    before its copy, would show)."""
    from hugectr_tpu_torch.data.reader import DeviceFeeder, Uploader

    rng = np.random.default_rng(0)
    host = [{"rows": rng.integers(-2**31, 2**31 - 1, size=(4096, 267), dtype=np.int32)} for _ in range(24)]
    up = Uploader(cuda, slots=3)
    feeder = DeviceFeeder(host, up, depth=3)
    for i, b in enumerate(feeder):
        assert b["rows"].device.type == "cuda" and b.event is None
        torch.cuda._sleep(1_000_000)  # keep the consumer's stream busy while copies go on
        np.testing.assert_array_equal(b["rows"].cpu().numpy(), host[i]["rows"], err_msg=f"batch {i}")
    feeder.stop()
    assert up.batches == 24 and up.bytes == 24 * 4096 * 267 * 4
    assert all(buf.is_pinned() for slot in up._slots for buf in slot.bufs.values())


def _check_bwd_group(keys, lookups, d, rows, e, weights=None, route=None, bitwise=False):
    """The grouped backward (one launch per 48 lookups) against its plain
    version: the gradient within 1e-4 of the float32 sums' scale, the
    counts exact (weighted: touched rows exact, counts within 1e-4), two
    calls bitwise equal where `bitwise`."""
    n = len(lookups)
    ops.reset_counts()
    if route is None:
        g, c = oh.onehot_bwd_chunked(keys, lookups, d, rows, e, weights)
    else:
        g, c = oh.onehot_bwd_group(keys, lookups, d, rows, e, weights, route=route)
    assert ops.launch_counts()["onehot_bwd"] == (-(-n // oh.MAX_GROUP_LOOKUPS) if route is None else 1)
    wg, wc = oh.onehot_bwd_group_plain(keys, lookups, d, rows, e, weights)
    absw = None if weights is None else [None if w is None else w.abs() for w in weights]
    sg, _ = oh.onehot_bwd_group_plain(keys, lookups, d.float().abs(), rows, e, absw)
    assert g.dtype == c.dtype == torch.float32 and tuple(g.shape) == (rows, e)
    assert _scaled(g, wg, sg) <= 1e-4
    if weights is None:
        assert torch.equal(c, wc)
    else:
        assert torch.equal(c > 0, wc > 0) and float(((c - wc).abs() / wc.clamp(min=1e-30)).max()) <= 1e-4
    if bitwise:
        g2, c2 = oh.onehot_bwd_group(keys, lookups, d, rows, e, weights, route=route)
        assert torch.equal(g.view(torch.int32), g2.view(torch.int32)) and torch.equal(c, c2)


@pytest.mark.gpu
@pytest.mark.parametrize("plan", ["bench", "f32", "ftrl"])
def test_onehot_bwd_group_at_the_main_paths_groups(cuda, plan):
    """One launch for each main path's one-hot group: bench.py's 20 lookups
    (13 tables and 7 windowed superhot tiers of power-law keys, bf16 d),
    the f32 flagship's 13 tables (f32 d), DLRM-FTRL's 13 tables of hotness
    1 (f32 d); keys as column views of one tensor, d read through its row
    stride. Then every lookup forced onto the counts matmul, bitwise over
    two calls."""
    from hugectr_tpu_torch.tools.flagship import BENCH_PLAN, ftrl_plan, onehot_group_inputs

    dt = torch.bfloat16 if plan == "bench" else torch.float32
    kw = dict(BENCH_PLAN) if plan == "bench" else dict(plan=ftrl_plan(ev_size=128)) if plan == "ftrl" else {}
    rng = np.random.default_rng(3)
    keys, lookups, table, width = onehot_group_inputs(rng, 16384, 128, dt, cuda, **kw)
    assert len(lookups) == (20 if plan == "bench" else 13)
    d = torch.from_numpy(rng.normal(size=(16384, width + 8)).astype(np.float32)).to(cuda, dt)[:, 8:]
    _check_bwd_group(keys, lookups, d, table.shape[0], 128)
    _check_bwd_group(keys, lookups, d, table.shape[0], 128, route="mma", bitwise=True)


@pytest.mark.gpu
def test_onehot_bwd_group_weighted_table24_and_chunks(cuda):
    """The weighted superhot tier (V 1,024 of a 2M-row table's keys through
    the window, h 20, weights in [0, 1)), V 108 h 40 (table 24's shape),
    and a 100-lookup group with every seventh lookup Mean and every fifth
    weighted (3 launches)."""
    from hugectr_tpu_torch.data.generator import power_law_keys

    rng = np.random.default_rng(4)
    raw = torch.from_numpy(power_law_keys(rng, 2_000_000, (16384, 20), 1.05).astype(np.int32)).to(cuda)
    w = torch.from_numpy(rng.random((16384, 20), dtype=np.float32)).to(cuda)
    d = torch.from_numpy(rng.normal(size=(16384, 128)).astype(np.float32)).to(cuda)
    tier = [oh.GroupLookup(0, 1024, 0, False, 0, 1024)]
    _check_bwd_group([raw], tier, d, 1024, 128, [w])
    _check_bwd_group([raw], tier, d.to(torch.bfloat16), 1024, 128, [w])
    k108 = torch.from_numpy(power_law_keys(rng, 108, (16384, 40), 1.05).astype(np.int32)).to(cuda)
    assert oh.bwd_route(16384, 40, 108, 128, cuda) == "mma"
    _check_bwd_group([k108], [oh.GroupLookup(0, 108, 0, False)], d, 108, 128, bitwise=True)
    _check_bwd_group([k108], [oh.GroupLookup(0, 108, 0, True)], d.to(torch.bfloat16), 108, 128, bitwise=True)
    n, v = 100, 1000
    allk = torch.from_numpy(power_law_keys(rng, v, (2048, n), 1.05).astype(np.int32)).to(cuda)
    keys = [allk[:, i : i + 1] for i in range(n)]
    lookups = [oh.GroupLookup(v * i, v, 128 * i, i % 7 == 0) for i in range(n)]
    ws = [torch.from_numpy(rng.random((2048, 1), dtype=np.float32)).to(cuda) if i % 5 == 0 else None
          for i in range(n)]
    dd = torch.from_numpy(rng.normal(size=(2048, 128 * n)).astype(np.float32)).to(cuda)
    _check_bwd_group(keys, lookups, dd, v * n, 128)
    _check_bwd_group(keys, lookups, dd, v * n, 128, ws)


@pytest.mark.gpu
@pytest.mark.parametrize("b,v,h", [(16384, 108, 40), (4096, 1024, 20)])
def test_weighted_onehot_bwd_in_sample_cancel_leaves_row_untouched(cuda, b, v, h):
    """The weighted backward's touch count is sum_b |sum_h w| (the JAX
    package's): one sample holds row 7 twice with weights +0.75 and -0.75
    and no other sample holds it, so its count is exactly 0 on the
    privatised route (V 108, h 40) and on the global atomics (V 1,024,
    h 20); every other count as the plain version's, the gradient within
    the float32 tolerance."""
    rng = np.random.default_rng(b + v)
    keys = torch.from_numpy(_keys(rng, b, h, v)).to(cuda)
    w = torch.from_numpy(rng.standard_normal((b, h), dtype=np.float32)).to(cuda)
    keys[keys == 7] = 8
    keys[0, :2] = 7
    w[0, :2] = torch.tensor([0.75, -0.75], device=cuda)
    d = torch.from_numpy(rng.standard_normal((b, 128), dtype=np.float32)).to(cuda)
    g, c = oh.onehot_matmul_bwd(keys, d, v, torch.float32, weights=w)
    wg, wc = oh.onehot_matmul_bwd_plain(keys, d, v, torch.float32, weights=w)
    sg, _ = oh.onehot_matmul_bwd_plain(keys, d.abs(), v, torch.float32, weights=w.abs())
    assert float(c[7]) == 0.0 == float(wc[7]) and float(g[7].abs().sum()) == 0.0
    assert torch.equal(c > 0, wc > 0)
    assert float(((c - wc).abs() / wc.clamp(min=1e-30)).max()) <= 1e-4
    assert _scaled(g, wg, sg) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("tdt,sdt", [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)], ids=["f32", "bf16_table", "bf16_state"])
def test_adam_rows_bitwise_and_captured(cuda, tdt, sdt):
    """Adam's row update against its plain version at the design's edges:
    E 1, 11, 16, 18, 128, and 128 on rows that start off 4 elements (one
    column a lane); counts 0, 31, 32, 33, 64, 65, 224 (inside a run over
    220-230) and K; a bfloat16 or float32 lr; a negative id and the
    sentinels; every fifth entry's summed gradient 0 (a live tail still
    decays its moments). Bitwise in every case (the arithmetic is torch's
    op by op), two runs bitwise; a captured launch replayed after the bias
    corrections' scalars were filled for another step bitwise the eager
    launch at that step."""
    from hugectr_tpu_torch.core.types import Optimizer_t
    from hugectr_tpu_torch.ops import row_scatter as rs
    from hugectr_tpu_torch.optim.params import OptParams, StepScalars

    rng = np.random.default_rng(23)
    opt = OptParams(optimizer=Optimizer_t.Adam, beta1=0.9, beta2=0.999, epsilon=1e-7)
    k, rows = 1000, 3000
    sidx = torch.from_numpy(_row_update_edges(rng, k, rows, 100)).to(cuda)
    scalars = StepScalars(cuda)
    for i, (e, shift) in enumerate(((1, 0), (11, 0), (16, 0), (18, 0), (128, 0), (128, 1))):
        w0, m0 = (torch.from_numpy(rng.normal(size=(rows, e)).astype(np.float32) * s).to(cuda) for s in (0.05, 0.01))
        v0 = torch.from_numpy(rng.random((rows, e), dtype=np.float32) * 1e-3).to(cuda)
        g = torch.from_numpy(rng.normal(size=(k, e)).astype(np.float32) * 0.05).to(cuda)
        g[::5] = 0.0
        lr = torch.tensor(0.01, device=cuda).to(tdt if i % 2 else torch.float32)
        scalars.fill(2)
        bc = scalars.corrections(opt)

        def copy():  # the table's copy `shift` elements past an aligned start
            t = torch.empty(rows * e + shift, device=cuda, dtype=tdt)[shift:].view(rows, e)
            return t.copy_(w0), m0.to(sdt, copy=True), v0.to(sdt, copy=True)

        for n in (0, 31, 32, 33, 64, 65, 224, k):
            count = torch.tensor(n, device=cuda)
            got, again, want = copy(), copy(), copy()
            rs.adam_rows(opt, *got, sidx, g, count, lr, *bc)
            rs.adam_rows(opt, *again, sidx, g, count, lr, *bc)
            rs.adam_rows_plain(opt, *want, sidx, g, count, lr, *bc)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (e, shift, n)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), (e, shift, n)
            assert (n == 0) == torch.equal(got[1], copy()[1]), (e, shift, n)
        replayed, at3 = copy(), copy()
        before = rs.LAUNCHES["adam_rows"]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            rs.adam_rows(opt, *replayed, sidx, g, count, lr, *bc)
        scalars.fill(3)
        rs.adam_rows(opt, *at3, sidx, g, count, lr, *bc)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(replayed, at3)), (e, shift)
        assert not torch.equal(replayed[0], got[0]), (e, shift)  # step 3's corrections, not step 2's
        assert rs.LAUNCHES["adam_rows"] == before + 2


@pytest.mark.gpu
def test_dropout_mask_kernel_and_consecutive_replays(cuda):
    """Dropout's mask kernel bitwise its plain version (WDL's [2,048, 1,024]
    layer, keep 0.5; a rank's block); then a captured draw replayed at two
    consecutive steps gives two different masks, each the eager draw at
    its step."""
    from hugectr_tpu_torch.ops import dropout as dr

    key, n = dr.key_of(987654321987), 2048 * 1024
    step = torch.tensor(11, device=cuda)
    got = dr.dropout_mask(key, step, n, 0, 0.5)
    assert torch.equal(got, dr.dropout_mask_plain(key, step, n, 0, 0.5))
    assert torch.equal(dr.dropout_mask(key, step, n // 2, n // 2, 0.5), got[n // 2:])
    out = torch.empty(n, dtype=torch.bool, device=cuda)
    before = dr.LAUNCHES["dropout_mask"]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(dr.dropout_mask(key, step, n, 0, 0.5))
    replays = []
    for s in (12, 13):
        step.fill_(s)
        graph.replay()
        replays.append(out.clone())
        assert torch.equal(out, dr.dropout_mask(key, step, n, 0, 0.5)), s
    assert not torch.equal(replays[0], replays[1])
    assert dr.LAUNCHES["dropout_mask"] == before + 3  # the capture and the two eager draws


@pytest.mark.gpu
@pytest.mark.parametrize("name,variant", [("wdl", None), ("mmoe", "mmoe")])
def test_tiny_sample_captured_steps_and_eval_equal_the_eager_ones(cuda, name, variant):
    """A tiny sample (WDL at Dropout 0.5: Adam, two Dropout layers; MMoE
    at a one-hot vocabulary of 64: SGD's scatter) from one seed, eager and
    captured, 4 steps: the losses within rtol 1e-4 and every array within
    rtol 1e-4 / atol 1e-5 (atomic sums); the masks and bias corrections
    follow the step in both, so the steps agree; then the eval forward of
    the same weights bitwise the eager one."""
    from hugectr_tpu_torch.core.mesh import ResourceManager
    from hugectr_tpu_torch.tools.samples import build_tiny_sample

    kw = dict(dropout_rate=0.5) if name == "wdl" else dict(onehot_vocab=64)
    eager, graph = (build_tiny_sample(name, ResourceManager.create(device="cuda"), variant=variant,
                                      use_cuda_graph=g, **kw) for g in (False, True))
    assert eager.step_mode == "eager: use_cuda_graph=False" and graph.step_mode == "graph"
    se, sg = _ftrl_state(eager), _ftrl_state(graph)
    assert all(torch.equal(se[k], sg[k]) for k in se)
    le = [float(eager.train_async()) for _ in range(4)]
    ops.reset_counts()
    lg = [float(graph.train_async()) for _ in range(4)]
    assert "train" in graph._graphs
    counts = ops.launch_counts()
    if name == "wdl":
        assert counts["dropout_mask"] == 4 * 2
    else:
        assert counts["row_scatter"] >= 4 * list(graph.ec.group_routes.values()).count("scatter") > 0
    np.testing.assert_allclose(lg, le, rtol=1e-4)
    se, sg = _ftrl_state(eager), _ftrl_state(graph)
    for k in se:
        np.testing.assert_allclose(sg[k].float().cpu(), se[k].float().cpu(), rtol=1e-4, atol=1e-5, err_msg=k)
    for m in (eager, graph):  # the same weights for both evals
        for n, t in m.tables.items():
            t.copy_(se[f"t/{n}"])
        for lay, ps in m.network.param_tree().items():
            for n, p in ps.items():
                p.data.copy_(se[f"p/{lay}/{n}"])
    ve, vg = eager.eval(), graph.eval()
    assert "eval" in graph._graphs
    assert torch.equal(graph.metrics._preds, eager.metrics._preds) and ve == vg
