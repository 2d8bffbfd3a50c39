"""The port's CUDA kernels against their plain PyTorch versions on the card.

Runs only where there is a card; elsewhere each test skips. The card's
machine has no JAX, so run this file without the suite's conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q -p no:randomly

Tolerance: |kernel - plain| / (sum of |inputs| into the element) <= 1e-4 in
float32 (sums in another order, with atomics in the backward) and 1e-2 in
bfloat16 (one more rounding of the output). Touch counts are exact, and the
segmented scan is bitwise the same from run to run. The last tests run
the embedding collection and train the tiny model on 2 spawned ranks
against one card.
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
    """The superhot tier's backward: V 1,024 (the global-atomic route),
    power-law keys of a 2M-row table through the window [0, 1024) (about
    57% valid, 4% on row 0), bf16 d and float32 sums, as the step gives it."""
    from hugectr_tpu_torch.data.generator import power_law_keys

    rng = np.random.default_rng(22)
    raw = torch.from_numpy(power_law_keys(rng, 2_000_000, (16384, h), 1.05).astype(np.int32)).to(cuda)
    ok, local = oh.place_keys(oh.window_keys(raw, 0, 1024), 1024)
    keys = torch.where(ok, local, -1).to(torch.int32)
    assert oh.bwd_route(16384, h, 1024, 128, cuda) == "global"
    d = torch.from_numpy(rng.normal(size=(16384, 128)).astype(np.float32)).to(cuda, torch.bfloat16)
    _check_bwd(keys, d, 1024, torch.float32)
    g, c = oh.onehot_matmul_bwd(keys, d, 1024, torch.float32)
    assert float(c.sum()) == float(ok.sum())


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
