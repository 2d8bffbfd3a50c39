"""The ordered pool's plain version (`ops/ordered_pool.py`, the arithmetic
of csrc/ordered_pool.cu) against a numpy loop of bf16 adds and against the
JAX package's bf16 scatter-add in the order of its updates: bitwise, in
float32 and bfloat16, E 16 and 128, slots of 0 to 100 rows, keys of other
shards on the sentinel row. The kernel
itself is held against the plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py's hybrid_exchange_parity)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from hugectr_tpu_torch import ops
from hugectr_tpu_torch.ops import ordered_pool as op


def _pairs(rng, rows, n_slots, e, dtype):
    """A table, and row-sorted (row, slot) pairs with slots of 0 to 100
    rows (one slot of 100, one empty, repeated rows), a tenth of them on
    the sentinel row `rows` (keys of another shard)."""
    lens = rng.integers(0, 12, size=n_slots)
    lens[0], lens[1] = 100, 0
    slots = np.repeat(np.arange(n_slots), lens)
    r = np.minimum(rng.integers(0, rows + rows // 10, size=slots.size), rows)
    order = np.argsort(r, kind="stable")
    table = (rng.normal(size=(rows, e)) * np.exp2(rng.integers(-8, 4, size=(rows, 1)))).astype(np.float32)
    t = torch.from_numpy(table).to(dtype)
    return t, torch.from_numpy(r[order]), torch.from_numpy(slots[order])


def _numpy_loop(table, rows, slots, n_slots):
    """Each pair in list order: out[slot] = out[slot] + table[row], rounded
    to the table's type (ml_dtypes' bfloat16 adds in float32 and rounds);
    the sentinel row adds nothing."""
    npdt = ml_dtypes.bfloat16 if table.dtype == torch.bfloat16 else np.float32
    t = table.float().numpy().astype(npdt)
    out = np.zeros((n_slots, t.shape[1]), npdt)
    for r, s in zip(rows.numpy(), slots.numpy()):
        if r < t.shape[0]:
            out[s] = out[s] + t[r]
    return out.astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e", [16, 128])
def test_plain_version_is_a_loop_of_rounded_adds(dtype, e):
    rng = np.random.default_rng(e)
    table, rows, slots = _pairs(rng, 300, 40, e, dtype)
    ops.reset_counts()
    got = op.ordered_pool(table, *op.segments(rows, slots, 40, table.shape[0]))
    assert ops.plain_counts()["ordered_pool"] == 1 and ops.launch_counts()["ordered_pool"] == 0
    assert got.dtype == dtype and got.shape == (40, e)
    want = _numpy_loop(table, rows, slots, 40)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not got[1].any()  # the empty slot
    # the JAX package's scatter-add in the table's type over the row-sorted
    # list, the sentinel row gathered as zeros (`mode="fill"`)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jt = jnp.asarray(table.float().numpy()).astype(jdt)
    rows_j = jt.at[jnp.asarray(rows.numpy())].get(mode="fill", fill_value=0)
    ref = jnp.zeros((40, e), jdt).at[jnp.asarray(slots.numpy())].add(rows_j)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_bf16_rounds_after_every_add():
    """1.0 then 256 adds of 2^-9 stays 1.0 (each add rounds back); the 1.0
    last gives 1.5."""
    slots = torch.zeros(257, dtype=torch.int64)
    offsets = torch.tensor([0, 257])
    one_first = torch.tensor([[1.0]] + [[2.0**-9]] * 256, dtype=torch.bfloat16)
    rows = torch.arange(257)
    assert op.ordered_pool(one_first, rows, offsets).item() == 1.0
    assert op.ordered_pool(one_first.flip(0), rows, offsets).item() == 1.5
    assert op.ordered_pool(one_first.float(), rows, offsets).item() == 1.5
    assert op.ordered_pool(one_first, *op.segments(rows, slots, 1, 257)).item() == 1.0  # rows in ascending order


def test_segments_order_each_slot_by_row_sentinel_last():
    rows = torch.tensor([8, 5, 1, 1, 3, 0, 7, 8])
    slots = torch.tensor([2, 2, 0, 2, 0, 2, 3, 0])
    srows, offsets = op.segments(rows, slots, 5, 8)
    assert srows.tolist() == [1, 3, 8, 0, 1, 5, 8, 7]
    assert offsets.tolist() == [0, 3, 3, 7, 8, 8]
    table = torch.arange(16.0).reshape(8, 2)
    np.testing.assert_array_equal(op.ordered_pool(table, srows, offsets).numpy(),
                                  [[8.0, 10.0], [0, 0], [12.0, 15.0], [14.0, 15.0], [0, 0]])


# The kernel's design edges (csrc/ordered_pool.cu: ids a group of 8, 16 or
# 32 lanes at a time, one walk of a slot whatever the row stride, several
# accesses a lane where the slots are short): long slots of 31, 32, 33, 64
# and 65 rows, the first foreign id at positions 0, 31, 32 and 33 of a slot;
# short slots of 0-17 rows, the first foreign id at 0, 1, 7 and 8; row
# strides 128, 129, 130 and 132, E 13, 16, 64 and 128; E 256 and 512 (two
# walks).
EDGE_SLOTS = {
    # slot lengths, first foreign id in slots of n_ids ids, n_ids
    "long": ((31, 32, 33, 64, 65, 0, 1), (0, 31, 32, 33), 40),
    "short": ((0, 1, 2, 3, 7, 8, 9, 17), (0, 1, 7, 8), 9),
}


def edge_case(rng, dtype, e, stride, slots="long", rows=70):
    """A [rows, stride] table, its first e columns the pooled view; slots of
    EDGE_SLOTS[slots]'s lengths, then slots of n_ids ids whose first
    foreign one (id `rows` or more) stands at the positions given; each
    slot's ids ascending. Returns (full table, row ids, slot of each id,
    offsets)."""
    lens, foreign_at, n_ids = EDGE_SLOTS[slots]
    ids, slot_of = [], []
    for s, n in enumerate(lens):
        ids.append(np.sort(rng.integers(0, rows, size=n)))
        slot_of.append(np.full(n, s))
    for i, at in enumerate(foreign_at):
        r = np.sort(rng.integers(0, rows, size=n_ids))
        r[at:] = rows + np.arange(n_ids - at) % 3  # foreign ids, ascending
        ids.append(r)
        slot_of.append(np.full(n_ids, len(lens) + i))
    n_slots = len(lens) + len(foreign_at)
    counts = np.bincount(np.concatenate(slot_of), minlength=n_slots)
    table = (rng.normal(size=(rows, stride)) * np.exp2(rng.integers(-8, 4, size=(rows, 1)))).astype(np.float32)
    return (torch.from_numpy(table).to(dtype), torch.from_numpy(np.concatenate(ids)),
            torch.from_numpy(np.concatenate(slot_of)), torch.from_numpy(np.concatenate([[0], np.cumsum(counts)])))


def _jax_pool(view, rows, slots, n_slots, weights=None):
    """The JAX package's scatter-add in the table's type over the list, the
    foreign rows gathered as zeros; with weights, rows * w in that type."""
    jdt = jnp.bfloat16 if view.dtype == torch.bfloat16 else jnp.float32
    jt = jnp.asarray(view.float().numpy()).astype(jdt)
    rows_j = jt.at[jnp.asarray(rows.numpy())].get(mode="fill", fill_value=0)
    if weights is not None:
        rows_j = rows_j * jnp.asarray(weights.numpy()).astype(jdt)[:, None]
    ref = jnp.zeros((n_slots, view.shape[1]), jdt).at[jnp.asarray(slots.numpy())].add(rows_j)
    return np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("slots", ["long", "short"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [128, 129, 130, 132])
@pytest.mark.parametrize("e", [13, 16, 64, 128])
def test_plain_version_at_the_kernels_edges(dtype, stride, e, slots):
    """Bitwise JAX's scatter-add on the first e columns of [R, stride] rows."""
    rng = np.random.default_rng(stride * 1000 + e)
    full, rows, slot_of, offsets = edge_case(rng, dtype, e, stride, slots)
    view = full[:, :e]
    got = op.ordered_pool(view, rows, offsets)
    n_slots = offsets.numel() - 1
    np.testing.assert_array_equal(got.float().numpy(), _jax_pool(view, rows, slot_of, n_slots))
    empty, foreign_first = EDGE_SLOTS[slots][0].index(0), len(EDGE_SLOTS[slots][0])
    assert not got[empty].any() and not got[foreign_first].any()  # no rows; foreign at 0


@pytest.mark.parametrize("slots", ["long", "short"])
@pytest.mark.parametrize("dtype, e, stride", [(torch.float32, 256, 256), (torch.float32, 256, 260),
                                              (torch.bfloat16, 512, 512), (torch.bfloat16, 512, 516)])
def test_plain_version_of_rows_that_take_two_walks(dtype, e, stride, slots):
    """Rows past 32 accesses (E 256 f32, E 512 bf16): bitwise JAX's."""
    rng = np.random.default_rng(e + stride)
    full, rows, slot_of, offsets = edge_case(rng, dtype, e, stride, slots)
    view = full[:, :e]
    got = op.ordered_pool(view, rows, offsets)
    np.testing.assert_array_equal(got.float().numpy(), _jax_pool(view, rows, slot_of, offsets.numel() - 1))
    vec, lanes, per, _shift = op.pool_plan(e, full.element_size(), stride, 0, 0,
                                           rows.numel() / (offsets.numel() - 1))
    assert 2 * lanes * vec * per == e  # two walks


@pytest.mark.parametrize("slots", ["long", "short"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [128, 129])
def test_weighted_plain_version_at_the_kernels_edges(dtype, stride, slots):
    """rows x w rounded to the table's type, then added: bitwise JAX's."""
    rng = np.random.default_rng(stride)
    full, rows, slot_of, offsets = edge_case(rng, dtype, 128, stride, slots)
    w = torch.from_numpy((rng.random(rows.numel()) * 3).astype(np.float32))
    view = full[:, :128]
    got = op.ordered_pool(view, rows, offsets, w)
    np.testing.assert_array_equal(got.float().numpy(), _jax_pool(view, rows, slot_of, offsets.numel() - 1, w))


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("stride", [128, 129, 130, 132])
def test_plan_walks_a_slot_once_whatever_the_stride(itemsize, stride):
    """At E 128 every row stride takes one walk (lanes x vec x per >= 128
    columns) of 16-byte accesses: aligned ones where each row starts on 16
    bytes, shifted ones (4-byte words) where it does not; short slots or
    long."""
    for slot_ids in (2.0, 14.0):
        vec, lanes, per, shift = op.pool_plan(128, itemsize, stride, 0, 1024, slot_ids)
        assert lanes * vec * per >= 128 and lanes in (8, 16, 32) and per in (1, 2, 4)
        assert vec * itemsize == 16 and shift == int(stride * itemsize % 16 != 0)
        assert per == 1 or (not shift and slot_ids < op.SHORT_SLOT_IDS and lanes == 8)


def test_plan_shapes():
    # E 128 on dense rows: one 16-byte access a lane, 16 lanes a slot in
    # bf16, 32 in f32
    assert op.pool_plan(128, 2, 128) == (8, 16, 1, 0)
    assert op.pool_plan(128, 4, 128) == (4, 32, 1, 0)
    # rowwise_pack's [R, 129] bf16 rows, and a view whose first row is not
    # 16-byte aligned: shifted 16-byte accesses, one walk
    assert op.pool_plan(128, 2, 129) == (8, 16, 1, 1)
    assert op.pool_plan(128, 2, 128, table_addr=2) == (8, 16, 1, 1)
    assert op.pool_plan(128, 4, 130) == (4, 32, 1, 1)
    # an output that is not 16-byte aligned takes the widest aligned accesses
    assert op.pool_plan(128, 2, 129, out_addr=8) == (1, 32, 1, 0)
    assert op.pool_plan(128, 2, 128, out_addr=8) == (4, 32, 1, 0)
    # narrow rows keep 8 lanes busy; E 13 takes one-element accesses
    assert op.pool_plan(16, 2, 16) == (2, 8, 1, 0)
    assert op.pool_plan(13, 4, 13) == (1, 16, 1, 0)
    assert op.pool_plan(13, 2, 14) == (1, 16, 1, 0)
    assert op.pool_plan(64, 2, 64) == (8, 8, 1, 0)
    assert op.pool_plan(64, 4, 64) == (4, 16, 1, 0)
    # past 32 accesses a slot takes more walks of 32 lanes
    assert op.pool_plan(512, 2, 512) == (8, 32, 1, 0)


def test_plan_gives_short_slots_several_accesses_a_lane():
    # short slots: 8 lanes a slot, each with the row's other accesses, so a
    # warp holds 4 slots; only for aligned 16-byte accesses
    short = op.SHORT_SLOT_IDS / 2
    assert op.pool_plan(128, 4, 128, slot_ids=short) == (4, 8, 4, 0)
    assert op.pool_plan(128, 2, 128, slot_ids=short) == (8, 8, 2, 0)
    assert op.pool_plan(64, 4, 64, slot_ids=short) == (4, 8, 2, 0)
    assert op.pool_plan(64, 2, 64, slot_ids=short) == (8, 8, 1, 0)
    assert op.pool_plan(128, 2, 129, slot_ids=short) == (8, 16, 1, 1)
    assert op.pool_plan(16, 2, 16, slot_ids=short) == (2, 8, 1, 0)
    assert op.pool_plan(128, 4, 128, slot_ids=op.SHORT_SLOT_IDS) == (4, 32, 1, 0)
