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
