"""The step as one program: the fixed-shape, sync-free train step and eval
forward, and the captured step.

On the CPU, the tiny f32 flagship (one-hot tables and one shared group on
the sorted route) and the tiny bench-configured model (bf16, bench.py's
measured caps: the one-hot group, the dense sweep and the sorted route)
train 3 steps and evaluate under `_Refuse`, a dispatch mode that raises on
every op that reads a device value on the host or sizes its result by the
data (`.item()` / `int()` of a tensor, nonzero, masked_select, unique,
boolean indexing). Each run is held:

* bitwise against the port's earlier step on the same state and batches,
  the update that took the valid keys out on the host (`_parent_apply_sparse`
  below, the earlier `apply_sparse` with its segscan plain version, kept
  here as written);
* against the JAX package within the tolerances of tests/test_torch_model.py
  (f32: loss rtol 1e-4) and tests/test_torch_bench.py (bench: step 1 loss
  rtol 1e-5, steps 2-3 rtol 5e-3, eval AUC within 0.01).

The over-cap case sets a valid cap of 512 keys on every rowop group whose
batch holds more valid keys than that, in both packages: the JAX package
takes its cond's full-list branch (sparse_optimizer.py:596-621,
collection.py:1460-1473) and the port, whose work the device count bounds,
must give its numbers.

The count-bounded plain versions of segscan and the drop-mode scatters are
held against their unbounded forms. The `gpu` cases run on the card only:
capture and replay against the eager step from one state.
"""
import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hugectr_tpu_torch import ops
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Optimizer_t
from hugectr_tpu_torch.embedding import sparse_optimizer as so
from hugectr_tpu_torch.ops import row_scatter as rs
from hugectr_tpu_torch.ops import segscan as ss
from hugectr_tpu_torch.optim.params import OptParams
from hugectr_tpu_torch.tools import flagship as tflagship
from hugectr_tpu_torch.tools.carry import load_jax_state

torch.set_num_threads(1)

aten = torch.ops.aten
REFUSED = {aten._local_scalar_dense, aten.nonzero, aten.masked_select, aten._unique2}
INDEXED = {aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_}


class _Refuse(TorchDispatchMode):
    """Raise on an op that waits for the device or sizes by the data."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        pkt = func.overloadpacket
        if pkt in REFUSED:
            raise AssertionError(f"{func} reads the device or sizes by the data")
        if pkt in INDEXED and any(t is not None and t.dtype in (torch.bool, torch.uint8) for t in args[1]):
            raise AssertionError(f"{func} with a boolean index")
        return func(*args, **(kwargs or {}))


# ------------------------------------------------ the earlier update
def _parent_segscan(vals, heads, out_dtype):
    k = vals.shape[0]
    if k == 0:
        return vals.to(out_dtype, copy=True)
    h = heads.clone()
    h[0] = True
    c = torch.cumsum(vals.double(), dim=0)
    seg = torch.cumsum(h.long(), dim=0) - 1
    head_pos = torch.nonzero(h).squeeze(1)
    before = c[(head_pos - 1).clamp(min=0)] * (head_pos > 0).unsqueeze(1)
    return (c - before[seg]).to(out_dtype)


def _parent_apply_sparse(opt, table, state, idx, src, dsrc, lr, dense_rows, dense_ratio, step=1, k_limit=0,
                         grad_dtype=torch.float32, valid_cap=0, packed=False, **_):
    """The port's `apply_sparse` before the step became fixed-shape, for
    the routes these models take (float32 dense sweep, sorted AdaGrad)."""
    kind = opt.optimizer
    rows = table.shape[0]
    route = so.update_route(rows, idx.shape[0], dense_rows, dense_ratio, kind, valid_cap, packed)
    assert route != "scatter" and not packed and grad_dtype == torch.float32 and not k_limit
    valid = idx < rows
    if route == "dense":
        vidx = idx[valid]
        grad = torch.zeros((rows, dsrc.shape[1]), dtype=torch.float32, device=table.device)
        grad.index_add_(0, vidx, dsrc[src[valid]].float())
        so.apply_dense(opt, table, state, grad, torch.any(grad != 0, dim=1), lr, step)
        return route
    sidx, perm = torch.sort(idx, stable=True)
    n = int(torch.count_nonzero(sidx < rows))
    sidx, perm = sidx[:n], perm[:n]
    sgrads = dsrc.to(table.dtype)[src[perm]]
    head = torch.ones(n, dtype=torch.bool)
    head[1:] = sidx[1:] != sidx[:-1]
    summed = _parent_segscan(sgrads.contiguous(), head, torch.float32)
    tail = torch.ones_like(head)
    tail[:-1] = head[1:]
    uidx, g = sidx[tail], summed[tail]
    old = {k: a[uidx] for k, a in state.items()}
    _op, val, new = so.update_math(opt, table, old, g, lr, step)
    table.index_add_(0, uidx, val.to(table.dtype))
    for k, v in new.items():
        state[k].index_copy_(0, uidx, v.to(state[k].dtype))
    return route


# ------------------------------------------------ the models
TINY_F32 = dict(onehot_vocab=100, dense_update_rows=0, dense_key_ratio=0.0)
JAX_F32 = {"HCTR_TPU_ONEHOT_VOCAB": "100", "HCTR_TPU_DENSE_UPDATE_ROWS": "0", "HCTR_TPU_DENSE_KEY_RATIO": "0",
           "HCTR_TPU_SEGSUM": "scan", "HCTR_TPU_ONEHOT_KERNEL": "pallas", "HCTR_TPU_HOT_ROWS": "0",
           "HCTR_BENCH_OPT": "rowwise_adagrad"}
TINY = dict(ev_size=16, vocab_cap=4000, synthetic_batches=3, bottom_mlp=(32, 16), top_mlp=(32, 16, 1),
            projection_dim=8, num_cross_layers=2, batchsize=64, use_mixed_precision=True, max_eval_batches=5)
SPLIT = dict(hot_rows=256, superhot_rows=32, split_vocab=512, auc_exact_max=100, dense_update_rows=1024)
JAX_BENCH = {"HCTR_TPU_EMB_DTYPE": "bfloat16", "HCTR_TPU_EMB_STATE_DTYPE": "bfloat16", "HCTR_TPU_SEGSUM": "xla",
             "HCTR_TPU_HOT_ROWS": "256", "HCTR_TPU_SUPERHOT_ROWS": "32", "HCTR_TPU_SPLIT_VOCAB": "512",
             "HCTR_TPU_ONEHOT_VOCAB": "64", "HCTR_TPU_AUC_EXACT_MAX": "100", "HCTR_TPU_DENSE_UPDATE_ROWS": "1024",
             "HCTR_TPU_DENSE_KEY_RATIO": "0.3", "HCTR_BENCH_OPT": "rowwise_adagrad"}
OVER_CAP = 512


def _port(kind):
    rm = ResourceManager.create(device="cpu")
    if kind == "f32":
        return tflagship.build_tiny_dlrm(rm, batchsize=64, **TINY_F32)
    port = dict(unique_cap_factor=0) if kind == "over_cap" else {}
    kw = dict(tflagship.bench_settings(), **TINY, **SPLIT, **port)
    return tflagship.build_dlrm_dcnv2(rm, onehot_vocab=64, synthetic_learnable=True, **kw)


def _jax(kind, monkeypatch):
    """The JAX model of `kind` (imported here: the card's machine, which
    runs the `gpu` cases, has no JAX)."""
    import hugectr_tpu as jh
    from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
    from hugectr_tpu.tools import flagship as jflagship

    if kind == "f32":
        for k, v in JAX_F32.items():
            monkeypatch.setenv(k, v)
        monkeypatch.delenv("HCTR_TPU_EMB_DTYPE", raising=False)
        return jflagship.build_tiny_dlrm(JaxResourceManager.create(num_devices=1), batchsize=64)
    env = dict(JAX_BENCH, HCTR_TPU_UCAP_FACTOR="0" if kind == "over_cap" else "auto", HCTR_TPU_UCAP_HEADROOM="1.05")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    reader = jh.DataReaderParams(data_reader_type="synthetic", synthetic_num_batches=3, synthetic_alpha=1.05,
                                 synthetic_learnable=True)
    return jflagship.build_dlrm_dcnv2(JaxResourceManager.create(num_devices=1), reader=reader, **TINY)


def _over_cap(tm, jm):
    """A valid cap of OVER_CAP keys on every rowop group whose first batch
    holds more valid keys than that, in both packages; returns them."""
    tm.start_data_reading()
    batch = next(iter(tm.train_reader))
    fk = {k: torch.as_tensor(v) for k, v in tm._feature_keys(batch).items()}
    over = []
    for g in tm.ec.plan.groups:
        if g.compute_kind != "rowop":
            continue
        keys = tm.ec._group_keys(g, fk)
        valid, _owner, _row = tm.ec._slot_placement(g.name, keys)
        if int(valid.sum()) > OVER_CAP and keys.numel() > OVER_CAP:
            over.append(g.name)
            tm.ec.valid_caps[g.name] = jm.ec.valid_caps[g.name] = OVER_CAP
    return over


def _state(tm):
    """Every table, optimizer state and dense parameter, cloned."""
    out = {f"t/{k}": v.clone() for k, v in tm.tables.items()}
    out.update({f"s/{g}/{k}": v.clone() for g, st in tm.eopt.items() for k, v in st.items()})
    out.update({f"p/{lay}/{k}": p.detach().clone() for lay, ps in tm.network.param_tree().items()
                for k, p in ps.items()})
    return out


def _run(tm, mode):
    """3 train steps and the eval forward of every eval batch (under `mode`);
    (losses, eval predictions, final state)."""
    with mode:
        losses = [tm.train_async() for _ in range(3)]
        source, _feeder, _fed = tm._eval_batches()
        preds = [tm._eval_step(b)[1] for b in source]
    return [float(x) for x in losses], preds, _state(tm)


@pytest.mark.parametrize("kind", ["f32", "bench", "over_cap"])
def test_fixed_shape_step_is_sync_free_and_matches_parent_and_jax(kind, monkeypatch):
    import jax

    jm = _jax(kind, monkeypatch)
    jstate = jax.device_get(jm.state)
    tm, parent = _port(kind), _port(kind)
    for m in (tm, parent):
        load_jax_state(m, jstate)
    over = [_over_cap(m, jm) for m in (tm, parent)][0] if kind == "over_cap" else None
    ops.reset_counts()
    losses, preds, state = _run(tm, _Refuse())
    counts, routes = ops.plain_counts(), list(tm.ec.group_routes.values())
    assert "sorted" in routes and counts["adagrad_rows"] == 3 * routes.count("sorted")
    assert counts["segscan"] == 3 * routes.count("sorted")
    if kind != "f32":
        assert "dense" in routes and counts["row_scatter"] == 3 * routes.count("dense")
    if kind == "over_cap":
        assert over, "no group holds more valid keys than the cap"
    # bitwise the earlier step's, on the same state and batches
    with monkeypatch.context() as m:
        m.setattr(so, "apply_sparse", _parent_apply_sparse)
        plosses, ppreds, pstate = _run(parent, contextlib.nullcontext())
    assert losses == plosses
    assert state.keys() == pstate.keys()
    for k in state:
        assert torch.equal(state[k], pstate[k]), k
    for a, b in zip(preds, ppreds, strict=True):
        assert a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)
    # the JAX package, from the same state
    jl = [jm.train() for _ in range(3)]
    if kind == "f32":
        np.testing.assert_allclose(losses, jl, rtol=1e-4)
        return
    np.testing.assert_allclose(losses[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(losses[1:], jl[1:], rtol=5e-3)
    jv, tv = jm.eval(), tm.eval()
    assert abs(tv["auc"] - jv["auc"]) < 0.01, (tv, jv)


def test_a_short_batch_is_not_replayed_through_the_full_batch_buffers():
    """A short tail batch (a cached file's last one, kept with
    drop_incomplete_batch=False) goes to the eager step, and its shapes key
    a capture apart from the full batch's, so that no replay copies it into
    buffers of another shape."""
    tm = _port("f32")
    tm.start_data_reading()
    batch = tm._next_train_batch()
    short = {k: v[:1] for k, v in batch.items()}
    assert tm._full_batch(batch, True) and not tm._full_batch(short, True)
    assert tm._graph_key(batch) == tm._graph_key({k: v.clone() for k, v in batch.items()})
    assert tm._graph_key(batch) != tm._graph_key(short)
    source, _feeder, _fed = tm._eval_batches()
    eb = next(iter(source))
    assert tm._full_batch(eb, False) and not tm._full_batch({k: v[:3] for k, v in eb.items()}, False)
    tm._staged_train_batch = short
    assert np.isfinite(float(tm.train_async())) and tm._eager_steps == 1


# ------------------------------------------------ count-bounded plain versions
def _sorted_list(rng, k, rows, s, pad):
    """(sorted ids with `pad` sentinels last, rowsrc [K] into S rows)."""
    ids = np.sort(rng.integers(0, rows, size=k - pad))
    sidx = torch.as_tensor(np.concatenate([ids, np.full(pad, rows)]), dtype=torch.int64)
    return sidx, torch.as_tensor(rng.integers(0, s, size=k), dtype=torch.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [0, 1, 37, 200])
def test_segscan_count_bounded_plain_is_the_prefix_of_the_unbounded(dtype, n):
    rng = np.random.default_rng(n)
    sidx, rowsrc = _sorted_list(rng, 200, 50, 80, 200 - n)
    vals = torch.as_tensor(rng.standard_normal((80, 8)), dtype=torch.float32).to(dtype)
    heads = torch.ones(200, dtype=torch.bool)
    heads[1:] = sidx[1:] != sidx[:-1]
    count = torch.tensor(n)
    got = ss.segmented_sum_sorted(vals, heads, torch.float32, count, rowsrc)
    full = _parent_segscan(vals[rowsrc].contiguous(), heads, torch.float32)
    assert torch.equal(got[:n], full[:n]) and not got[n:].any()
    assert torch.equal(ss.segmented_sum_sorted(vals[rowsrc].contiguous(), heads, torch.float32), full)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_rows_plain_drops_what_mode_drop_drops(dtype):
    rng = np.random.default_rng(3)
    idx = torch.as_tensor(rng.integers(0, 60, size=300), dtype=torch.int64)  # rows >= 40 dropped
    src = torch.as_tensor(rng.integers(0, 90, size=300), dtype=torch.int64)
    vals = torch.as_tensor(rng.standard_normal((90, 8)), dtype=torch.float32)
    got = rs.scatter_add_rows(idx, src, vals, 40, dtype)
    valid = idx < 40
    want = torch.zeros((40, 8), dtype=dtype).index_add_(0, idx[valid], vals[src[valid]].to(dtype))
    assert got.shape == (40, 8) and torch.equal(got, want)


def _expected_row_update(opt, table, accum, sidx, g, n, lr):
    """The earlier unique-row update of the tails (runs ended in the whole
    list) among the first n entries whose ids lie in [0, R)."""
    k, rows = sidx.shape[0], table.shape[0]
    tail = torch.ones(k, dtype=torch.bool)
    tail[:-1] = sidx[1:] != sidx[:-1]
    live = tail & (torch.arange(k) < n) & (sidx >= 0) & (sidx < rows)
    uidx, gu = sidx[live], g[live]
    want_t, want_a = table.clone(), accum.clone()
    _op, val, new = so.update_math(opt, want_t, {"accum": want_a[uidx]}, gu, lr, 1)
    want_t.index_add_(0, uidx, val.to(table.dtype))
    want_a.index_copy_(0, uidx, new["accum"].to(accum.dtype))
    return want_t, want_a


def _row_update_state(rng, opt, rows, e, dtype):
    table = torch.as_tensor(rng.standard_normal((rows, e)), dtype=torch.float32).to(dtype)
    state = so.init_state(opt, rows, e, dtype)
    state["accum"].add_(torch.as_tensor(rng.random(tuple(state["accum"].shape)), dtype=torch.float32).to(dtype))
    return table, state["accum"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", [Optimizer_t.AdaGrad, Optimizer_t.RowWiseAdaGrad])
@pytest.mark.parametrize("n", [0, 90, 160, 31, 32, 33, 64, 65])
def test_adagrad_rows_plain_is_the_unique_row_update(kind, dtype, n):
    """The tails of the first n entries, and only they, take the earlier
    unique-row update, bitwise: counts at the kernel's 32-id tile edges
    (31, 32, 33, 64, 65) and at the list's length K = 160, the padding's
    sentinel ids starting at n."""
    rng = np.random.default_rng(n + 7)
    opt = OptParams(optimizer=kind, epsilon=1e-7, initial_accu_value=0.01)
    sidx, _src = _sorted_list(rng, 160, 70, 1, 160 - n)
    g = torch.as_tensor(rng.standard_normal((160, 8)), dtype=torch.float32)
    table, accum = _row_update_state(rng, opt, 70, 8, dtype)
    lr = torch.tensor(0.05, dtype=dtype)
    want_t, want_a = _expected_row_update(opt, table, accum, sidx, g, n, lr)
    rs.adagrad_rows(opt, table, accum, sidx, g, torch.tensor(n), lr)
    assert torch.equal(table, want_t) and torch.equal(accum, want_a)


def _edge_list(rng, k, rows, pad):
    """Sorted ids of k - pad entries with a negative id first, runs across
    the 32-id tiles' edges (positions 28-36, 60-70), one that ends the
    valid ids (85-89) and runs of one, then `pad` sentinels (rows)."""
    ids = np.sort(rng.integers(0, rows, size=k - pad))
    ids[0] = -1
    for lo, hi in ((28, 37), (60, 71), (85, 90)):
        ids[lo:hi] = ids[lo]
    return torch.as_tensor(np.concatenate([ids, np.full(pad, rows)]), dtype=torch.int64)


@pytest.mark.parametrize("lr_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e", [1, 11, 16, 18, 128])
@pytest.mark.parametrize("kind", [Optimizer_t.AdaGrad, Optimizer_t.RowWiseAdaGrad])
def test_adagrad_rows_plain_at_the_kernels_edges(kind, e, lr_dtype):
    """The samples' widths (E 1, 11, 16, 18) and the flagship's (128), a
    bfloat16 or float32 lr, runs that cross 32-id edges, a negative id
    (skipped), and counts at a tile's edge (64, inside the run over
    60-70: entry 63 is no tail), one past it, and the valid prefix (90),
    on a bfloat16 table with bfloat16 state and on float32: bitwise the
    earlier unique-row update."""
    rng = np.random.default_rng(e)
    opt = OptParams(optimizer=kind, epsilon=1e-7, initial_accu_value=0.01)
    sidx = _edge_list(rng, 100, 500, 10)
    g = torch.as_tensor(rng.standard_normal((100, e)), dtype=torch.float32)
    lr = torch.tensor(0.05, dtype=lr_dtype)
    for dtype in (torch.float32, torch.bfloat16):
        for n in (64, 65, 90):
            table, accum = _row_update_state(rng, opt, 500, e, dtype)
            before = table.clone()
            want_t, want_a = _expected_row_update(opt, table, accum, sidx, g, n, lr)
            rs.adagrad_rows(opt, table, accum, sidx, g, torch.tensor(n), lr)
            assert torch.equal(table, want_t) and torch.equal(accum, want_a), (dtype, n)
            assert not torch.equal(table, before)


@pytest.mark.parametrize("kind", [Optimizer_t.AdaGrad, Optimizer_t.RowWiseAdaGrad])
def test_adagrad_rows_plain_is_jax_apply_rows_in_duplicate_mode(kind):
    """The row update against the JAX package's `_apply_rows` with
    is_unique=False (sparse_optimizer.py:752): the sorted ids with
    duplicates, the segment sums, the tail mask, the padding's sentinel
    ids dropped by its scatters. AdaGrad's table is bitwise (both add the
    same float32 step); its accumulator within one float32 rounding of its
    value: JAX writes it by adding new - old to old, the port sets it.
    RowWiseAdaGrad's row mean of g^2 is summed in another order than XLA's
    (two orders of E positive float32 terms differ by at most 2 (E - 1)
    2^-24 of the sum): the accumulator within 2^-15 of itself, the table
    within 2^-15 of its step plus two roundings of its value, as on the
    card (chip_smoke.adagrad_rows_case)."""
    import jax
    import jax.numpy as jnp
    from hugectr_tpu.core.types import Optimizer_t as JOpt
    from hugectr_tpu.embedding import sparse_optimizer as jso
    from hugectr_tpu.optim.params import OptParams as JOptParams

    rng = np.random.default_rng(21)
    k, rows, e, n = 200, 90, 16, 180
    sidx = _edge_list(rng, k, rows, k - n)
    sidx[0] = 0  # JAX wraps a negative index; the port drops it
    g = torch.as_tensor(rng.standard_normal((k, e)), dtype=torch.float32)
    opt = OptParams(optimizer=kind, epsilon=1e-7, initial_accu_value=0.01)
    table, accum = _row_update_state(rng, opt, rows, e, torch.float32)
    table0, before = table.clone(), accum.clone()
    tail = np.ones(k, dtype=bool)
    tail[:-1] = sidx.numpy()[1:] != sidx.numpy()[:-1]
    jopt = JOptParams(optimizer=JOpt(kind.value), epsilon=1e-7, initial_accu_value=0.01)
    # JAX gets copies and is waited for: its transfers and its work are
    # asynchronous, and could otherwise read the tensors' memory after the
    # in-place update below
    with jax.default_device(jax.devices("cpu")[0]):  # the reference on the CPU wherever the test runs
        jt, jst = jso._apply_rows(jopt, jnp.asarray(table.numpy().copy()),
                                  {"accum": jnp.asarray(accum.numpy().copy())}, jnp.float32(0.05), jnp.int32(1),
                                  False, jnp.asarray(sidx.numpy().copy()), jnp.asarray(g.numpy().copy()),
                                  jnp.asarray(tail))
        jt, jst = jax.block_until_ready((jt, jst))
    rs.adagrad_rows(opt, table, accum, sidx, g, torch.tensor(n), torch.tensor(0.05))
    jt, ja = np.asarray(jt), np.asarray(jst["accum"])
    d_t, d_a = np.abs(table.numpy() - jt), np.abs(accum.numpy() - ja)
    if kind == Optimizer_t.AdaGrad:
        assert np.array_equal(table.numpy(), jt) and np.all(d_a <= 2.0**-22 * np.abs(ja))
    else:
        assert np.all(d_t <= 2.0**-15 * np.abs(jt - table0.numpy()) + 2.0**-22 * np.abs(jt))
        assert np.all(d_a <= 2.0**-15 * np.abs(ja))
    assert not torch.equal(accum, before)


# ------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured step and the kernels have no CPU mode")
    return torch.device("cuda")


def _card_model(graph):
    rm = ResourceManager.create(device="cuda")
    kw = dict(tflagship.bench_settings(), **TINY, **SPLIT)
    return tflagship.build_dlrm_dcnv2(rm, onehot_vocab=64, synthetic_learnable=True, use_cuda_graph=graph, **kw)


@pytest.mark.gpu
def test_captured_step_and_eval_equal_the_eager_ones(cuda):
    """The tiny bench model from one seed, eager and captured: the losses
    and the state after 4 steps agree within the spread of the dense
    sweep's atomic adds (one bf16 rounding of a table's scale), and the
    eval forward of the same weights is bitwise the eager one."""
    eager, graph = _card_model(False), _card_model(True)
    assert eager.step_mode == "eager: use_cuda_graph=False" and graph.step_mode == "graph"
    for k, v in _state(eager).items():
        assert torch.equal(v, _state(graph)[k]), k
    le = [float(eager.train_async()) for _ in range(4)]
    ops.reset_counts()
    lg = [float(graph.train_async()) for _ in range(4)]
    assert "train" in graph._graphs and ops.launch_counts()["onehot_fwd"] == 4
    np.testing.assert_allclose(lg, le, rtol=1e-3)
    se, sg = _state(eager), _state(graph)
    for k in se:
        np.testing.assert_allclose(sg[k].float().cpu(), se[k].float().cpu(), rtol=2.0**-7, atol=2.0**-8, err_msg=k)
    for k, v in se.items():  # the same weights for both evals
        sg[k].copy_(v)
    for m, src in ((graph, se), (eager, se)):
        for name, t in m.tables.items():
            t.copy_(src[f"t/{name}"])
        for lay, ps in m.network.param_tree().items():
            for n, p in ps.items():
                p.data.copy_(src[f"p/{lay}/{n}"])
    ve, vg = eager.eval(), graph.eval()
    assert "eval" in graph._graphs
    assert torch.equal(graph.metrics._preds, eager.metrics._preds) and ve == vg


@pytest.mark.gpu
def test_a_short_batch_runs_eagerly_between_replays(cuda):
    """After the capture, a short batch takes the eager step and leaves the
    captured one as it was; the next full batch replays it."""
    graph = _card_model(True)
    for _ in range(2):
        graph.train_async()
    cap = graph._graphs["train"]
    full = graph._next_train_batch()
    graph._staged_train_batch = {k: v[:5] for k, v in full.items()}
    eager_before = graph._eager_steps
    assert torch.isfinite(graph.train_async()) and graph._eager_steps == eager_before + 1
    assert graph._graphs["train"] is cap
    graph._staged_train_batch = full
    assert torch.isfinite(graph.train_async()) and graph._eager_steps == eager_before + 1
    assert graph._graphs["train"] is cap


@pytest.mark.gpu
def test_a_rebuilt_step_is_captured_again(cuda):
    """`_build_steps` (the ablation flags) drops the captures; the next
    steps capture into a new pool and replay."""
    graph = _card_model(True)
    for _ in range(2):
        graph.train_async()
    graph._build_steps()
    assert not graph._graphs
    losses = [graph.train_async() for _ in range(2)]
    assert "train" in graph._graphs and all(torch.isfinite(x) for x in losses)
