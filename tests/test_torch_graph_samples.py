"""The samples as one program: Adam's counted row update (`adam_rows`), the
bias corrections and Dropout's masks read from device scalars, and SGD's
drop-mode scatter into the table.

Every graph of `tools/samples.py::GRAPHS` at the tests' size
(`TINY_SAMPLE`) trains 3 steps and runs its eval forward under `_Refuse`
(tests/test_torch_graph_step.py: no `.item()`, nonzero, masked_select,
unique or boolean index), and is held bitwise against the port's earlier
update on the same state and batches: Adam's sorted route that took the
valid keys out on the host (`dedup_rows`, then `_apply_rows`), SGD's
`index_add_` of the valid keys taken out by a boolean index, and the bias
corrections as host floats, kept below as written (`_parent_apply_sparse`,
`_parent_corrections`). The same steps under the same dispatch mode are
held against the JAX package (the sample run with `runpy`, the state
carried by `tools/carry.py`) in tests/test_torch_samples.py and
tests/test_torch_samples_more.py at their tolerances, which compile each
JAX sample once. A graph with Dropout (WDL) also trains at rate 0.5 under
`_Refuse`: the masks are drawn on the device, one draw a layer and step.

`adam_rows_plain` is held against the JAX package's `_apply_rows` Adam on
the unique rows (count 0, count K, a row repeated over the tiles' edges,
ids at or past R inside the count, a live row whose summed gradient is 0,
bfloat16 table or state; float32 within rtol 1e-5 / atol 1e-7, XLA fusing
the formula and rounding elsewhere; bfloat16 one rounding of its type more,
rtol 2^-7 and an atol of 2^-7 of the array's largest magnitude, since XLA
may round beta1 m in bfloat16 before a sum that cancels)
and bitwise against the earlier unique-row update. The step's scalars:
Adam's corrections at steps 1-3 as `adam_bias_corrections` gives them, in
the same tensors (what a replay reads), and Dropout's mask the same when a
step runs again at the same step number (restored, as `graph_ab` restores
it) and another at the next step. `step_mode` is "graph" for the eleven graphs on a CUDA device
(faked: the refusal reads the device's type), Momentum, RMSProp, the packed
layouts and the drop mode are still refused.
"""
import contextlib

import numpy as np
import pytest
import torch

from hugectr_tpu_torch import ops
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Optimizer_t
from hugectr_tpu_torch.embedding import sparse_optimizer as so
from hugectr_tpu_torch.ops import dropout as dr
from hugectr_tpu_torch.ops import row_scatter as rs
from hugectr_tpu_torch.optim.params import OptParams, StepScalars, adam_bias_corrections
from hugectr_tpu_torch.tools import flagship as tflagship
from hugectr_tpu_torch.tools.samples import GRAPHS, build_tiny_sample

from test_torch_graph_step import _parent_segscan, _Refuse, _run

torch.set_num_threads(1)

IDS = [variant or name for name, variant in GRAPHS]
_APPLY_SPARSE = so.apply_sparse


def _parent_corrections(opt, step):
    """The bias corrections as the earlier step took them: float32 values of
    the host's step, as Python floats."""
    return adam_bias_corrections(opt, step.host if isinstance(step, StepScalars) else step)


def _parent_apply_sparse(opt, table, state, idx, src, dsrc, lr, dense_rows, dense_ratio, step=1, k_limit=0,
                         packed=False, ucap_drop=False, **kw):
    """The port's `apply_sparse` before Adam's sorted route was counted and
    SGD's scatter took a fixed shape: SGD's valid keys taken out by a
    boolean index and added with `index_add_`; Adam's valid prefix taken out
    on the host, gathered, summed, and its tails updated with `index_add_` /
    `index_copy_` (`dedup_rows` and `_apply_rows` as they were written);
    the other routes as now."""
    kind, rows = opt.optimizer, table.shape[0]
    route = so.update_route(rows, idx.shape[0], dense_rows, dense_ratio, kind, kw.get("valid_cap", 0), packed)
    if route == "scatter":
        valid = idx < rows
        vidx = idx[valid]
        table.index_add_(0, vidx, -lr * dsrc.to(table.dtype)[src[valid]])
        return route
    if route != "sorted" or kind != Optimizer_t.Adam:
        return _APPLY_SPARSE(opt, table, state, idx, src, dsrc, lr, dense_rows, dense_ratio, step=step,
                             k_limit=k_limit, packed=packed, ucap_drop=ucap_drop, **kw)
    assert not packed and not ucap_drop and not k_limit
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


def _parent_run(monkeypatch, model):
    with monkeypatch.context() as m:
        m.setattr(so, "apply_sparse", _parent_apply_sparse)
        m.setattr(so, "bias_corrections", _parent_corrections)
        return _run(model, contextlib.nullcontext())


def _assert_runs_equal(a, b):
    (losses, preds, state), (plosses, ppreds, pstate) = a, b
    assert losses == plosses
    assert state.keys() == pstate.keys()
    for k in state:
        assert torch.equal(state[k], pstate[k]), k
    for x, y in zip(preds, ppreds, strict=True):
        assert x.keys() == y.keys() and all(torch.equal(x[n], y[n]) for n in x)


def _pair(name, variant, **kw):
    """Two tiny models of one graph from one state."""
    tm, parent = (build_tiny_sample(name, ResourceManager.create(device="cpu"), variant=variant, **kw)
                  for _ in range(2))
    _copy_state(tm, parent)
    return tm, parent


def _copy_state(src, dst):
    for k, v in src.tables.items():
        dst.tables[k].copy_(v)
    for g, st in src.eopt.items():
        for k, v in st.items():
            dst.eopt[g][k].copy_(v)
    dst_params = dst.network.param_tree()
    for layer, ps in src.network.param_tree().items():
        for k, p in ps.items():
            dst_params[layer][k].data.copy_(p.data)


# ------------------------------------------------ the eleven graphs
# MMoE's tables all fit the one-hot group at the tests' size: a lower
# one-hot vocabulary puts its 100-row tables on SGD's scatter
SCATTER = dict(onehot_vocab=64)


@pytest.mark.parametrize("name,variant", GRAPHS, ids=IDS)
def test_sample_step_is_sync_free_and_matches_parent(monkeypatch, name, variant):
    tm, parent = _pair(name, variant, **(SCATTER if name == "mmoe" else {}))
    ops.reset_counts()
    run = _run(tm, _Refuse())
    counts, routes = ops.plain_counts(), list(tm.ec.group_routes.values())
    kind = tm.opt_params.optimizer
    n_sorted = routes.count("sorted")
    assert counts["adam_rows"] == counts["segscan"] == 3 * n_sorted * (kind == Optimizer_t.Adam)
    assert counts["row_scatter"] == 3 * (routes.count("dense") + routes.count("scatter"))
    assert ("scatter" in routes) == (kind == Optimizer_t.SGD) and counts["dropout_mask"] == 0
    _assert_runs_equal(run, _parent_run(monkeypatch, parent))


def test_the_tiny_graphs_take_the_counted_routes():
    """Between them the tiny graphs give Adam's counted sorted route (DCN,
    DIN) and SGD's scatter (MMoE at a one-hot vocabulary of 64) at least
    one group each."""
    seen = set()
    for name, variant, kw in (("dcn", None, {}), ("din", None, {}), ("mmoe", "mmoe", SCATTER)):
        tm = build_tiny_sample(name, ResourceManager.create(device="cpu"), variant=variant, **kw)
        tm.train()
        seen |= {(tm.opt_params.optimizer, r) for r in tm.ec.group_routes.values()}
    assert {(Optimizer_t.Adam, "sorted"), (Optimizer_t.SGD, "scatter")} <= seen


def test_dropout_at_rate_half_is_sync_free_and_replays_its_masks(monkeypatch):
    """WDL at Dropout 0.5: 3 steps and eval under `_Refuse`, two mask draws
    (one a layer) a step and none in eval, bitwise the earlier routes'
    run; then a step run twice at one step number draws the same masks
    (they follow the restored step, as `graph_ab`'s turns restore it) and
    the next step other masks."""
    tm, parent = _pair("wdl", None, dropout_rate=0.5)
    ops.reset_counts()
    run = _run(tm, _Refuse())
    assert ops.plain_counts()["dropout_mask"] == 3 * 2
    _assert_runs_equal(run, _parent_run(monkeypatch, parent))
    assert all(np.isfinite(run[0]))
    # the step's masks at one step, twice, then at the next step
    drawn = []

    def record(*args):
        drawn.append(mask_fn(*args))
        return drawn[-1]

    mask_fn, step0 = dr.dropout_mask, tm._step
    monkeypatch.setattr(dr, "dropout_mask", record)
    masks = []
    for s in (step0, step0, step0 + 1):
        tm._step = s
        drawn.clear()
        tm.train_async()
        masks.append(list(drawn))
    assert len(masks[0]) == 2 and all(torch.equal(a, b) for a, b in zip(masks[0], masks[1], strict=True))
    assert not any(torch.equal(a, b) for a, b in zip(masks[1], masks[2], strict=True))


# ------------------------------------------------ the captures
def _on_a_card(monkeypatch, model):
    monkeypatch.setattr(model, "device", torch.device("cuda"))
    return model


@pytest.mark.parametrize("name,variant", GRAPHS, ids=IDS)
def test_sample_captures_on_a_card(monkeypatch, name, variant):
    tm = build_tiny_sample(name, ResourceManager.create(device="cpu"), variant=variant, dropout_rate=0.5)
    assert tm.step_mode == "eager: the cpu device"
    _on_a_card(monkeypatch, tm)
    assert tm.step_mode == "graph" and tm._graph_refusal(train=False) is None


@pytest.mark.parametrize("what", ["momentum_sgd", "rmsprop", "packed", "drop_mode"])
def test_the_uncounted_configurations_are_still_refused(monkeypatch, what):
    rm = ResourceManager.create(device="cpu")
    if what == "packed":
        tm = tflagship.build_tiny_dlrm(rm, optimizer="adagrad", packed_state=True, onehot_vocab=100,
                                       dense_update_rows=0)
        assert tm.ec.packed_groups
        want = "eager: the packed layouts"
    elif what == "drop_mode":
        tm = tflagship.build_tiny_dlrm(rm, unique_cap_factor=0.5, ucap_drop=True)
        want = "eager: the drop mode"
    else:
        tm = tflagship.build_tiny_dlrm(rm, optimizer=what)
        want = f"eager: the {what} optimizer"
    _on_a_card(monkeypatch, tm)
    assert tm.step_mode == want


def test_the_capture_key_holds_the_step_scalars():
    """A pair of Adam's corrections made after a capture (an optimizer of
    other betas) is a tensor the capture does not read: the key changes."""
    tm = build_tiny_sample("dcn", ResourceManager.create(device="cpu"))
    tm.start_data_reading()
    batch = tm._next_train_batch()
    tm.train_step(batch)
    key = tm._graph_key(batch)
    tm._set_step(tm._step + 1)
    assert tm._graph_key(batch) == key
    tm._scalars.corrections(OptParams(optimizer=Optimizer_t.Adam, beta1=0.5, beta2=0.75))
    assert tm._graph_key(batch) != key


# ------------------------------------------------ the step's scalars
def test_bias_corrections_are_device_scalars_of_the_step():
    """Steps 1-3: the same two tensors (what a captured step reads) hold
    `adam_bias_corrections` of each step, so that each replay takes its
    own; a second pair of betas gets its own tensors, filled alike."""
    opt = OptParams(optimizer=Optimizer_t.Adam, beta1=0.9, beta2=0.999)
    other = OptParams(optimizer=Optimizer_t.Adam, beta1=0.25, beta2=0.5)
    sc = StepScalars("cpu")
    sc.fill(1)
    pair, pair2 = sc.corrections(opt), sc.corrections(other)
    seen = []
    for step in (1, 2, 3):
        sc.fill(step)
        assert sc.corrections(opt) is pair and sc.corrections(other) is pair2 and int(sc.step) == step
        for p, o in ((pair, opt), (pair2, other)):
            assert all(t.dtype == torch.float32 and t.dim() == 0 for t in p)
            assert (float(p[0]), float(p[1])) == adam_bias_corrections(o, step)
        seen.append((float(pair[0]), float(pair[1])))
    assert len(set(seen)) == 3


def test_the_model_fills_its_scalars_before_each_step():
    tm = build_tiny_sample("ncf", ResourceManager.create(device="cpu"), variant="gmf")
    bc = tm._scalars.corrections(tm.opt_params)
    for step in (1, 2, 3):
        tm.train_async()
        assert int(tm._scalars.step) == tm._step == step
        assert (float(bc[0]), float(bc[1])) == adam_bias_corrections(tm.opt_params, step)


# ------------------------------------------------ Dropout's masks
def test_dropout_mask_keep_rate_scale_and_steps():
    """At keep 0.5 and 0.8: the kept share within 5 standard deviations of
    keep; two steps' masks agree on about keep^2 + (1 - keep)^2 of the
    elements (independent draws), as do neighbouring elements; the rank's
    block of a global mask is the mask drawn from its first index."""
    step = torch.tensor(7)
    n = 1 << 18
    for keep in (0.5, 0.8):
        sd = 5 * np.sqrt(keep * (1 - keep) / n)
        a = dr.dropout_mask((123, 456), step, n, 0, keep)
        b = dr.dropout_mask((123, 456), step + 1, n, 0, keep)
        both = keep**2 + (1 - keep) ** 2
        assert abs(float(a.float().mean()) - keep) <= sd
        assert abs(float((a == b).float().mean()) - both) <= 5 * np.sqrt(both * (1 - both) / n)
        assert abs(float((a[1:] == a[:-1]).float().mean()) - both) <= 5 * np.sqrt(both * (1 - both) / n)
        assert torch.equal(dr.dropout_mask((123, 456), step, n // 2, n // 2, keep), a[n // 2 :])
        assert not torch.equal(dr.dropout_mask((124, 456), step, n, 0, keep), a)


def test_dropout_layer_reads_the_bound_step():
    """A layer bound to a step tensor draws that step's mask: the same mask
    for the same step however often it runs (eager, or a replay that reads
    the tensor), another for the next; kept values scaled by 1 / keep."""
    from hugectr_tpu_torch.core import config as tcfg
    from hugectr_tpu_torch.layers.base import LAYER_REGISTRY

    cfg = tcfg.DenseLayer(layer_type="Dropout", bottom_names=["x"], top_names=["y"], dropout_rate=0.5)
    layer = LAYER_REGISTRY["Dropout"](cfg, [(256, 16)], torch.Generator().manual_seed(3), torch.device("cpu"))
    step = torch.zeros((), dtype=torch.int64)
    layer.bind_step(step)
    layer.train()
    x = torch.rand((256, 16)) + 0.5
    step.fill_(4)
    y1, y2 = layer([x], torch.float32)[0], layer([x], torch.float32)[0]
    step.fill_(5)
    y3 = layer([x], torch.float32)[0]
    assert torch.equal(y1, y2) and not torch.equal(y1 != 0, y3 != 0)
    kept = y1 != 0
    assert torch.equal(y1[kept], x[kept] / 0.5) and int(step) == 5


# ------------------------------------------------ SGD's scatter
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sgd_scatter_is_the_boolean_index_add(dtype):
    """`scatter_add_rows_` into a table: bitwise the earlier `index_add_` of
    the valid entries, row 0 at -0.0 kept (the dropped entries add -0.0),
    ids at or past R and negative ones dropped."""
    rng = np.random.default_rng(5)
    rows, e, k = 50, 8, 300
    idx = torch.as_tensor(rng.integers(-3, rows + 10, size=k))
    src = torch.as_tensor(rng.integers(0, k, size=k))
    vals = torch.as_tensor(rng.normal(size=(k, e)).astype(np.float32)).to(dtype)
    table = torch.as_tensor(rng.normal(size=(rows, e)).astype(np.float32)).to(dtype)
    table[0] = -0.0
    idx[idx == 0] = rows  # nothing valid lands on row 0
    want = table.clone()
    valid = (idx >= 0) & (idx < rows)
    want.index_add_(0, idx[valid], vals[src[valid]])
    rs.scatter_add_rows_(table, idx, src, vals)
    assert torch.equal(table, want) and bool(torch.signbit(table[0]).all())


# ------------------------------------------------ the row update
ADAM = OptParams(optimizer=Optimizer_t.Adam, beta1=0.9, beta2=0.999, epsilon=1e-7)


def _adam_list(rng, k, rows, pad, past=0):
    """Sorted ids of k entries: a negative id first, runs across the 32-id
    tiles' edges (28-36, 60-70) and one long run of one row (100-140),
    `past` ids at or past R inside the valid part, then `pad` sentinels."""
    ids = np.sort(rng.integers(0, rows, size=k - pad - past))
    ids[0] = -1
    for lo, hi in ((28, 37), (60, 71), (100, 141)):
        ids[lo:hi] = ids[lo]
    return torch.as_tensor(np.concatenate([ids, rows + np.arange(past), np.full(pad, rows + past)]))


def _adam_state(rng, rows, e, tdt, sdt):
    """A table and moments as a few steps leave them (v > 0)."""
    table = torch.as_tensor(rng.normal(size=(rows, e)).astype(np.float32) * 0.05).to(tdt)
    m = torch.as_tensor(rng.normal(size=(rows, e)).astype(np.float32) * 0.01).to(sdt)
    v = torch.as_tensor(rng.random((rows, e), dtype=np.float32) * 1e-3).to(sdt)
    return table, m, v


def _bc(step):
    return tuple(torch.tensor(b, dtype=torch.float32) for b in adam_bias_corrections(ADAM, step))


def _expected_adam(table, m, v, sidx, g, count, lr, step):
    """The earlier unique-row update of the live tails (`_apply_rows` with
    the host's step)."""
    live = rs._live_tails(sidx, torch.tensor(count), table.shape[0])
    uidx, gu = sidx[live], g[live]
    want = [x.clone() for x in (table, m, v)]
    so._apply_rows(ADAM, want[0], {"m": want[1], "v": want[2]}, lr, uidx, gu, step)
    return want, uidx, gu


DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("tdt,sdt", DTYPES, ids=["f32", "bf16_table", "bf16_state"])
@pytest.mark.parametrize("e", [1, 11, 16, 18])
def test_adam_rows_plain_is_the_unique_row_update(tdt, sdt, e):
    """Counts 0, a tile's edge (64, inside the run over 60-70), one past
    it, inside the long run (120), and the list's length K (the sentinels
    too), at steps 1 and 3: bitwise the earlier unique-row update; a
    bfloat16 lr for a bfloat16 table, as the collection gives it; a live
    tail with a zero summed gradient decays its moments."""
    rng = np.random.default_rng(e)
    k, rows = 200, 300
    sidx = _adam_list(rng, k, rows, pad=20, past=5)
    g = torch.as_tensor(rng.normal(size=(k, e)).astype(np.float32) * 0.05)
    g[70] = 0.0  # the tail of the run over 60-70: a live summed gradient of 0 at counts past 70
    lr = torch.tensor(0.01, dtype=tdt)
    for step in (1, 3):
        for count in (0, 64, 65, 120, k):
            table, m, v = _adam_state(rng, rows, e, tdt, sdt)
            (wt, wm, wv), uidx, _gu = _expected_adam(table, m, v, sidx, g, count, lr, step)
            before = [x.clone() for x in (table, m, v)]
            rs.adam_rows(ADAM, table, m, v, sidx, g, torch.tensor(count), lr, *_bc(step))
            assert torch.equal(table, wt) and torch.equal(m, wm) and torch.equal(v, wv), (step, count)
            assert (uidx.numel() == 0) == (count == 0) and torch.equal(table, before[0]) == (count == 0)
            if count > 70:  # row sidx[70] is a live tail with g = 0: m, v decay
                assert sidx[70] != sidx[71]
                r = int(sidx[70])
                assert torch.equal(m[r], (ADAM.beta1 * before[1][r].float()).to(sdt))
                assert torch.equal(v[r], (ADAM.beta2 * before[2][r].float()).to(sdt))


def test_adam_rows_checks_its_arguments():
    rng = np.random.default_rng(0)
    table, m, v = _adam_state(rng, 10, 4, torch.float32, torch.float32)
    sidx, g, count = torch.arange(5), torch.zeros(5, 4), torch.tensor(5)
    lr, bc = torch.tensor(0.1), _bc(1)
    with pytest.raises(ValueError, match="not Adam"):
        rs.adam_rows(OptParams(optimizer=Optimizer_t.FTRL), table, m, v, sidx, g, count, lr, *bc)
    with pytest.raises(ValueError, match="one type"):
        rs.adam_rows(ADAM, table, m, v.to(torch.bfloat16), sidx, g, count, lr, *bc)
    with pytest.raises(ValueError, match="0-dim int64"):
        rs.adam_rows(ADAM, table, m, v, sidx, g, torch.tensor([5]), lr, *bc)
    with pytest.raises(ValueError, match="0-dim float32"):
        rs.adam_rows(ADAM, table, m, v, sidx, g, count, lr, torch.tensor([0.1]), bc[1])


@pytest.mark.parametrize("tdt,sdt", DTYPES, ids=["f32", "bf16_table", "bf16_state"])
@pytest.mark.parametrize("case", ["count_0", "count_k", "past_rows", "zero_grad"])
def test_adam_rows_plain_is_jax_apply_rows(tdt, sdt, case):
    """The row update against the JAX package's `_apply_rows` Adam in
    unique mode (sparse_optimizer.py:855-870) at step 2 on the live tails'
    ids and sums, ids at or past R given to it as well (its scatters drop
    them, its gathers fill 0). float32: rtol 1e-5 / atol 1e-7 (XLA fuses
    the formula and may round its products elsewhere); bfloat16 table or
    state: one rounding of that type more (rtol 2^-7, and 2^-7 of the
    array's largest magnitude where a sum cancels)."""
    import jax
    import jax.numpy as jnp
    from hugectr_tpu.core.types import Optimizer_t as JOpt
    from hugectr_tpu.embedding import sparse_optimizer as jso
    from hugectr_tpu.optim.params import OptParams as JOptParams

    rng = np.random.default_rng(23)
    k, rows, e, step = 240, 180, 16, 2
    sidx = _adam_list(rng, k, rows, pad=0 if case == "count_k" else 30, past=6 if case == "past_rows" else 0)
    sidx[0] = 0  # JAX wraps a negative index; the port drops it
    count = {"count_0": 0, "count_k": k, "past_rows": k - 30, "zero_grad": k - 30}[case]
    g = torch.as_tensor(rng.normal(size=(k, e)).astype(np.float32) * 0.05)
    if case == "zero_grad":
        g[140] = 0.0  # the long run's tail
    table, m, v = _adam_state(rng, rows, e, tdt, sdt)
    lr = torch.tensor(0.01)
    _want, uidx, gu = _expected_adam(table, m, v, sidx, g, count, lr, step)
    live_past = (sidx >= rows) & (torch.arange(k) < count)
    ju = torch.cat([uidx, torch.unique(sidx[live_past])])
    jg = torch.cat([gu, torch.ones(ju.numel() - uidx.numel(), e)])
    jopt = JOptParams(optimizer=JOpt.Adam, beta1=ADAM.beta1, beta2=ADAM.beta2, epsilon=ADAM.epsilon)

    def j(t):
        return jnp.asarray(t.float().numpy().copy()).astype(jnp.bfloat16 if t.dtype == torch.bfloat16
                                                             else jnp.float32)

    # JAX gets copies and is waited for (its work is asynchronous) before
    # the in-place update below
    with jax.default_device(jax.devices("cpu")[0]):
        jt, jst = jso._apply_rows(jopt, j(table), {"m": j(m), "v": j(v)}, jnp.float32(0.01), jnp.int32(step), True,
                                  jnp.asarray(ju.numpy().copy()), jnp.asarray(jg.numpy().copy()), None)
        jt, jst = jax.block_until_ready((jt, jst))
    before = [x.clone() for x in (table, m, v)]
    rs.adam_rows(ADAM, table, m, v, sidx, g, torch.tensor(count), lr, *_bc(step))
    for name, got, want, dt in (("m", m, jst["m"], sdt), ("v", v, jst["v"], sdt), ("w", table, jt, tdt)):
        want = np.asarray(want, np.float32)
        tol = (dict(rtol=1e-5, atol=1e-7) if dt == torch.float32
               else dict(rtol=2.0**-7, atol=2.0**-7 * float(np.abs(want).max())))
        np.testing.assert_allclose(got.float().numpy(), want, **tol, err_msg=name)
    assert torch.equal(table, before[0]) == (count == 0)
    if case == "zero_grad":  # m and v decay, the weights move
        r = int(sidx[140])
        assert torch.equal(m[r], (ADAM.beta1 * before[1][r].float()).to(sdt))
        assert torch.equal(v[r], (ADAM.beta2 * before[2][r].float()).to(sdt))
        assert not torch.equal(table[r], before[0][r]) and not torch.equal(m[r], before[1][r])
