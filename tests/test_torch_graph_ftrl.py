"""DLRM with FTRL as one program: the counted FTRL row update (`ftrl_rows`)
and the tiny DLRM-FTRL's step and eval with no host read.

The tiny DLRM-FTRL (`build_tiny_dlrm_ftrl`), static and dynamic, is built
as tests/test_torch_dlrm_ftrl.py builds it: the JAX side is
`samples/dlrm_ftrl.py` run with `runpy`, the state carried by
`load_jax_state`. It trains 3 steps and evaluates under `_Refuse`
(tests/test_torch_graph_step.py: no `.item()`, nonzero, masked_select,
unique or boolean index) and is held:

* bitwise against the port's earlier FTRL update on the same state and
  batches: the sorted route that took the valid keys out on the host
  (`dedup_rows`, then `_apply_rows`), kept below as written
  (`_parent_apply_sparse`);
* against the JAX package within tests/test_torch_dlrm_ftrl.py's
  tolerances: loss rtol 1e-4 a step; tables, dense parameters, z and n
  rtol 1e-4 / atol 1e-5 after step 3, the weights whose z lies within 1e-6
  of lambda1 left out and counted (`assert_ftrl_close`); key stores
  bitwise; the eval AUC within 1e-6.

`ftrl_rows_plain` is held against the JAX package's `_apply_rows` FTRL on
the unique rows, at the kernel's edges: count 0, count K, one row repeated
over the tiles' edges, ids at or past R inside the count, a bfloat16 table
with float32 state and bfloat16 state. Float32 state: w, z and n within
the module's tolerance (rtol 1e-4 / atol 1e-5: XLA fuses the formula and
rounds its products and sums at other places, and z = z + g - sigma w
cancels), the weights at the lambda1 edge left out; bfloat16 state or
table: one bfloat16 rounding more (rtol 2^-7), the edge 2^-7 lambda1 wide.
Its agreement with the earlier unique-row update is bitwise.

`step_mode` is "graph" for both FTRL models on a CUDA device (the device
faked here: the refusal reads the device's type, nothing of the card), and
frozen tables and Momentum are refused as before (Adam and SGD capture:
tests/test_torch_graph_samples.py).
"""
import contextlib

import numpy as np
import pytest
import torch

from hugectr_tpu_torch import ops
from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.core.types import Optimizer_t
from hugectr_tpu_torch.embedding import sparse_optimizer as so
from hugectr_tpu_torch.ops import row_scatter as rs
from hugectr_tpu_torch.optim.params import OptParams
from hugectr_tpu_torch.tools import flagship as tflagship
from hugectr_tpu_torch.tools.carry import load_jax_state

from test_torch_dlrm_ftrl import LAMBDA1, TOL, _sample_model
from test_torch_graph_step import _parent_segscan, _Refuse, _run
from test_torch_optimizers import assert_ftrl_close

torch.set_num_threads(1)

_APPLY_SPARSE = so.apply_sparse


def _parent_apply_sparse(opt, table, state, idx, src, dsrc, lr, dense_rows, dense_ratio, step=1, k_limit=0,
                         packed=False, ucap_drop=False, **kw):
    """The port's `apply_sparse` before FTRL's sorted route was counted:
    the valid prefix taken out on the host, gathered, summed, and its tails
    updated with `index_copy_` (`dedup_rows` and `_apply_rows` as they were
    written); the other routes as now."""
    rows = table.shape[0]
    route = so.update_route(rows, idx.shape[0], dense_rows, dense_ratio, opt.optimizer, kw.get("valid_cap", 0),
                            packed)
    if route != "sorted" or opt.optimizer != Optimizer_t.FTRL:
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
    _op, val, new = so.update_math(opt, table[uidx], old, g, lr, step)
    table.index_copy_(0, uidx, val.to(table.dtype))
    for k, v in new.items():
        state[k].index_copy_(0, uidx, v.to(state[k].dtype))
    return route


# ------------------------------------------------ the tiny model
@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_tiny_dlrm_ftrl_step_is_sync_free_and_matches_parent_and_jax(monkeypatch, dynamic):
    import jax

    jm = _sample_model(monkeypatch, dynamic)
    jstate = jax.device_get(jm.state)
    rm = ResourceManager.create(device="cpu")
    tm, parent = (tflagship.build_tiny_dlrm_ftrl(rm, dynamic=dynamic) for _ in range(2))
    for m in (tm, parent):
        load_jax_state(m, jstate)
    ops.reset_counts()
    losses, preds, state = _run(tm, _Refuse())
    counts, routes = ops.plain_counts(), list(tm.ec.group_routes.values())
    n_sorted = routes.count("sorted")
    assert (n_sorted > 0) != dynamic
    assert counts["ftrl_rows"] == counts["segscan"] == 3 * n_sorted and counts["adagrad_rows"] == 0
    assert counts["row_scatter"] == 3 * routes.count("dense") > 0
    # bitwise the earlier update's, on the same state and batches
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
    np.testing.assert_allclose(losses, jl, rtol=1e-4)
    js = jax.device_get(jm.state)
    for g, arr in js["emb_tables"].items():
        if g.endswith("#keys"):
            np.testing.assert_array_equal(tm.tables[g].numpy(), arr)
            continue
        assert_ftrl_close(tm.tables[g].numpy(), np.asarray(arr), np.asarray(js["eopt"][g]["z"]), LAMBDA1, TOL,
                          f"table {g}")
        for k in ("z", "n"):
            np.testing.assert_allclose(tm.eopt[g][k].numpy(), js["eopt"][g][k], **TOL, err_msg=f"{g} {k}")
    params = tm.network.param_tree()
    for layer, ps in js["dense_params"].items():
        for k, v in ps.items():
            assert_ftrl_close(params[layer][k].detach().numpy(), v, js["dopt"]["z"][layer][k], LAMBDA1, TOL,
                              f"{layer}/{k}")
    np.testing.assert_allclose(tm.eval()["auc"], jm.eval()["auc"], atol=1e-6)


def _on_a_card(monkeypatch, model):
    """`model` as `_graph_refusal` would see it on a CUDA device."""
    monkeypatch.setattr(model, "device", torch.device("cuda"))
    return model


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_dlrm_ftrl_captures_on_a_card(monkeypatch, dynamic):
    tm = tflagship.build_tiny_dlrm_ftrl(ResourceManager.create(device="cpu"), dynamic=dynamic)
    assert tm.step_mode == "eager: the cpu device"
    _on_a_card(monkeypatch, tm)
    assert tm.step_mode == "graph" and tm._graph_refusal(train=False) is None
    tm.freeze_embedding("0")
    assert tm.step_mode == "eager: frozen tables"
    tm.unfreeze_embedding()
    tm.freeze_embedding()
    assert tm.step_mode == "eager: frozen tables"


@pytest.mark.parametrize("kind", [Optimizer_t.Adam, Optimizer_t.SGD, Optimizer_t.MomentumSGD])
def test_other_optimizers_are_still_refused(monkeypatch, kind):
    """Momentum's sorted route still shapes its work by the batch; Adam
    (counted, its bias corrections on the device) and SGD (the drop-mode
    scatter into the table) capture since the samples do."""
    tm = tflagship.build_tiny_dlrm(ResourceManager.create(device="cpu"), optimizer=kind.value)
    _on_a_card(monkeypatch, tm)
    want = "graph" if kind in (Optimizer_t.Adam, Optimizer_t.SGD) else f"eager: the {kind.value} optimizer"
    assert tm.step_mode == want


def test_a_new_collection_is_captured_again():
    """`grow_dynamic_capacity` returns a new collection: the capture's key
    holds the old one, so the next step captures again."""
    tm = tflagship.build_tiny_dlrm_ftrl(ResourceManager.create(device="cpu"), dynamic=True)
    tm.start_data_reading()
    batch = tm._next_train_batch()
    key = tm._graph_key(batch)
    assert tm._graph_key(batch) == key
    tm.train_step(batch)  # fills the key stores
    tm.ec, tm.tables, tm.eopt = tm.ec.grow_dynamic_capacity(tm.tables, tm.eopt, "0", 400)
    assert tm._graph_key(batch) != key and tm._graph_key(batch)[0] is tm.ec


# ------------------------------------------------ the row update
FTRL = OptParams(optimizer=Optimizer_t.FTRL, lambda1=0.01, lambda2=0.01, ftrl_beta=0.5)


def _ftrl_list(rng, k, rows, pad, past=0):
    """Sorted ids of k entries: a negative id first, runs across the 32-id
    tiles' edges (28-36, 60-70) and one long run of one row (100-140),
    `past` ids at or past R inside the valid part, then `pad` sentinels."""
    ids = np.sort(rng.integers(0, rows, size=k - pad - past))
    ids[0] = -1
    for lo, hi in ((28, 37), (60, 71), (100, 141)):
        ids[lo:hi] = ids[lo]
    return torch.as_tensor(np.concatenate([ids, rows + np.arange(past), np.full(pad, rows + past)]))


def _ftrl_state(rng, rows, e, tdt, sdt):
    """A table near the lambda1 edge and state as a few steps leave it."""
    table = torch.as_tensor(rng.normal(size=(rows, e)).astype(np.float32) * 0.02).to(tdt)
    z = torch.as_tensor(rng.normal(size=(rows, e)).astype(np.float32) * 0.02).to(sdt)
    n = torch.as_tensor(rng.random((rows, e), dtype=np.float32) * 0.1).to(sdt)
    return table, z, n


def _expected_ftrl(table, z, n, sidx, g, count, lr):
    """The earlier unique-row update of the live tails (`_apply_rows`)."""
    rows = table.shape[0]
    live = rs._live_tails(sidx, torch.tensor(count), rows)
    uidx, gu = sidx[live], g[live]
    want = [x.clone() for x in (table, z, n)]
    so._apply_rows(FTRL, want[0], {"z": want[1], "n": want[2]}, lr, uidx, gu)
    return want, uidx, gu


DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("tdt,sdt", DTYPES, ids=["f32", "bf16_table", "bf16_state"])
@pytest.mark.parametrize("e", [1, 11, 16, 128])
def test_ftrl_rows_plain_is_the_unique_row_update(tdt, sdt, e):
    """Counts 0, a tile's edge (64, inside the run over 60-70), one past
    it, inside the long run (120), and the list's length K (the sentinels
    too): bitwise the earlier unique-row update; a bfloat16 lr for a
    bfloat16 table, as the collection gives it."""
    rng = np.random.default_rng(e)
    k, rows = 200, 300
    sidx = _ftrl_list(rng, k, rows, pad=20, past=5)
    g = torch.as_tensor(rng.normal(size=(k, e)).astype(np.float32) * 0.05)
    lr = torch.tensor(0.05, dtype=tdt)
    for count in (0, 64, 65, 120, k):
        table, z, n = _ftrl_state(rng, rows, e, tdt, sdt)
        (wt, wz, wn), uidx, _gu = _expected_ftrl(table, z, n, sidx, g, count, lr)
        before = table.clone()
        rs.ftrl_rows(FTRL, table, z, n, sidx, g, torch.tensor(count), lr)
        assert torch.equal(table, wt) and torch.equal(z, wz) and torch.equal(n, wn), count
        assert (uidx.numel() == 0) == (count == 0) and torch.equal(table, before) == (count == 0)


def test_ftrl_rows_checks_its_arguments():
    rng = np.random.default_rng(0)
    table, z, n = _ftrl_state(rng, 10, 4, torch.float32, torch.float32)
    sidx, g, count = torch.arange(5), torch.zeros(5, 4), torch.tensor(5)
    lr = torch.tensor(0.1)
    with pytest.raises(ValueError, match="not FTRL"):
        rs.ftrl_rows(OptParams(optimizer=Optimizer_t.AdaGrad), table, z, n, sidx, g, count, lr)
    with pytest.raises(ValueError, match="one type"):
        rs.ftrl_rows(FTRL, table, z, n.to(torch.bfloat16), sidx, g, count, lr)
    with pytest.raises(ValueError, match="0-dim int64"):
        rs.ftrl_rows(FTRL, table, z, n, sidx, g, torch.tensor([5]), lr)


@pytest.mark.parametrize("tdt,sdt", DTYPES, ids=["f32", "bf16_table", "bf16_state"])
@pytest.mark.parametrize("case", ["count_0", "count_k", "past_rows"])
def test_ftrl_rows_plain_is_jax_apply_rows(tdt, sdt, case):
    """The row update against the JAX package's `_apply_rows` FTRL in
    unique mode (sparse_optimizer.py:873-891) on the live tails' ids and
    sums, ids at or past R given to it as well (its scatters drop them, its
    gathers fill 0). The tolerances are the module's."""
    import jax
    import jax.numpy as jnp
    from hugectr_tpu.core.types import Optimizer_t as JOpt
    from hugectr_tpu.embedding import sparse_optimizer as jso
    from hugectr_tpu.optim.params import OptParams as JOptParams

    rng = np.random.default_rng(22)
    k, rows, e = 240, 180, 16
    sidx = _ftrl_list(rng, k, rows, pad=0 if case == "count_k" else 30, past=6 if case == "past_rows" else 0)
    sidx[0] = 0  # JAX wraps a negative index; the port drops it
    count = {"count_0": 0, "count_k": k, "past_rows": k - 30}[case]
    g = torch.as_tensor(rng.normal(size=(k, e)).astype(np.float32) * 0.05)
    table, z, n = _ftrl_state(rng, rows, e, tdt, sdt)
    lr = torch.tensor(0.05)
    _want, uidx, gu = _expected_ftrl(table, z, n, sidx, g, count, lr)
    live_past = (sidx >= rows) & (torch.arange(k) < count)
    ju = torch.cat([uidx, torch.unique(sidx[live_past])])
    jg = torch.cat([gu, torch.ones(ju.numel() - uidx.numel(), e)])
    jopt = JOptParams(optimizer=JOpt.FTRL, lambda1=FTRL.lambda1, lambda2=FTRL.lambda2, ftrl_beta=FTRL.ftrl_beta)

    def j(t):
        return jnp.asarray(t.float().numpy().copy()).astype(jnp.bfloat16 if t.dtype == torch.bfloat16
                                                             else jnp.float32)

    # JAX gets copies and is waited for (its work is asynchronous) before
    # the in-place update below
    with jax.default_device(jax.devices("cpu")[0]):
        jt, jst = jso._apply_rows(jopt, j(table), {"z": j(z), "n": j(n)}, jnp.float32(0.05), jnp.int32(1), True,
                                  jnp.asarray(ju.numpy().copy()), jnp.asarray(jg.numpy().copy()), None)
        jt, jst = jax.block_until_ready((jt, jst))
    before = table.clone()
    rs.ftrl_rows(FTRL, table, z, n, sidx, g, torch.tensor(count), lr)
    got = {"w": table, "z": z, "n": n}
    want = {"w": np.asarray(jt, np.float32), "z": np.asarray(jst["z"], np.float32),
            "n": np.asarray(jst["n"], np.float32)}
    stol = TOL if sdt == torch.float32 else dict(TOL, rtol=2.0**-7)
    for name in ("z", "n"):
        np.testing.assert_allclose(got[name].float().numpy(), want[name], **stol, err_msg=name)
    wtol = TOL if tdt == torch.float32 else dict(TOL, rtol=2.0**-7)
    band = 1e-6 if sdt == torch.float32 else 2.0**-7 * LAMBDA1
    assert_ftrl_close(got["w"].float().numpy(), want["w"], want["z"], LAMBDA1, wtol, "w", band)
    assert torch.equal(table, before) == (count == 0)
