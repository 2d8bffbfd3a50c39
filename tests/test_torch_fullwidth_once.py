"""The full-scale tool's code path at full width against the JAX package,
once: a script, not a test (it holds no pytest test, so the suite only
imports it; the run takes minutes of CPU).

    JAX_PLATFORMS=cpu python tests/test_torch_fullwidth_once.py [--vocab-cap 20000] [--batch 256] [--steps 2]

The port's `tools/fullscale_dryrun.py::run` on the CPU with bench.py's
settings (`bench_settings()`: ev 128, bottom 512/256/128, DCNv2 512 x 3, top
1024/1024/512/256/1, bf16 tables and row-wise AdaGrad state, mixed
precision, split 16,384, hot 131,072, superhot 1,024) at the flags' cap,
batch and steps, from the state of the JAX package's `build_dlrm_dcnv2`
under the same HCTR_TPU_* settings, on the same synthetic batches. Prints
one JSON line: both packages' losses, the largest difference of any table
element after the last step (and of the dense parameters), and the tables'
elements that differ.

`--f32-dense` runs the dense network in float32 in both packages (the
tables stay bf16), to tell the bf16 products' share of the differences.
`--sign-flips` adds the step-1 census of the table elements whose update
differs in sign between the packages. Row-wise AdaGrad's first step from a
zero accumulator moves an element by -lr x g / rms(row g), so its sign is
the gradient's. Per table, on the rows the batch touched: the elements
whose bf16 value moved in opposite directions in the two packages
(`opposite`), moved in one and not the other (`one_moved`), and, of the
opposite ones, those whose summed gradient g = sum of the cotangent rows
lies within one bf16 rounding of zero in either package
(`opposite_near_zero`): |g| <= 2^-8 x the sum, over the samples that
touched the row, of the largest |element| of the sample's cotangent row
(the network's bf16 products give a cotangent 8 bits at its row's scale,
so an element far below that scale has no reliable sign). Each package's cotangent is its own
(the JAX one from `jax.grad` of its step's loss, which the script checks
against its step-1 loss); both are summed in float32 here.

`--layer-probe` compares the mixed-precision dense network's forward and
backward point by point, from the same inputs (the step-1 batch and JAX's
embedding outputs on it) and the same parameters (JAX's step-0 state).
The points are the GEMMs in the order they run (the bottom MLP, the cross
layers' U and V products, the top MLP): each GEMM's bf16 operand (the cast
point after the previous bias, activation and cast), its float32 product
and that product's cotangent; the JAX side records them by wrapping the
`jnp.dot` of its `gemm` and `interaction` modules (a probe of zeros added to
the product gives the cotangent), the port by wrapping `_MatmulF32`. Both
run op by op. The samples whose embedding cotangents differ most are
followed point by point: the first point at which their forward differs
and by how many units in the last place (ulp) of bf16 and of float32, the
ReLU units that are zero in one package only, and the backward from the
loss down. JAX's jitted gradient is held against its op-by-op one on the
same inputs.
"""
import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
JAX_ENV = {
    "HCTR_TPU_EMB_DTYPE": "bfloat16", "HCTR_TPU_EMB_STATE_DTYPE": "bfloat16", "HCTR_TPU_SEGSUM": "xla",
    "HCTR_TPU_UCAP_FACTOR": "0", "HCTR_TPU_HOT_ROWS": "131072", "HCTR_TPU_SUPERHOT_ROWS": "1024",
    "HCTR_TPU_SPLIT_VOCAB": "16384", "HCTR_TPU_ONEHOT_VOCAB": "8192", "HCTR_TPU_AUC_EXACT_MAX": "1048576",
    "HCTR_TPU_DENSE_UPDATE_ROWS": "262144", "HCTR_TPU_DENSE_KEY_RATIO": "0.3", "HCTR_BENCH_OPT": "rowwise_adagrad",
}


def main():
    p = argparse.ArgumentParser("test_torch_fullwidth_once")
    p.add_argument("--vocab-cap", type=int, default=20000)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--sign-flips", action="store_true")
    p.add_argument("--f32-dense", action="store_true", help="the dense network in float32 (no mixed precision)")
    p.add_argument("--layer-probe", action="store_true", help="the dense network's forward and backward point by point")
    a = p.parse_args()
    os.environ.update(JAX_ENV)
    import jax
    import numpy as np

    import hugectr_tpu as jh
    from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
    from hugectr_tpu.tools import flagship as jflagship
    from hugectr_tpu_torch.tools import fullscale_dryrun
    from hugectr_tpu_torch.tools.carry import load_jax_state

    reader = jh.DataReaderParams(data_reader_type="synthetic", synthetic_num_batches=max(a.steps, 2),
                                 synthetic_alpha=1.05)
    jm = jflagship.build_dlrm_dcnv2(JaxResourceManager.create(num_devices=1), batchsize=a.batch,
                                    vocab_cap=a.vocab_cap, use_mixed_precision=not a.f32_dense, reader=reader,
                                    max_eval_batches=1)

    seen = {}
    # a copy: the JAX step donates its state, and device_get may alias it
    state0 = jax.tree_util.tree_map(lambda x: np.array(x, copy=True), jax.device_get(jm.state)) \
        if a.sign_flips or a.layer_probe else None

    def carry(model, i):
        if i == 1:
            load_jax_state(model, jax.device_get(jm.state))
            if a.sign_flips or a.layer_probe:
                capture_step1(model, seen)
        if i == 2 and a.sign_flips:
            seen["port_tables"] = touched_tables(model.ec, model.tables, seen)

    argv = ["--vocab-cap", str(a.vocab_cap), "--batch", str(a.batch), "--steps", str(a.steps), "--device", "cpu"]
    tm, rec = fullscale_dryrun.run(argv, overrides=dict(use_mixed_precision=False) if a.f32_dense else None,
                                   step_hook=carry, say=lambda *x, **k: None)
    flips = probe = None
    if a.layer_probe:
        load_jax_state(tm, state0)
        probe, relu_samples, probe_d = layer_probe(jm, tm, seen["batch"])
    if a.sign_flips:
        import torch

        jd, jloss = jax_cotangents(jm, seen["batch"])
        jl = [float(jm.train())]
        # the port's update from JAX's own cotangents, from the step-0 state
        load_jax_state(tm, state0)
        tm.ec.backward_and_update(tm.tables, tm.eopt, {k: torch.from_numpy(v) for k, v in seen["keys"].items()},
                                  {k: torch.from_numpy(v).to(seen["d_dtype"]) for k, v in jd.items()},
                                  torch.tensor(float(tm.lr_sch(1))), 1)
        seen["port_jax_d_tables"] = touched_tables(tm.ec, tm.tables, seen)
        flips = sign_flips(jm, state0, jax.device_get(jm.state), seen, jd,
                           relu_samples if a.layer_probe else None)
        if a.layer_probe:  # the probe's port cotangents against the step's own
            probe["port_cotangent_vs_step_max_abs"] = max(float(np.abs(probe_d[k] - seen["d"][k]).max())
                                                          for k in seen["d"])
        flips["jax_grad_loss_vs_step1"] = [jloss, jl[0]]
        jl += [float(jm.train()) for _ in range(a.steps - 1)]
    else:
        jl = [float(jm.train()) for _ in range(a.steps)]
    state = jax.device_get(jm.state)
    worst, differ, total = 0.0, 0, 0
    for g, arr in state["emb_tables"].items():
        want = np.asarray(arr).astype(np.float32)
        got = tm.tables[g].float().numpy()
        d = np.abs(got - want)
        worst = max(worst, float(d.max()))
        differ += int((d > 0).sum())
        total += d.size
    params = tm.network.param_tree()
    dense = max(float(np.abs(params[layer][k].detach().float().numpy() - np.asarray(v, np.float32)).max())
                for layer, ps in state["dense_params"].items() for k, v in ps.items())
    print(json.dumps(dict(command=" ".join(sys.argv), port_losses=rec["losses"], jax_losses=jl,
                          loss_rel_diff=[abs(t - j) / abs(j) for t, j in zip(rec["losses"], jl)],
                          max_table_abs_diff=worst, table_elements_differing=differ, table_elements=total,
                          max_dense_abs_diff=dense, routes=rec["routes"], sign_flips=flips, layer_probe=probe)))


def capture_step1(model, seen):
    """Keep the port's first train batch, lookup keys and cotangents."""
    step, bwd = model.train_step, model.ec.backward_and_update

    def train_step(batch):
        seen.setdefault("batch", {k: v.detach().cpu().numpy() for k, v in batch.items()})
        return step(batch)

    def backward_and_update(tables, state, keys, d_outs, *rest, **kw):
        if "keys" not in seen:
            seen["keys"] = {k: v.cpu().numpy() for k, v in keys.items()}
            seen["d"] = {k: v.float().cpu().numpy() for k, v in d_outs.items()}
            seen["d_dtype"] = next(iter(d_outs.values())).dtype
            seen["tables"] = [lk.table.name for lk in model.ec.plan.lookups]
            seen["tops"] = {lk.table.name: (lk.top_name, lk.table.vocabulary_size) for lk in model.ec.plan.lookups}
        return bwd(tables, state, keys, d_outs, *rest, **kw)

    model.train_step, model.ec.backward_and_update = train_step, backward_and_update


def jax_cotangents(jm, batch):
    """The JAX step's cotangents of the lookup tops on `batch` (its loss
    function, model.py:834-859, under jax.grad) and its loss."""
    import jax
    import jax.numpy as jnp

    from hugectr_tpu.layers.base import LayerCtx

    state = jm.state
    b = jm._decode_batch({k: jnp.asarray(v) for k, v in batch.items()})
    emb = jm.ec.forward(state["emb_tables"], jm._feature_keys(b), feature_weights=jm._feature_weights(b))

    def loss_fn(emb_in):
        tensors = {n: b[n] for n in (*jm.batch_spec.label_names, jm.batch_spec.dense_name)}
        tensors.update(jm._user_tensors(emb_in))
        ctx = LayerCtx(training=True, compute_dtype=jm.solver.compute_dtype, rng=jax.random.key(0))
        loss, _ = jm.network.forward_with_loss(state["dense_params"], state["net_state"], tensors, ctx)
        return loss

    loss, d = jax.value_and_grad(loss_fn)(emb)
    return {k: np.asarray(v, np.float32) for k, v in d.items()}, float(loss)


def _ulp(x, mant):
    """One unit in the last place at |x| for a float of `mant` stored
    mantissa bits (bf16 7, float32 23); the smallest normal's below it."""
    e = np.floor(np.log2(np.maximum(np.abs(x).astype(np.float64), 2.0**-126)))
    return 2.0 ** (e - mant)


def _gaps(port, jax_):
    """Per sample: (elements apart, the largest gap in bf16 ulps of the
    larger of the two values, the largest gap over the sample's largest
    |JAX value|)."""
    p = np.asarray(port, np.float64).reshape(port.shape[0], -1)
    j = np.asarray(jax_, np.float64).reshape(jax_.shape[0], -1)
    d = np.abs(p - j)
    return ((d > 0).sum(1), (d / _ulp(np.maximum(np.abs(p), np.abs(j)), 7)).max(1),
            d.max(1) / np.maximum(np.abs(j).max(1), 1e-30))


def layer_probe(jm, tm, batch, worst=2):
    """--layer-probe: see the module's docstring."""
    import jax
    import jax.numpy as jnp
    import torch

    from hugectr_tpu.layers import gemm as jgemm
    from hugectr_tpu.layers import interaction as jinter
    from hugectr_tpu.layers.base import LayerCtx
    from hugectr_tpu_torch.layers import gemm as tgemm

    # --- JAX, op by op: every GEMM's bf16 operand and float32 product
    rec = dict(eps=None, i=0, xs=[], ys=[])

    class Dot:  # the modules' `jnp`, with `dot` recording
        def __getattr__(self, name):
            return getattr(jnp, name)

        def dot(self, a, b, **kw):
            out = jnp.dot(a, b, **kw)
            if rec["eps"] is not None:
                out = out + rec["eps"][rec["i"]]
            rec["i"] += 1
            rec["xs"].append(a)
            rec["ys"].append(out)
            return out

    state = jm.state
    b = jm._decode_batch({k: jnp.asarray(v) for k, v in batch.items()})
    emb = jm.ec.forward(state["emb_tables"], jm._feature_keys(b), feature_weights=jm._feature_weights(b))

    def loss_fn(emb_in, eps):
        rec.update(eps=eps, i=0, xs=[], ys=[])
        tensors = {n: b[n] for n in (*jm.batch_spec.label_names, jm.batch_spec.dense_name)}
        tensors.update(jm._user_tensors(emb_in))
        ctx = LayerCtx(training=True, compute_dtype=jm.solver.compute_dtype, rng=jax.random.key(0))
        loss, (out, _) = jm.network.forward_with_loss(state["dense_params"], state["net_state"], tensors, ctx)
        return loss, (list(rec["xs"]), list(rec["ys"]), out)

    saved = jgemm.jnp, jinter.jnp
    jgemm.jnp = jinter.jnp = Dot()
    try:
        _, (_, ys0, _) = loss_fn(emb, None)
        eps0 = [jnp.zeros_like(y) for y in ys0]
        (jloss, (jxs, jys, jout)), (jd_emb, jd_y) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(emb, eps0)
    finally:
        jgemm.jnp, jinter.jnp = saved
        rec["eps"] = None

    def jit_loss(emb_in):
        tensors = {n: b[n] for n in (*jm.batch_spec.label_names, jm.batch_spec.dense_name)}
        tensors.update(jm._user_tensors(emb_in))
        ctx = LayerCtx(training=True, compute_dtype=jm.solver.compute_dtype, rng=jax.random.key(0))
        return jm.network.forward_with_loss(state["dense_params"], state["net_state"], tensors, ctx)[0]

    jit_loss_v, jit_d_emb = jax.jit(jax.value_and_grad(jit_loss))(emb)

    def f32(x):
        return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)

    # --- the port, op by op, from the same embedding outputs; with
    # `substitute`, each GEMM's product is replaced by JAX's value (its
    # gradient kept), which leaves only the cast points to differ
    apply = tgemm._MatmulF32.apply
    tb = tm._decode_batch({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})

    def port_pass(substitute):
        txs, tys = [], []

        def recording(a, w):
            y = apply(a, w)
            if substitute:
                y = y + (torch.from_numpy(f32(jys[len(tys)])) - y).detach()
            y.retain_grad()
            txs.append(a)
            tys.append(y)
            return y

        t_emb = {k: torch.from_numpy(np.asarray(v, np.float32)).to(getattr(torch, str(v.dtype))).requires_grad_(True)
                 for k, v in emb.items()}
        tensors = {n: tb[n] for n in (*tm.batch_spec.label_names, tm.batch_spec.dense_name)}
        tensors.update(tm._user_tensors(t_emb))
        tm.network.train()
        tgemm._MatmulF32.apply = recording
        try:
            loss, out = tm.network.forward_with_loss(tensors, tm.solver.compute_dtype)
        finally:
            tgemm._MatmulF32.apply = apply
        loss.backward()
        tm.network.zero_grad(set_to_none=True)
        return txs, tys, t_emb, loss, out

    txs, tys, t_emb, tloss, _ = port_pass(False)

    tops = sorted(emb)
    dp = np.concatenate([f32(t_emb[k].grad) for k in tops], 1)
    dj = np.concatenate([f32(jd_emb[k]) for k in tops], 1)
    djit = np.concatenate([f32(jit_d_emb[k]) for k in tops], 1)
    scale = np.abs(dj).max(1)
    gap = np.abs(dp - dj).max(1) / np.maximum(scale, 1e-30)
    n = len(jys)
    assert len(tys) == n and all(tuple(t.shape) == tuple(j.shape) for t, j in zip(tys, jys)), "GEMM points differ"
    operand = [_gaps(f32(txs[k]), f32(jxs[k])) for k in range(n)]
    product = [_gaps(f32(tys[k]), f32(jys[k])) for k in range(n)]
    cotangent = [_gaps(f32(tys[k].grad), f32(jd_y[k])) for k in range(n)]
    relu = [((f32(txs[k]) == 0) != (f32(jxs[k]) == 0)).reshape(len(gap), -1).sum(1) for k in range(n)]
    samples = []
    for s_ in range(len(gap)):
        row = dict(sample=s_, emb_cotangent_gap_over_scale=float(gap[s_]),
                   products_f32_gap_over_scale_max=max(float(product[k][2][s_]) for k in range(n)))
        first = next((k for k in range(n) if operand[k][0][s_]), None)
        if first is not None:
            row["first_operand_apart"] = dict(gemm=first, elements=int(operand[first][0][s_]),
                                              bf16_ulps=float(operand[first][1][s_]),
                                              upstream_product_gap_over_scale=float(product[first - 1][2][s_]))
        row["relu_zero_in_one"] = {k: int(relu[k][s_]) for k in range(n) if relu[k][s_]}
        top = next((k for k in reversed(range(n)) if cotangent[k][0][s_]), None)
        if top is not None:
            row["top_cotangent_apart"] = dict(gemm=top, elements=int(cotangent[top][0][s_]),
                                              gap_over_scale=float(cotangent[top][2][s_]),
                                              relu_zero_in_one_on_its_output=int(relu[top + 1][s_]) if top + 1 < n else 0)
        samples.append(row)
    moved = [r for r in samples if r["emb_cotangent_gap_over_scale"] > 0]
    # the first operand gap largest in bf16 ulps: the element and the
    # upstream GEMM's float32 products at its index
    firsts = [r for r in moved if "first_operand_apart" in r]
    widest = max(firsts, key=lambda r: r["first_operand_apart"]["bf16_ulps"], default=None)
    if widest is not None:
        s_, k = widest["sample"], widest["first_operand_apart"]["gemm"]
        xp, xj = f32(txs[k])[s_], f32(jxs[k])[s_]
        i = int(np.argmax(np.abs(xp.astype(np.float64) - xj)))
        widest = dict(sample=s_, gemm=k, element=i, port=float(xp[i]), jax=float(xj[i]))
        if k and jys[k - 1].shape[1] == xp.size:
            widest.update(upstream_product_port=float(f32(tys[k - 1])[s_, i]),
                          upstream_product_jax=float(f32(jys[k - 1])[s_, i]))
    sx, sy, s_emb, sloss, sout = port_pass(True)
    net_tops = [t for cfg in tm.network.configs for t in cfg.top_names]
    ds = np.concatenate([f32(s_emb[k].grad) for k in tops], 1)
    sgap = np.abs(ds - dj).max(1) / np.maximum(scale, 1e-30)
    substituted = dict(
        operands_bitwise=all(np.array_equal(f32(sx[k]), f32(jxs[k])) for k in range(n)),
        layer_outputs_apart={t: float(np.abs(f32(sout[t]) - f32(jout[t])).max()) for t in net_tops
                             if not np.array_equal(f32(sout[t]), f32(jout[t]))},
        loss_rel_diff=abs(float(sloss) - float(jloss)) / abs(float(jloss)),
        relu_zero_in_one=int(sum(((f32(sx[k]) == 0) != (f32(jxs[k]) == 0)).sum() for k in range(n))),
        emb_cotangent_bitwise=int((sgap == 0).sum()), emb_cotangent_gap_over_scale_max=float(sgap.max()),
        product_cotangent_gap_over_scale_max=max(float(_gaps(f32(sy[k].grad), f32(jd_y[k]))[2].max())
                                                 for k in range(n)))
    relu_origin = [r for r in moved if r.get("top_cotangent_apart", {}).get("relu_zero_in_one_on_its_output")]
    summary = dict(batch=len(gap), gemms=[list(t.shape) for t in tys],
                loss_port=float(tloss), loss_jax=float(jloss), loss_jax_jit=float(jit_loss_v),
                jit_vs_op_by_op_emb_cotangent_max_over_scale=float(
                    (np.abs(djit - dj).max(1) / np.maximum(scale, 1e-30)).max()),
                emb_cotangent_bitwise=len(gap) - len(moved),
                first_operand_gap_widest=widest,
                products_before_first_operand_gap_over_scale_max=max(
                    (r["first_operand_apart"]["upstream_product_gap_over_scale"] for r in moved
                     if "first_operand_apart" in r), default=0.0),
                with_relu_zero_in_one=sum(1 for r in moved if r["relu_zero_in_one"]),
                relu_origin=dict(samples=len(relu_origin),
                                 gap_over_scale_min=min((r["emb_cotangent_gap_over_scale"] for r in relu_origin),
                                                        default=None)),
                no_relu_gap_over_scale_max=max((r["emb_cotangent_gap_over_scale"] for r in moved
                                                if not r["relu_zero_in_one"]), default=0.0),
                substituted_products=substituted, worst=[samples[i] for i in np.argsort(-gap)[:worst]])
    return summary, {r["sample"] for r in relu_origin}, {k: f32(t_emb[k].grad) for k in tops}


def touched(seen, name):
    """(touched rows, each valid key's index into them, each valid key's
    sample, the lookup's top) of table `name` in the step-1 batch."""
    top, vocab = seen["tops"][name]
    keys = seen["keys"][top].astype(np.int64)
    valid = keys != -1
    rows, inv = np.unique(np.mod(keys[valid], vocab), return_inverse=True)
    return rows, inv, np.nonzero(valid)[0], top


def touched_tables(ec, tables, seen):
    """Each table's touched rows as float32 (one table exported at a time)."""
    return {n: np.asarray(ec.export_table(tables, n), np.float32)[touched(seen, n)[0]] for n in seen["tables"]}


def sign_flips(jm, state0, state1, seen, jd, relu_samples=None):
    """The census of --sign-flips, summed over the tables. `band`: the
    largest |port - JAX| cotangent element over its row's largest |element|,
    the two packages' measured rounding gap; `opposite_within_band`: the
    opposite elements with |g| <= band x the row scale in either package.
    `port_update_from_jax_cotangents_opposite`: the elements that move
    against JAX's when the port's update takes JAX's cotangents (recomputed
    op by op outside the jitted step: the same loss, but a few elements'
    last bits can differ from the step's own), with the largest |g| over
    its row scale among them: below 2^-8, every flip comes from the
    cotangents. With `relu_samples` (--layer-probe's samples whose
    cotangent gap starts at a ReLU unit zero in one package only):
    `opposite_clear_on_relu_sample_rows`, the opposite elements not near
    zero on a row that such a sample touched."""
    out = dict(rows_touched=0, elements=0, moved_port=0, moved_jax=0, opposite=0, one_moved=0,
               opposite_near_zero=0, one_moved_near_zero=0, worst_opposite_g_over_scale=0.0, band=0.0,
               opposite_within_band=0, port_update_from_jax_cotangents_opposite=0, opposite_clear=0,
               opposite_clear_on_relu_sample_rows=0)
    for top in seen["d"]:
        dp, dj = seen["d"][top], jd[top]
        out["band"] = max(out["band"], float((np.abs(dp - dj) / np.maximum(np.abs(dp).max(axis=1, keepdims=True),
                                                                            1e-30)).max()))
    for name in seen["tables"]:
        rows, inv, src, top = touched(seen, name)
        before = np.asarray(jm.ec.export_table(state0["emb_tables"], name), np.float32)[rows]
        port = seen["port_tables"][name] - before
        jax_ = np.asarray(jm.ec.export_table(state1["emb_tables"], name), np.float32)[rows] - before
        mixed = seen["port_jax_d_tables"][name] - before
        e = before.shape[1]

        def summed(d):
            g = np.zeros((rows.size, e), np.float64)
            np.add.at(g, inv, d[src].astype(np.float64))
            return g

        dp = seen["d"][top]
        gp, gj = summed(dp), summed(jd[top])
        scale = summed(np.broadcast_to(np.abs(dp).max(axis=1, keepdims=True), dp.shape))
        sp, sj = np.sign(port), np.sign(jax_)
        opp = (sp * sj) < 0
        one = (sp == 0) != (sj == 0)
        small = np.minimum(np.abs(gp), np.abs(gj))
        near = small <= 2.0**-8 * scale
        out["rows_touched"] += int(rows.size)
        out["elements"] += int(port.size)
        out["moved_port"] += int((sp != 0).sum())
        out["moved_jax"] += int((sj != 0).sum())
        out["opposite"] += int(opp.sum())
        out["one_moved"] += int(one.sum())
        out["opposite_near_zero"] += int((opp & near).sum())
        out["one_moved_near_zero"] += int((one & near).sum())
        out["opposite_clear"] += int((opp & ~near).sum())
        if relu_samples is not None:
            hit = np.zeros(rows.size, bool)
            hit[inv[np.isin(src, sorted(relu_samples))]] = True
            out["opposite_clear_on_relu_sample_rows"] += int((opp & ~near & hit[:, None]).sum())
        mopp = (np.sign(mixed) * sj) < 0
        out["port_update_from_jax_cotangents_opposite"] += int(mopp.sum())
        if mopp.any():  # their JAX gradient over its row scale
            scale_j = summed(np.broadcast_to(np.abs(jd[top]).max(axis=1, keepdims=True), dp.shape))
            rel = np.abs(gj[mopp]) / np.maximum(scale_j[mopp], 1e-30)
            out["port_update_from_jax_cotangents_worst_g_over_scale"] = max(
                out.get("port_update_from_jax_cotangents_worst_g_over_scale", 0.0), float(rel.max()))
        if opp.any():
            out["worst_opposite_g_over_scale"] = max(out["worst_opposite_g_over_scale"],
                                                     float((small[opp] / np.maximum(scale[opp], 1e-30)).max()))
        out["_small_over_scale"] = out.get("_small_over_scale", []) + list((small[opp] / np.maximum(scale[opp], 1e-30)))
    ratios = np.asarray(out.pop("_small_over_scale"))
    out["opposite_within_band"] = int((ratios <= out["band"]).sum())
    return out


if __name__ == "__main__":
    main()
