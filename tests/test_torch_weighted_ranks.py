"""Weighted lookups over W = 2 ranks: the port's spawned gloo group against
the JAX package's 2-device CPU mesh (tests/test_weighted_lookup.py's lookups,
`tests/torch_rank_fns.py::CASES` "weighted*"), two steps each. The cases
and tolerances are described in tests/test_torch_weighted.py, whose
one-device cases this file's share."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_fns as fns
from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.core.types import Combiner_t as JComb
from hugectr_tpu.core.types import Optimizer_t as JOpt
from hugectr_tpu.embedding.collection import EmbeddingCollection as JEC
from hugectr_tpu.optim.params import OptParams as JOptParams
from hugectr_tpu.parallel import plan as jplan

from hugectr_tpu_torch.tools import hybrid

torch.set_num_threads(1)
FWD_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_ULP = 2.0**-7
BF16_TOL = dict(rtol=BF16_ULP, atol=BF16_ULP * 0.1)

# ------------------------------------------------------------ W = 2, gloo
W2_CASES = {"w2_weighted_sorted": ("adagrad", "weighted"), "w2_weighted_bf16": ("rowwise_adagrad", "weighted_bf16"),
            "w2_weighted_onehot": ("sgd", "weighted_onehot"), "w2_weighted_dx64": ("adagrad", "weighted_dx64")}
STEPS, LR = 2, 0.3


def _w2_inputs(name):
    optimizer, case = W2_CASES[name]
    return fns.ec_inputs(optimizer, fns.CASES[case]["batch"], STEPS, LR, case)


@pytest.fixture(scope="module")
def port_w2():
    inputs = {"ec": {n: _w2_inputs(n) for n in W2_CASES}, "calls": json.dumps({"ec": "collection_cases"})}
    return hybrid.run(fns.several, 2, inputs, device="cpu")


def _jax_w2(name):
    optimizer, case = W2_CASES[name]
    c = fns.CASES[case]
    inputs = _w2_inputs(name)
    with pytest.MonkeyPatch.context() as mp:
        for k in ("HCTR_TPU_FWD_PARTITION", "HCTR_TPU_MP_CAPACITY_FACTOR", "HCTR_TPU_DENSE_EXCHANGE",
                  "HCTR_TPU_DENSE_EXCHANGE_CAP", "HCTR_TPU_EMB_STATE_DTYPE"):
            mp.delenv(k, raising=False)
        for k, v in c["env"].items():
            mp.setenv(k, v)
        pl = jplan.compile_plan(fns.ec_lookups(jplan, JComb, case), jplan.ShardingPlan(c["strategy"]), 2)
        dt = jnp.bfloat16 if c["dtype"] == "bfloat16" else jnp.float32
        jec = JEC(pl, JaxResourceManager.create(num_devices=2), JOptParams(JOpt(optimizer), **fns.OPT_HYPER), dtype=dt)
        jt = jec.init(jax.random.key(0))
        for t, values in inputs["tables"].items():
            jt = jec.import_table(jt, t, values)
        js = jec.init_optimizer(jt)
        fwd, bwd = jax.jit(jec.forward), jax.jit(jec.backward_and_update)
        outs = {}
        for step in range(1, STEPS + 1):
            outs[str(step)] = {k: np.asarray(v.astype(jnp.float32))
                               for k, v in fwd(jt, inputs["keys"], inputs["w"]).items()}
            d = {k: jnp.asarray(v, dt) for k, v in inputs["d"][str(step)].items()}
            jt, js = bwd(jt, js, inputs["keys"], d, jnp.asarray(LR), jnp.asarray(step), inputs["w"])
        tables = {t: np.asarray(jec.export_table(jt, t)).astype(np.float32) for t in inputs["tables"]}
        dense_ex = [g.name for g in pl.groups if jec._dense_exchange_ok(g)]
    return outs, tables, dense_ex


@pytest.mark.parametrize("name", list(W2_CASES))
def test_weighted_two_ranks_match_jax(port_w2, name):
    """W = 2 (one spawned gloo group) against JAX's 2-device mesh, two steps
    each: the weighted model-parallel groups' owner-partitioned forward (the
    ordered pool's weighted plain version), the sorted update of per-key
    gradient rows; bf16 tables (outputs bitwise); the replicated one-hot
    group's weighted kernels with the gradient and Σ|w| all-reduced; the
    unique-key dense exchange of weighted Concat lookups (`all_to_all`
    counted). Both ranks' outputs together are the global batch's."""
    _opt, case = W2_CASES[name]
    ranks = [r["ec"][name] for r in port_w2]
    outs, tables, dense_ex = _jax_w2(name)
    bf16 = fns.CASES[case]["dtype"] == "bfloat16"
    for step, jout in outs.items():
        for k, want in jout.items():
            got = np.concatenate([r["fwd"][step][k] for r in ranks])
            if bf16 and step == "1":
                np.testing.assert_array_equal(got, want, err_msg=f"{name} step {step} {k}")
            else:
                np.testing.assert_allclose(got, want, **(BF16_TOL if bf16 else (FWD_TOL if step == "1" else TOL)),
                                           err_msg=f"{name} step {step} {k}")
    for t, want in tables.items():
        for r in ranks:
            np.testing.assert_allclose(r["tables"][t], want, **(BF16_TOL if bf16 else TOL), err_msg=f"{name} {t}")
    if dense_ex:
        assert all(r["collective_calls"].get("all_to_all", 0) > 0 for r in ranks)
    else:
        assert all(r["collective_calls"].get("all_to_all", 0) == 0 for r in ranks)
