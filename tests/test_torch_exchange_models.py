"""The tiny bench-configured DLRM-DCNv2 at W = 2 ranks against the JAX Model
on a 2-device CPU mesh from the JAX model's carried state, both packages at
their default forward: the owner-partitioned one (JAX's
HCTR_TPU_FWD_PARTITION unset; the port's `Solver.fwd_partition`), which
pools each slot's owned bf16 rows in ascending row order with a rounding
after every add. The port's ranks are one spawned gloo group
(`tools/hybrid.py::train_model`); JAX runs in this process.
(tests/test_torch_hybrid_models.py holds the same model with both packages
on the masked gather.)

Step 1's loss within 1e-7 of JAX's (absolute); steps 2-3 rtol 5e-3 and
each rank's storage after step 1 within one bf16 ulp at the tables' scale
(rtol 2^-7, atol 2^-8), tests/test_torch_bench.py's tolerances; the
ordered pool's plain version ran once a step for each model-parallel
group.
"""
import json

import numpy as np
import pytest
import torch

import torch_rank_fns as fns
from hugectr_tpu_torch.tools import hybrid

from test_torch_hybrid_models import BENCH_KW, BF16_ULP, _jax_bench_model, _state_tree

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    """JAX's run at its default and the port's ranks (one step with their
    storage; three steps) from JAX's initial state."""
    jb = _jax_bench_model(fwd_partition=None)
    bench = dict(builder="build_dlrm_dcnv2", kwargs=BENCH_KW, eval=False, export=False)
    inputs = {
        "bench1": {"config": json.dumps(dict(bench, steps=1, storage=True)), "state": _state_tree(jb["state"])},
        "bench3": {"config": json.dumps(dict(bench, steps=3)), "state": _state_tree(jb["state"])},
        "calls": json.dumps({"bench1": "train_model", "bench3": "train_model"}),
    }
    res = hybrid.run(fns.several, 2, inputs, device="cpu")
    return jb, {k: [r[k] for r in res] for k in ("bench1", "bench3")}


def test_bench_model_default_forward_matches_jax(runs):
    jb, port = runs
    mp_groups = [g for g in jb["plan"].groups if g.is_model_parallel and g.compute_kind == "rowop"]
    assert mp_groups
    for r, (one, three) in enumerate(zip(port["bench1"], port["bench3"])):
        assert abs(one["losses"][0] - jb["losses"][0]) <= 1e-7, (r, one["losses"][0], jb["losses"][0])
        np.testing.assert_allclose(three["losses"], jb["losses"], rtol=5e-3, err_msg=f"rank {r}")
        for g in jb["plan"].groups:
            got = one["storage"][g.name]
            want = jb["state1"]["emb_tables"][g.name]
            if g.is_model_parallel:
                want = want[r * got.shape[0] : (r + 1) * got.shape[0]]
            np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=2.0**-8, err_msg=f"rank {r} {g.name}")
        assert three["plain_calls"]["ordered_pool"] == 3 * len(mp_groups)
