"""The tiny bench-configured DLRM-DCNv2 at W 2 as one program on each rank,
on the CPU: its step body and eval forward (`Model._train_body`,
`Model._eval_step`) and the collection's passes under
`torch_rank_fns._Refuse` (no host read, no shape that follows the data;
`torch_rank_fns.refused_ranks`) on a spawned gloo group of 2, held against
the JAX Model on a 2-device CPU mesh from the same state by
tests/test_torch_hybrid_models.py's check, at its tolerances (step 1 loss
rtol 1e-5, steps 2-3 rtol 5e-3, each rank's storage after step 1 within
one bf16 ulp at the tables' scale, AUC within 0.01, the carried weights'
eval AUC within 1e-6, replicas bitwise across the ranks). The other
configurations over ranks: tests/test_torch_graph_ranks.py.
"""
import json

import pytest
import torch

import test_torch_hybrid_models as thm
import torch_rank_fns as fns
from hugectr_tpu_torch.tools import hybrid

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_bench():
    return thm._jax_bench_model()


@pytest.fixture(scope="module")
def refused_bench(jax_bench):
    """The bench model's runs of tests/test_torch_hybrid_models.py (one
    step with its storage; three steps, an eval, and an eval of JAX's
    weights after three steps) under `refused_ranks`."""
    bench = dict(builder="build_dlrm_dcnv2", kwargs=thm.MASKED_KW, eval=True, export=False)
    inputs = {
        "bench1": {"config": json.dumps(dict(bench, steps=1, eval=False, storage=True)),
                   "state": thm._state_tree(jax_bench["state"])},
        "bench3": {"config": json.dumps(dict(bench, steps=3)), "state": thm._state_tree(jax_bench["state"]),
                   "eval_state": thm._state_tree(jax_bench["state3"])},
        "calls": json.dumps({"bench1": "train_model", "bench3": "train_model"}),
    }
    return hybrid.run(fns.refused_ranks, 2, inputs, device="cpu")


def test_bench_model_under_refuse_matches_jax(refused_bench, jax_bench):
    for res in refused_bench:
        assert res["refused"]["_train_body"] == 4 and res["refused"]["_eval_step"] > 0
    port = {k: [r[k] for r in refused_bench] for k in ("bench1", "bench3")}
    thm.test_bench_model_on_two_ranks_matches_jax(port, {"bench": jax_bench})
