"""DIN and MMoE at W = 2 ranks against the JAX package's 2-device CPU mesh
from the JAX model's carried state: DIN's PReLU_Dice takes its mean and
variance over the global batch (an all-reduce whose backward is global
too), and MMoE reports each task's AUC over the global eval set. The port's
ranks are one spawned gloo group (`tools/hybrid.py::train_model` with
`tools/samples.py::build_tiny_sample`); JAX runs in this process
(`test_torch_samples.py::jax_sample` with `--num_devices 2`).

Tolerances: those of tests/test_torch_samples.py, on each rank's rows of
the model-parallel tables and on the replicated dense parameters; every
replicated array bitwise equal across the ranks.
"""
import json

import numpy as np
import pytest
import torch

import torch_rank_fns as fns
from hugectr_tpu_torch.tools import hybrid

from test_torch_samples import assert_eval_close, assert_state_close, host_state, jax_sample

torch.set_num_threads(1)


def _jax_run(name, variant=None):
    """The JAX sample on a 2-device mesh: initial state, losses, final
    state, eval."""
    with pytest.MonkeyPatch.context() as mp:
        jm = jax_sample(mp, name, variant, num_devices=2)
        s0 = host_state(jm)
        losses = [jm.train() for _ in range(3)]
        return dict(state=s0, losses=losses, state3=host_state(jm), eval=jm.eval())


@pytest.fixture(scope="module")
def w2():
    """DIN and MMoE at W = 2 in one spawned group, each from its JAX
    model's carried state; JAX runs in this process."""
    jax_runs = {"din": _jax_run("din"), "mmoe": _jax_run("mmoe")}
    inputs = {"calls": json.dumps({k: "train_model" for k in jax_runs})}
    for k, j in jax_runs.items():
        cfg = dict(module="samples", builder="build_tiny_sample", kwargs=dict(name=k), steps=3, eval=True,
                   storage=True, export=False)
        inputs[k] = {"config": json.dumps(cfg), "state": j["state"]}
    ranks = hybrid.run(fns.several, 2, inputs, device="cpu")
    return jax_runs, ranks


@pytest.mark.parametrize("name", ["din", "mmoe"])
def test_sample_on_two_ranks_matches_jax_mesh(w2, name):
    jax_runs, ranks = w2
    j = jax_runs[name]
    s3 = j["state3"]
    for r, res in enumerate(rank[name] for rank in ranks):
        np.testing.assert_allclose(res["losses"], j["losses"], rtol=1e-4, err_msg=f"{name} rank {r}")
        rows = {}  # JAX's global arrays cut to this rank's rows of a sharded group
        for g, arr in s3["emb_tables"].items():
            n = res["storage"][g].shape[0]
            rows[g] = (lambda a, n=n: np.asarray(a)[r * n : (r + 1) * n]) if n != np.asarray(arr).shape[0] \
                else np.asarray
        local = dict(s3, emb_tables={g: rows[g](a) for g, a in s3["emb_tables"].items()},
                     eopt={g: {k: rows[g](v) for k, v in st.items()} for g, st in s3["eopt"].items()})
        dense, dopt = {}, {}
        for key, v in res["replicated"].items():
            kind, rest = key.split(":", 1)
            if kind == "dense":
                layer, k = rest.split(".", 1)
                dense.setdefault(layer, {})[k] = v
            elif kind == "dopt":
                opt_kind, layer, k = rest.split(".", 2)
                dopt.setdefault(opt_kind, {}).setdefault(layer, {})[k] = v
        assert_state_close(local, res["storage"], res.get("state", {}), dense, dopt, 0.001, f"{name} rank {r}")
        assert_eval_close(res["eval"], j["eval"])
    if name == "mmoe":
        assert "auc_married_label" in j["eval"]
    a, b = (rank[name] for rank in ranks)
    for k, v in a["replicated"].items():
        np.testing.assert_array_equal(b["replicated"][k], v, err_msg=k)
