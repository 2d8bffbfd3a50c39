"""Snapshots over W = 2 ranks (one spawned gloo group) against the JAX
package's 2-device CPU mesh, on the tiny DLRM-FTRL with dynamic tables
(model-parallel, row-sharded key stores and state).

The JAX model takes one step and writes its snapshot. The port's ranks load
it, write their own snapshot of that state (rank 0 alone writes, and the
files equal the JAX package's byte for byte), then train 2 more steps whose
losses agree with the JAX model's within rtol 1e-4 (the tiny FTRL
tolerance of `tests/test_torch_dlrm_ftrl.py`); a second port model from
another seed reloads the port's snapshot on both ranks bitwise. The JAX
model then reloads the port's snapshot bitwise.
"""
import json

import jax
import numpy as np
import pytest
import torch

import torch_rank_fns as fns
from hugectr_tpu_torch.tools import hybrid

from test_torch_dlrm_ftrl import _sample_model
from test_torch_persistence import assert_same_snapshot

torch.set_num_threads(1)


def test_dynamic_ftrl_snapshot_on_two_ranks_matches_jax(tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        jm = _sample_model(mp, dynamic=True, num_devices=2)
        jm.train()
        jm.download_params_to_files(str(tmp_path / "jax"), 3)
        state = jax.device_get(jm.state)
        jax_losses = [jm.train() for _ in range(2)]
    cfg = dict(builder="build_tiny_dlrm_ftrl", kwargs=dict(dynamic=True), load=str(tmp_path / "jax_iter3"),
               skip=1, prefix=str(tmp_path / "port"), iteration=3, after=2)
    inputs = {"rt": {"config": json.dumps(cfg)}, "calls": json.dumps({"rt": "snapshot_round_trip"})}
    ranks = [r["rt"] for r in hybrid.run(fns.several, 2, inputs, device="cpu")]
    assert ranks[0]["writes"] > 0 and ranks[1]["writes"] == 0
    assert_same_snapshot(str(tmp_path / "port_iter3"), str(tmp_path / "jax_iter3"))
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["losses"], jax_losses, rtol=1e-4, err_msg=f"rank {r}")
        assert json.loads(res["differ"]) == [] and res["arrays"] > 50, f"rank {r}"
        assert res["step"] == 1
    jm.load_params_from_files(str(tmp_path / "port_iter3"))
    again = jax.device_get(jm.state)
    for g, arr in state["emb_tables"].items():
        np.testing.assert_array_equal(again["emb_tables"][g], arr, err_msg=g)
    for g, st in state["eopt"].items():
        for k, arr in st.items():
            np.testing.assert_array_equal(again["eopt"][g][k], arr, err_msg=f"{g}.{k}")
    assert (np.asarray(state["emb_tables"]["mp_ev128#keys"]) != 2**31 - 1).sum() > 20
