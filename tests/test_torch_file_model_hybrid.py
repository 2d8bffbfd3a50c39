"""The tiny DLRM-DCNv2 from a Raw file over 2 gloo ranks against the JAX
package on a 2-device mesh, from the same state (tests/test_torch_hybrid.py
with a file in place of the synthetic reader). Rank r's native reader reads
rows [g * 64 + r * 32, +32) of global batch g, the block the JAX mesh puts
on device r, so both train on the same examples: 3 steps and an eval over
the eval file's 2 whole batches (its tail dropped in both). Tolerances of
tests/test_torch_hybrid.py: losses rtol 1e-4, the eval AUC within 1e-6,
tables and dense parameters rtol 1e-4 / atol 1e-5.
"""
import json

import jax
import numpy as np

import hugectr_tpu as jh
from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.tools import flagship as jflagship
from hugectr_tpu_torch.tools import hybrid

from test_torch_file_model import TINY, close, generate, reader_fields
from test_torch_hybrid import MODEL_ENV, MODEL_KW, TOL


def test_raw_file_at_two_ranks_matches_jax_mesh(tmp_path, monkeypatch):
    p = generate(str(tmp_path), "raw_async", float_label_dense=True)
    fields = reader_fields("raw_async", p, float_label_dense=True)
    for k, v in MODEL_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("HCTR_TPU_EMB_DTYPE", raising=False)
    jm = jflagship.build_dlrm_dcnv2(JaxResourceManager.create(num_devices=2), reader=jh.DataReaderParams(**fields),
                                    **TINY)
    st = jax.device_get(jm.state)
    state = {k: st[k] for k in ("emb_tables", "eopt", "dense_params", "dopt", "step")}
    try:
        jl = [jm.train() for _ in range(3)]
        jev = jm.eval()
    finally:
        close(jm)
    kw = dict(MODEL_KW, **{k: v for k, v in TINY.items() if k not in MODEL_KW})
    cfg = dict(builder="build_dlrm_dcnv2", kwargs=kw, steps=3, eval=True, reader=fields)
    ranks = hybrid.run(hybrid.train_model, 2, {"config": json.dumps(cfg), "state": state}, device="cpu")
    st = jax.device_get(jm.state)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["losses"], jl, rtol=1e-4, err_msg=f"rank {r}")
        assert abs(res["eval"]["auc"] - jev["auc"]) <= 1e-6, (r, res["eval"], jev)
        assert res["eval_counts"]["plain_calls"]["onehot_fwd"] == 2  # the eval file's 2 whole batches
        for i in range(26):
            np.testing.assert_allclose(res["tables"][str(i)], jm.ec.export_table(st["emb_tables"], str(i)), **TOL,
                                       err_msg=f"rank {r} table {i}")
    for layer, ps in st["dense_params"].items():
        for k, v in ps.items():
            np.testing.assert_allclose(ranks[0]["dense"][f"{layer}.{k}"], v, **TOL, err_msg=f"{layer}/{k}")
