"""The port's SOK API over W = 2 ranks (a spawned gloo group,
`torch_rank_fns.sok_ranks`) against the JAX package's 2-device mesh: the
engines, settings and tolerances of tests/test_torch_sok.py."""
import json

import jax
import numpy as np

import hugectr_tpu.sok as jsok
import torch_rank_fns
from hugectr_tpu.core.mesh import ResourceManager as JaxResourceManager
from hugectr_tpu.core.types import Optimizer_t as JOpt
from hugectr_tpu.optim.params import OptParams as JOptParams
from hugectr_tpu.parallel.plan import EmbeddingTableConfig as JTable

import hugectr_tpu_torch.sok as sok
from hugectr_tpu_torch.core.types import Optimizer_t
from hugectr_tpu_torch.optim.params import OptParams
from hugectr_tpu_torch.parallel.plan import EmbeddingTableConfig
from hugectr_tpu_torch.tools import hybrid
from test_torch_sok import CPU, FWD_TOL, SETTINGS, TOL, _fresh_sok, _keys  # noqa: F401 (the autouse fixture)


# ------------------------------------------------------------ W = 2, gloo
def _w2_inputs():
    rng = np.random.default_rng(13)
    tables = {"a": (rng.normal(size=(100, 8)) * 0.1).astype(np.float32),
              "b": (rng.normal(size=(50, 8)) * 0.1).astype(np.float32)}
    k0, k1 = _keys(rng, 32)
    w = [rng.uniform(0.1, 2.0, (32, 3)).astype(np.float32), rng.uniform(0.1, 2.0, (32, 2)).astype(np.float32)]
    d = [rng.normal(size=(32, 8)).astype(np.float32) for _ in range(2)]
    return {"tables": tables, "k0": k0, "k1": k1, "w0": w[0], "w1": w[1], "d0": d[0], "d1": d[1],
            "config": json.dumps({})}


def test_sok_two_ranks_match_jax(mesh1, tmp_path):
    """W = 2 over a spawned gloo group (`torch_rank_fns.sok_ranks`) against
    JAX's 2-device mesh: each rank looks up its block of the batch with
    weights and updates the tables by `OptimizerWrapper` (rowwise AdaGrad);
    both ranks' outputs together are JAX's global ones, the tables after the
    update JAX's; `dump` from the ranks (rank 0 writes) then `load` by one
    device gives the tables bitwise; a DynamicVariable's `size` over the
    ranks is the global count."""
    inputs = _w2_inputs()
    inputs["path"] = np.frombuffer(str(tmp_path).encode(), np.uint8)
    ranks = hybrid.run(torch_rank_fns.sok_ranks, 2, inputs, device="cpu")
    mesh2 = JaxResourceManager.create(num_devices=2)
    jsok.init(mesh2)
    je = jsok.LookupEngine([JTable("a", 100, 8), JTable("b", 50, 8)], hotness=[3, 2], combiners=["sum", "mean"],
                           opt=JOptParams(JOpt.RowWiseAdaGrad, lr=0.1), rm=mesh2, use_sp_weight=True)
    jt = je.init(jax.random.key(0))
    for n, vals in inputs["tables"].items():
        jt = je.ec.import_table(jt, n, vals)
    keys, ws, ds = [inputs["k0"], inputs["k1"]], [inputs["w0"], inputs["w1"]], [inputs["d0"], inputs["d1"]]
    jo = je.lookup(jt, keys, sp_weights=ws)
    for i in range(2):
        got = np.concatenate([r["out"][str(i)] for r in ranks])
        np.testing.assert_allclose(got, np.asarray(jo[i]), **FWD_TOL)
    jt, _ = jsok.OptimizerWrapper(je).apply_gradients(jt, je.init_optimizer(jt), keys, ds, 0.1, 1, sp_weights=ws)
    for n in ("a", "b"):
        for r in ranks:
            np.testing.assert_allclose(r["tables"][n], je.ec.export_table(jt, n), **TOL, err_msg=n)
    sok.init(CPU)
    te = sok.LookupEngine([EmbeddingTableConfig("a", 100, 8), EmbeddingTableConfig("b", 50, 8)], hotness=[3, 2],
                          combiners=["sum", "mean"], opt=OptParams(Optimizer_t.RowWiseAdaGrad, lr=0.1),
                          use_sp_weight=True, **SETTINGS)
    tt = sok.load(str(tmp_path), te, te.init(5))
    for n in ("a", "b"):
        np.testing.assert_array_equal(te.ec.export_table(tt, n), ranks[0]["tables"][n])
    assert [int(r["size"]) for r in ranks] == [int(ranks[0]["global_keys"])] * 2
