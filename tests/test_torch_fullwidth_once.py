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
"""
import argparse
import json
import os
import sys

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
                                    vocab_cap=a.vocab_cap, use_mixed_precision=True, reader=reader,
                                    max_eval_batches=1)

    def carry(model, i):
        if i == 1:
            load_jax_state(model, jax.device_get(jm.state))

    argv = ["--vocab-cap", str(a.vocab_cap), "--batch", str(a.batch), "--steps", str(a.steps), "--device", "cpu"]
    tm, rec = fullscale_dryrun.run(argv, step_hook=carry, say=lambda *x, **k: None)
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
                          max_dense_abs_diff=dense, routes=rec["routes"])))


if __name__ == "__main__":
    main()
