"""DLRM-DCNv2, the MLPerf flagship (samples/dlrm_dcnv2.py; reference:
samples/dlrm/train.py): an embedding collection of 26 multi-hot tables at ev
128, bottom MLP, DCNv2 low-rank cross and top MLP, AdaGrad (the JAX
script's default optimizer), AUC 0.80275 early stop, on synthetic power-law
batches. Built by `tools/flagship.py::build_dlrm_dcnv2`; real Criteo goes
through `tools/criteo_to_raw.py` and a `DataReaderParams` passed as
`reader=` to that builder.

    python -m hugectr_tpu_torch.samples.dlrm_dcnv2 [--batchsize 8192] [--vocab_cap 2000000]
        [--use_mixed_precision] [--num_slices 2 --comm_strategy hierarchical] [--device cpu]

`--num_slices` > 1 makes the hierarchical ("dcn", "ici") mesh over the
ranks of the process group; "hierarchical" communication reduce-scatters
within a slice first.
"""
import argparse

from hugectr_tpu_torch.core.mesh import ResourceManager
from hugectr_tpu_torch.samples.common import add_device_flag
from hugectr_tpu_torch.tools.flagship import build_dlrm_dcnv2

p = argparse.ArgumentParser("dlrm_dcnv2")
p.add_argument("--batchsize", type=int, default=8192)
p.add_argument("--max_iter", type=int, default=1000)
p.add_argument("--display", type=int, default=100)
p.add_argument("--eval_interval", type=int, default=1000)
p.add_argument("--lr", type=float, default=0.005)
p.add_argument("--vocab_cap", type=int, default=2_000_000)
p.add_argument("--num_devices", type=int, default=0)
p.add_argument("--use_mixed_precision", action="store_true")
p.add_argument("--num_slices", type=int, default=1)
p.add_argument("--comm_strategy", default="uniform", choices=["uniform", "hierarchical"])
add_device_flag(p)
args = p.parse_args()

rm = ResourceManager.create(num_devices=args.num_devices, device=args.device, num_slices=args.num_slices)
model = build_dlrm_dcnv2(
    rm,
    batchsize=args.batchsize,
    vocab_cap=args.vocab_cap,
    lr=args.lr,
    use_mixed_precision=args.use_mixed_precision,
    comm_strategy=args.comm_strategy,
    optimizer="adagrad",
)
if __name__ == "__main__":
    model.summary()
    model.fit(max_iter=args.max_iter, display=args.display, eval_interval=args.eval_interval)
