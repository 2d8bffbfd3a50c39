"""MMoE multi-task (samples/mmoe.py; reference: samples/mmoe/mmoe_parquet.py):
UCI Census, two binary labels, 3 shared experts gated per task, a tower and
a loss per task (label weights 0.5 each), SGD.

--variant shared_bottom (reference: samples/mmoe/shared_bottom.py): one
shared bottom MLP feeding both task towers, no gating.

    python -m hugectr_tpu_torch.samples.mmoe [--variant shared_bottom] [--device cpu]
"""
from hugectr_tpu_torch.samples.common import make_reader, run, sample_args, sample_rm
from hugectr_tpu_torch.tools import samples as graphs

args = sample_args(
    "mmoe", extra=lambda p: p.add_argument("--variant", default="mmoe", choices=["mmoe", "shared_bottom"])
)
model = graphs.build_sample(
    "mmoe", sample_rm(args), batchsize=args.batchsize, lr=args.lr, compile_model=False, variant=args.variant,
    reader=make_reader(args, graphs.MMOE_SLOTS, label_dim=2, dense_dim=2),
)
if __name__ == "__main__":
    run(model, args)
