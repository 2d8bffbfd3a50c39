"""Wide & Deep (samples/wdl.py; reference: samples/wdl/wdl_1gpu.py): a wide
1-wide embedding and a deep 16-wide one, 2 x 1024 MLP with dropout; the wide
output is added to the deep logit.

    python -m hugectr_tpu_torch.samples.wdl [--batchsize 2048] [--device cpu]
"""
from hugectr_tpu_torch.samples.common import make_reader, run, sample_args, sample_rm
from hugectr_tpu_torch.tools import samples as graphs

args = sample_args("wdl")
model = graphs.build_sample(
    "wdl", sample_rm(args), batchsize=args.batchsize, lr=args.lr, compile_model=False,
    reader=make_reader(args, graphs.WDL_WIDE_SLOTS + graphs.WDL_DEEP_SLOTS),
)
if __name__ == "__main__":
    run(model, args)
