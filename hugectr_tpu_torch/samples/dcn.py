"""DCN v1 (samples/dcn.py; reference: samples/dcn/dcn_parquet.py): an
embedding of 26 slots of 2 keys, a 6-layer cross network beside an MLP,
concatenated into the logit.

    python -m hugectr_tpu_torch.samples.dcn [--batchsize 2048] [--device cpu]
"""
from hugectr_tpu_torch.samples.common import make_reader, run, sample_args, sample_rm
from hugectr_tpu_torch.tools import samples as graphs

args = sample_args("dcn")
model = graphs.build_sample(
    "dcn", sample_rm(args), batchsize=args.batchsize, lr=args.lr, compile_model=False,
    reader=make_reader(args, graphs.DCN_SLOTS, nnz_array=[2] * 26),
)
if __name__ == "__main__":
    run(model, args)
