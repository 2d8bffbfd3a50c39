"""DIN (samples/din.py; reference: samples/din/din_parquet.py): attention
over the behaviour history from Scale / Sub / ElementwiseMultiply / Softmax
and a PReLU_Dice MLP over FusedReshapeConcat item and history tensors.

    python -m hugectr_tpu_torch.samples.din [--batchsize 2048] [--device cpu]
"""
from hugectr_tpu_torch.samples.common import make_reader, run, sample_args, sample_rm
from hugectr_tpu_torch.tools import samples as graphs

args = sample_args("din")
model = graphs.build_sample(
    "din", sample_rm(args), batchsize=args.batchsize, lr=args.lr, compile_model=False,
    reader=make_reader(args, [graphs.USER_VOCAB] + [graphs.GOOD_VOCAB] * 11 + [graphs.CATE_VOCAB] * 11, dense_dim=1),
)
if __name__ == "__main__":
    run(model, args)
