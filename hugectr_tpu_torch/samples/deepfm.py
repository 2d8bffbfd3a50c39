"""DeepFM (samples/deepfm.py; reference: samples/deepfm/deepfm_parquet.py):
11-wide embeddings split into 10-wide latent vectors (FM second order and
the deep MLP) and 1-wide first-order weights, with WeightMultiply dense
features.

    python -m hugectr_tpu_torch.samples.deepfm [--batchsize 2048] [--device cpu]
"""
from hugectr_tpu_torch.samples.common import make_reader, run, sample_args, sample_rm
from hugectr_tpu_torch.tools import samples as graphs

args = sample_args("deepfm")
model = graphs.build_sample(
    "deepfm", sample_rm(args), batchsize=args.batchsize, lr=args.lr, compile_model=False,
    reader=make_reader(args, graphs.CRITEO_SLOTS),
)
if __name__ == "__main__":
    run(model, args)
