"""Criteo baseline (samples/criteo_parquet.py; reference:
samples/criteo/criteo_parquet.py): one 16-wide embedding of 26 slots and a
4-layer MLP, Adam, over the Parquet set of `--data_dir`.

    python -m hugectr_tpu_torch.samples.criteo_parquet [--batchsize 2048] [--device cpu]
"""
from hugectr_tpu_torch.samples.common import make_reader, run, sample_args, sample_rm
from hugectr_tpu_torch.tools import samples as graphs

args = sample_args("criteo")
model = graphs.build_sample(
    "criteo_parquet", sample_rm(args), batchsize=args.batchsize, lr=args.lr, compile_model=False,
    reader=make_reader(args, graphs.CRITEO_SLOTS),
)
if __name__ == "__main__":
    run(model, args)
