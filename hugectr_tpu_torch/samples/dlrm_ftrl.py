"""DLRM with the FTRL optimizer and, with `--use_dynamic_hash_table`, exact
dynamic hash tables (samples/dlrm_ftrl.py; reference:
samples/ftrl/dlrm_train_ftrl.py): 26 tables of the Criteo slot sizes capped
at 400,000 rows, ev 128, hotness 1, a Reshape to [B, 26, 128] into the DLRM
Interaction, bottom MLP 512/256/128, top MLP 1024/1024/512/256/1. Dynamic
tables (`max_vocabulary_size` -1, 4,096 rows each) make a row at a key's
first touch. Built by `tools/flagship.py::build_dlrm_ftrl` over the Parquet
set of `--data_dir`.

    python -m hugectr_tpu_torch.samples.dlrm_ftrl [--use_dynamic_hash_table] [--device cpu]
"""
from hugectr_tpu_torch.samples.common import make_reader, run, sample_args, sample_rm
from hugectr_tpu_torch.tools.flagship import FTRL_SLOT_SIZES, build_dlrm_ftrl

CAP = 400_000  # the sample caps its synthetic vocabularies on one host

args = sample_args("dlrm_ftrl")
model = build_dlrm_ftrl(
    sample_rm(args), batchsize=args.batchsize, dynamic=args.use_dynamic_hash_table, vocab_cap=CAP,
    lr=args.lr, compile_model=False,
    reader=make_reader(args, [min(s, CAP) for s in FTRL_SLOT_SIZES], nnz_array=[1] * len(FTRL_SLOT_SIZES)),
)
if __name__ == "__main__":
    run(model, args)
