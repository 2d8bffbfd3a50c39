"""BST (samples/bst.py; reference: samples/bst/bst_avg_pooling.py): a
behaviour-sequence transformer, MultiHeadAttention with a SequenceMask over
the history, mean pooled and concatenated with the user and target
embeddings into a PReLU_Dice MLP.

    python -m hugectr_tpu_torch.samples.bst [--batchsize 2048] [--device cpu]
"""
from hugectr_tpu_torch.samples.common import make_reader, run, sample_args, sample_rm
from hugectr_tpu_torch.tools import samples as graphs

args = sample_args("bst")
model = graphs.build_sample(
    "bst", sample_rm(args), batchsize=args.batchsize, lr=args.lr, compile_model=False,
    reader=make_reader(args, ([graphs.USER_VOCAB] + [graphs.GOOD_VOCAB] * graphs.SEQ + [graphs.GOOD_VOCAB]
                            + [graphs.CATE_VOCAB] * graphs.SEQ + [graphs.CATE_VOCAB]), dense_dim=1),
)
if __name__ == "__main__":
    run(model, args)
