"""NCF family (samples/ncf.py; reference: samples/ncf/{gmf,ncf,neumf}.py):
MovieLens user / item collaborative filtering; the learning rate is the
sample's 0.0045 whatever `--lr` says, as in the JAX script.

--variant gmf   : elementwise user * item product -> logit (default)
--variant ncf   : MLP tower over the concatenated user / item embedding
--variant neumf : GMF branch + MLP branch, concat -> logit (NeuMF)

    python -m hugectr_tpu_torch.samples.ncf --variant neumf [--device cpu]
"""
from hugectr_tpu_torch.samples.common import make_reader, run, sample_args, sample_rm
from hugectr_tpu_torch.tools import samples as graphs

args = sample_args(
    "ncf", extra=lambda p: p.add_argument("--variant", default="gmf", choices=["gmf", "ncf", "neumf"])
)
model = graphs.build_sample(
    "ncf", sample_rm(args), batchsize=args.batchsize, lr=args.lr, compile_model=False, variant=args.variant,
    reader=make_reader(args, graphs.NCF_SLOTS, dense_dim=1),
)
if __name__ == "__main__":
    run(model, args)
