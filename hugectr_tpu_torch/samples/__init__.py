"""The sample training scripts (counterpart of the JAX package's samples/):
`python -m hugectr_tpu_torch.samples.<name> [flags]`. Each script builds its
model at module level, as the JAX scripts do, so importing one builds a
model: run them, or load one with `runpy.run_path(..., run_name="not_main")`."""
