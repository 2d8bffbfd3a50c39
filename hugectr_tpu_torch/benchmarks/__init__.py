"""The port's counterparts of the JAX package's benchmark scripts
(benchmarks/): the embedding-collection suite (`embedding_collection.train`
with its cases in `embedding_collection.configs`), the weighted-lookup case
(`weighted_bench`), the host-spill tier (`host_spill_bench`) and the
unique-key exchange's bytes (`dense_exchange_bytes`). Each runs with
`python -m hugectr_tpu_torch.benchmarks.<module>`.
"""
