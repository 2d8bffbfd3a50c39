"""The embedding-collection benchmark suite (benchmarks/embedding_collection/)."""
