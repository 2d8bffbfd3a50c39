from .embedding_cache import EmbeddingCache, StaticTable, UvmTable  # noqa: F401
