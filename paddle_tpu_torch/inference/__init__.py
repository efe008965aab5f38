from .kv_cache import DenseKVCache, PagedKVCache

__all__ = ["DenseKVCache", "PagedKVCache"]
