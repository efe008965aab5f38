from .kv_cache import PagedKVCache

__all__ = ["PagedKVCache"]
