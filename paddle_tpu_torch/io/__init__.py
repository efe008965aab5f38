"""Input pipeline: the port of paddle_tpu/io's `DevicePrefetcher`.
``DataLoader`` and its workers wait on ROADMAP queue A10."""
from .device_prefetcher import DevicePrefetcher

__all__ = ["DevicePrefetcher"]
