"""A key-value store for the ranks: the port of paddle_tpu/distributed/
store.py's ``TCPStore`` (:219-368) and ``create_or_get_global_tcp_store``
(:370), over ``torch.distributed.TCPStore``.

The master (rank 0) hosts the store; every rank sets, gets (waiting for
the key), adds and waits. Values are bytes (a str is encoded). Port 0
binds a free port, which ``.port`` then gives. The reference's own
server (``csrc/tcp_store.cpp``) is host code; torch's store replaces it.
"""
from __future__ import annotations

import datetime
import os

import torch.distributed as dist

__all__ = ["TCPStore", "create_or_get_global_tcp_store"]


class TCPStore:
    def __init__(self, host: str, port: int, world_size: int = 1,
                 is_master: bool = False, timeout: float = 300.0):
        self.host = host
        self.world_size = world_size
        self.is_master = is_master
        self.timeout = float(timeout)
        self._store = dist.TCPStore(
            host, int(port), world_size if is_master else None, is_master,
            timeout=datetime.timedelta(seconds=self.timeout),
            wait_for_workers=False)
        self.port = self._store.port

    def set(self, key: str, value):
        value = value if isinstance(value, bytes) else str(value).encode()
        self._store.set(key, value)

    def get(self, key: str) -> bytes:
        """Blocks until ``key`` exists or the timeout passes."""
        return self._store.get(key)

    def add(self, key: str, delta: int = 1) -> int:
        return int(self._store.add(key, int(delta)))

    def wait(self, keys, timeout: float = None):
        keys = [keys] if isinstance(keys, str) else list(keys)
        self._store.wait(keys, datetime.timedelta(
            seconds=float(timeout or self.timeout)))

    def shutdown(self):
        self._store = None


_global_store = None


def create_or_get_global_tcp_store() -> TCPStore:
    """One store a job, hosted by rank 0 at ``MASTER_ADDR`` /
    ``MASTER_PORT`` (reference parallel.py:1134)."""
    global _global_store
    if _global_store is None:
        rank = int(os.environ.get("RANK") or
                   os.environ.get("PADDLE_TRAINER_ID") or 0)
        world = int(os.environ.get("WORLD_SIZE") or
                    os.environ.get("PADDLE_TRAINERS_NUM") or 1)
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = int(os.environ.get("MASTER_PORT", "0") or 0)
        _global_store = TCPStore(addr, port, world_size=world,
                                 is_master=(rank == 0))
    return _global_store
