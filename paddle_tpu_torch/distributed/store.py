"""Rendezvous store.

Counterpart of ``paddle_tpu/distributed/store.py`` (the reference's
``Store`` / ``InMemoryStore`` / ``TCPStore`` / ``create_store``, after
Paddle's ``store.h`` and ``tcp_store.h``). ``InMemoryStore`` is the
reference's. ``TCPStore`` keeps the reference's interface over
``torch.distributed.TCPStore`` (the reference binds its own native
server); rank 0 hosts the server in-process. A wait that outlives its
timeout raises ``TimeoutError``, as the reference's does, where torch
raises ``DistStoreError``.
"""
from __future__ import annotations

import datetime
import threading
import time
from typing import Dict, Optional

__all__ = ["Store", "InMemoryStore", "TCPStore", "create_store"]


class Store:
    """Abstract KV store with blocking get/wait + atomic add."""

    def set(self, key: str, value) -> None:
        raise NotImplementedError

    def get(self, key: str, timeout_s: Optional[float] = None) -> bytes:
        raise NotImplementedError

    def add(self, key: str, delta: int = 1) -> int:
        raise NotImplementedError

    def wait(self, keys, timeout_s: Optional[float] = None) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemoryStore(Store):
    """Single-process store (and unit-test double)."""

    def __init__(self):
        self._data: Dict[str, bytes] = {}
        self._cv = threading.Condition()

    def set(self, key, value):
        data = value if isinstance(value, bytes) else str(value).encode()
        with self._cv:
            self._data[key] = data
            self._cv.notify_all()

    def get(self, key, timeout_s=None):
        deadline = None if timeout_s is None else time.time() + timeout_s
        with self._cv:
            while key not in self._data:
                remaining = None if deadline is None \
                    else deadline - time.time()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"get({key!r}) timed out")
                self._cv.wait(remaining)
            return self._data[key]

    def add(self, key, delta=1):
        with self._cv:
            cur = int(self._data.get(key, b"0"))
            cur += delta
            self._data[key] = str(cur).encode()
            self._cv.notify_all()
            return cur

    def wait(self, keys, timeout_s=None):
        if isinstance(keys, str):
            keys = [keys]
        for k in keys:
            self.get(k, timeout_s)


def _seconds(s: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(s))


class _TorchStoreView(Store):
    """The reference's ``Store`` interface over a torch store
    (``TCPStore`` or a ``PrefixStore`` of one); ``timeout_s`` is the
    wait of a call that names none."""

    def __init__(self, torch_store, timeout_s: float = 900.0):
        self.torch_store = torch_store
        self.timeout_s = float(timeout_s)

    def set(self, key, value):
        self.torch_store.set(key, value if isinstance(value, bytes)
                             else str(value))

    def get(self, key, timeout_s=None):
        self.wait([key], timeout_s)
        return self.torch_store.get(key)

    def add(self, key, delta=1):
        return int(self.torch_store.add(key, int(delta)))

    def wait(self, keys, timeout_s=None):
        import torch.distributed as dist

        keys = [keys] if isinstance(keys, str) else list(keys)
        if timeout_s is not None and timeout_s <= 0:
            # torch reads a zero timeout as "no timeout": look, don't wait
            if not self.torch_store.check(keys):
                raise TimeoutError(f"wait({keys!r}) timed out")
            return
        try:
            self.torch_store.wait(keys, _seconds(
                self.timeout_s if timeout_s is None else timeout_s))
        except dist.DistStoreError as e:
            raise TimeoutError(f"wait({keys!r}) timed out: {e}") from e

    def close(self):
        # torch's store shuts its server down when the last reference
        # (this one, or a process group's) goes
        self.torch_store = None


class TCPStore(_TorchStoreView):
    """The reference's ``TCPStore`` over ``torch.distributed.TCPStore``
    (``is_master`` hosts the server). ``torch_store`` is the torch store
    itself, which ``init_parallel_env`` hands to the process group."""

    def __init__(self, host: str, port: int, is_master: bool = False,
                 world_size: Optional[int] = None,
                 timeout_s: float = 900.0):
        import torch.distributed as dist

        super().__init__(dist.TCPStore(
            host, int(port), world_size=None, is_master=is_master,
            timeout=_seconds(timeout_s), wait_for_workers=False),
            timeout_s)
        self.host = host
        self.port = self.torch_store.port
        self.is_master = is_master
        self.world_size = world_size


def create_store(master: Optional[str] = None, rank: int = 0,
                 world_size: int = 1, timeout_s: float = 900.0) -> Store:
    """The process's rendezvous store. ``master`` is "host:port"
    (``PADDLE_MASTER``); rank 0 hosts the server in-process, as the
    reference's ``is_master=rank==0`` does. One rank, or no master:
    an ``InMemoryStore``. Otherwise a ``TCPStore``, or the error that
    kept one from coming up: nothing falls back."""
    if master is None or world_size <= 1:
        return InMemoryStore()
    host, port = master.rsplit(":", 1)
    return TCPStore(host, int(port), is_master=(rank == 0),
                    world_size=world_size, timeout_s=timeout_s)
