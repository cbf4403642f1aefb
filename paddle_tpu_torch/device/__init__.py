"""paddle_tpu_torch.device — device management (``paddle.device``).

Counterpart of ``paddle_tpu/device/__init__.py``, with its ``__all__``.
The accelerator is the CUDA card (Paddle's ``gpu``): ``Stream`` and
``Event`` are the card's streams and events (``device/cuda``), the
memory calls read torch's caching allocator (``device/memory.py``), and
``set_device`` / ``get_device`` / ``device_count`` /
``is_compiled_with_cuda`` are ``core/place.py``'s. No custom device
types exist in this build.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..core.place import (device_count, get_device, is_compiled_with_cuda,
                          set_device)
from . import memory
from . import cuda  # noqa: F401
from . import xpu  # noqa: F401
from .cuda import Event, Stream, current_stream, stream_guard
from .memory import (empty_cache, max_memory_allocated, max_memory_reserved,
                     memory_allocated, memory_reserved, memory_stats)

__all__ = [
    "set_device", "get_device", "device_count", "is_compiled_with_cuda",
    "get_all_device_type", "get_available_device", "synchronize",
    "Stream", "Event", "current_stream", "set_stream", "stream_guard",
    "is_compiled_with_xpu", "is_compiled_with_ipu",
    "is_compiled_with_custom_device", "get_all_custom_device_type",
    "get_available_custom_device", "memory_allocated", "memory_reserved",
    "max_memory_allocated", "max_memory_reserved", "memory_stats",
    "empty_cache",
]


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_ipu() -> bool:
    return False


def is_compiled_with_custom_device(device_type: str) -> bool:
    return False


def get_all_device_type() -> List[str]:
    return ["cpu", "gpu"] if device_count() else ["cpu"]


def get_all_custom_device_type() -> List[str]:
    return []


def get_available_device() -> List[str]:
    """The visible cards as ``"gpu:N"``; ``["cpu"]`` where there is none."""
    return [f"gpu:{i}" for i in range(device_count())] or ["cpu"]


def get_available_custom_device() -> List[str]:
    return []


def synchronize(device: Optional[str] = None) -> None:
    """Block until all work queued on the card has finished (no-op on a
    host without a card)."""
    cuda.synchronize(device)


def set_stream(stream: Stream) -> Stream:
    """Make ``stream`` the current stream of its card; returns the one it
    replaces."""
    prev = current_stream(stream.device)
    torch.cuda.set_stream(stream.torch_stream)
    return prev

