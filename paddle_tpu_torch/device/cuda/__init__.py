"""``paddle.device.cuda`` over torch's CUDA runtime.

Counterpart of ``paddle_tpu/device/cuda/__init__.py``. There "cuda"
calls mean the TPU, and streams and events are host-side fences; here
they are the card's own: :class:`Stream` is a ``torch.cuda.Stream``,
:class:`Event` a ``torch.cuda.Event`` (timed on the device when
``enable_timing``), and the memory calls read the caching allocator
(``device/memory.py``). Without a card, making a stream or an event
raises (nothing falls back to the host); the memory calls read 0.
"""
from __future__ import annotations

import collections
import contextlib

import torch

from .. import memory as _memory

__all__ = [
    "Stream", "Event", "current_stream", "synchronize", "device_count",
    "empty_cache", "max_memory_allocated", "max_memory_reserved",
    "memory_allocated", "memory_reserved", "stream_guard",
    "get_device_properties", "get_device_name", "get_device_capability",
]


def _need_card(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"paddle_tpu_torch: {what} needs a CUDA device and none is "
            f"visible (the CPU has no streams or events)")


def _index(device) -> int:
    """A device argument (None, an int, ``"gpu:N"``, ``"cuda:N"``, a
    ``torch.device`` or a place-like string) -> the card's index."""
    if device is None:
        return torch.cuda.current_device()
    if isinstance(device, int):
        return device
    if isinstance(device, torch.device):
        return device.index if device.index is not None \
            else torch.cuda.current_device()
    _, _, idx = str(device).partition(":")
    return int(idx) if idx else torch.cuda.current_device()


def device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def synchronize(device=None):
    """Block until all work queued on the card has finished (no-op
    without a card)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize(_index(device))


def _priority(priority: int) -> int:
    """Paddle's priority (1 high, 2 normal) -> torch's (-1 high, 0)."""
    return -1 if int(priority) <= 1 else 0


class Stream:
    """A CUDA stream (``torch.cuda.Stream``; ``torch_stream`` is it).
    ``Stream(stream=s)`` wraps an existing torch stream."""

    def __init__(self, device=None, priority: int = 2, stream=None):
        _need_card("Stream")
        self.torch_stream = stream if stream is not None else \
            torch.cuda.Stream(device=_index(device),
                              priority=_priority(priority))
        self.device = self.torch_stream.device
        self.priority = priority

    def synchronize(self):
        self.torch_stream.synchronize()

    def wait_event(self, event: "Event"):
        self.torch_stream.wait_event(event.torch_event)

    def wait_stream(self, stream: "Stream"):
        self.torch_stream.wait_stream(stream.torch_stream)

    def record_event(self, event: "Event" = None) -> "Event":
        event = event or Event()
        event.record(self)
        return event

    def query(self) -> bool:
        return self.torch_stream.query()


class Event:
    """A CUDA event (``torch.cuda.Event``; ``torch_event`` is it):
    ``record`` enqueues it on a stream, ``elapsed_time`` reads the device
    milliseconds between two timed events."""

    def __init__(self, enable_timing: bool = False, blocking: bool = False,
                 interprocess: bool = False):
        _need_card("Event")
        self.torch_event = torch.cuda.Event(enable_timing=enable_timing,
                                            blocking=blocking,
                                            interprocess=interprocess)

    def record(self, stream: Stream = None):
        self.torch_event.record(None if stream is None
                                else stream.torch_stream)

    def query(self) -> bool:
        return self.torch_event.query()

    def synchronize(self):
        self.torch_event.synchronize()

    def elapsed_time(self, end_event: "Event") -> float:
        return self.torch_event.elapsed_time(end_event.torch_event)


def current_stream(device=None) -> Stream:
    _need_card("current_stream")
    return Stream(stream=torch.cuda.current_stream(_index(device)))


@contextlib.contextmanager
def stream_guard(stream: Stream):
    """Queue the block's work on ``stream`` (``torch.cuda.stream``)."""
    with torch.cuda.stream(None if stream is None else stream.torch_stream):
        yield


def empty_cache():
    _memory.empty_cache()


def memory_allocated(device=None) -> int:
    return _memory.memory_allocated(None if device is None
                                    else _index(device))


def max_memory_allocated(device=None) -> int:
    return _memory.max_memory_allocated(None if device is None
                                        else _index(device))


def memory_reserved(device=None) -> int:
    return _memory.memory_reserved(None if device is None
                                   else _index(device))


def max_memory_reserved(device=None) -> int:
    return _memory.max_memory_reserved(None if device is None
                                       else _index(device))


DeviceProperties = collections.namedtuple(
    "DeviceProperties",
    ["name", "major", "minor", "total_memory", "multi_processor_count"])


def get_device_properties(device=None) -> DeviceProperties:
    _need_card("get_device_properties")
    p = torch.cuda.get_device_properties(_index(device))
    return DeviceProperties(name=p.name, major=p.major, minor=p.minor,
                            total_memory=int(p.total_memory),
                            multi_processor_count=p.multi_processor_count)


def get_device_name(device=None) -> str:
    _need_card("get_device_name")
    return torch.cuda.get_device_name(_index(device))


def get_device_capability(device=None):
    _need_card("get_device_capability")
    return torch.cuda.get_device_capability(_index(device))
