"""RecordEvent and profiler-mode helpers.

Counterpart of ``paddle_tpu/profiler/utils.py`` (Paddle's
``profiler/utils.py``: ``RecordEvent``, ``load_profiler_result``,
``in_profiler_mode``). Where the reference also opens a
``jax.profiler.TraceAnnotation`` while a device trace runs, a
``RecordEvent`` here also opens a ``torch.profiler.record_function``
range, so the span shows by name in any torch profiler trace, next to
the kernels it launched.
"""
from __future__ import annotations

import json
from typing import Any

import torch

from .host_tracer import TracerEventType, get_host_tracer

_profiler_active = False


def _set_profiler_mode(on: bool):
    global _profiler_active
    _profiler_active = on


def in_profiler_mode() -> bool:
    return _profiler_active


class RecordEvent:
    """Context-manager/decorator marking a named host span.

    Usage::

        with profiler.RecordEvent("forward"):
            loss = model(x)
    """

    def __init__(self, name: str,
                 event_type: str = TracerEventType.PythonUserDefined):
        self.name = name
        self.event_type = event_type
        self._ev = None
        self._range = None

    def begin(self):
        tracer = get_host_tracer()
        if tracer.enabled:
            self._ev = tracer.push(self.name, self.event_type)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()

    def end(self):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._ev is not None:
            get_host_tracer().pop(self._ev)
            self._ev = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def __call__(self, fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with RecordEvent(self.name, self.event_type):
                return fn(*args, **kwargs)

        return wrapper


def load_profiler_result(filename: str) -> Any:
    """Load a chrome-trace json previously exported by the profiler."""
    with open(filename) as f:
        return json.load(f)
