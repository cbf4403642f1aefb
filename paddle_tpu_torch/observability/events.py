"""Structured span events riding the profiler's host timeline.

The port's copy of ``paddle_tpu/observability/events.py``. Two
complementary records per interesting runtime moment:

- a structured :class:`Event` (kind + JSON-serializable fields + unix
  timestamp) appended to a bounded ring buffer;
- a ``torch.profiler.record_function`` host range (the reference opens
  its profiler's ``RecordEvent``), so the same moment shows up by name in
  a torch profiler trace, next to the kernels it launched.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional

from . import _gate, flight
from .metrics import Histogram

#: ring-buffer capacity; read once from core.flags at first use so the
#: flag can be set before any event is emitted.
_MAX_EVENTS_FLAG = "observability_max_events"

_events: Optional[collections.deque] = None


def _buffer() -> collections.deque:
    global _events
    if _events is None:
        from ..core import flags

        try:
            maxlen = int(flags.get_flag(_MAX_EVENTS_FLAG))
        except KeyError:
            maxlen = 4096
        _events = collections.deque(maxlen=max(1, maxlen))
    return _events


class Event:
    __slots__ = ("ts", "kind", "fields")

    def __init__(self, kind: str, fields: Dict[str, Any]):
        self.ts = time.time()
        self.kind = kind
        self.fields = fields

    def to_dict(self) -> Dict[str, Any]:
        return {"ts": self.ts, "kind": self.kind, **self.fields}


def emit(kind: str, **fields):
    """Record a structured event (no-op while observability is off).

    The event lands in two rings: the large export buffer and the smaller
    flight-recorder ring that survives into crash dumps (see
    ``observability.flight``)."""
    if not _gate.state.on:
        return
    ev = Event(kind, fields)
    _buffer().append(ev)
    flight.recorder.record(kind, fields, ts=ev.ts)


def events(kind: Optional[str] = None) -> List[Event]:
    evs = list(_buffer())
    if kind is not None:
        evs = [e for e in evs if e.kind == kind]
    return evs


def clear():
    _buffer().clear()


class span:
    """Context manager bracketing a named runtime moment.

    Always opens a ``torch.profiler.record_function`` range (so the
    moment shows up in any active profiler trace); when observability is
    on it also feeds ``histogram`` with the elapsed seconds and emits an
    ``event`` record carrying ``fields`` plus the measured duration.
    """

    __slots__ = ("name", "_hist", "_hist_labels", "_event", "_fields",
                 "_rec", "_t0", "seconds")

    def __init__(self, name: str, *, histogram: Optional[Histogram] = None,
                 hist_labels: Optional[Dict[str, Any]] = None,
                 event: Optional[str] = None, **fields):
        self.name = name
        self._hist = histogram
        self._hist_labels = hist_labels or {}
        self._event = event
        self._fields = fields
        self._rec = None
        self.seconds = 0.0

    def __enter__(self):
        import torch

        self._rec = torch.profiler.record_function(self.name)
        self._rec.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self._rec is not None:
            self._rec.__exit__(None, None, None)
            self._rec = None
        if _gate.state.on:
            if self._hist is not None:
                self._hist.observe(self.seconds, **self._hist_labels)
            if self._event is not None:
                emit(self._event, seconds=self.seconds, **self._fields)
        return False
