"""Flight recorder: a crash-surviving trail of recent runtime events.

The port's copy of ``paddle_tpu/observability/flight.py``. Every
structured observability event (``events.emit``) also lands in a small
bounded ring here, and on an unhandled exception (once
:func:`install_excepthook` has run) or an SLO breach
(``observability/slo.py``) the ring — plus the exception, a metrics
snapshot and the dumping site's context — is serialized as one JSON file
under the directory named by ``PADDLE_TPU_FLIGHT_DIR`` (the reference's
variable, so one setting serves both packages).

Gating follows the rest of the layer: nothing is recorded while
``observability.state.on`` is False, and setting ``PADDLE_TPU_FLIGHT_DIR``
turns the gate on at import. Dump files are named
``flight-<pid>-<seq>.json`` so concurrent processes sharing one
directory never collide.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from . import _gate

FLIGHT_DIR_ENV = "PADDLE_TPU_FLIGHT_DIR"
FLIGHT_DUMP_KIND = "flight_dump"
FLIGHT_VERSION = 1

#: the dump reason of an SLO breach (observability/slo.py SloMonitor;
#: the reference's spelling): the dump context carries the rule, the
#: offending value and the tail-exemplar span trees
REASON_SLO_BREACH = "slo_breach"

#: ring capacity; read once from core.flags at first record so the flag
#: can be set before any event lands (same pattern as events._buffer).
_CAPACITY_FLAG = "observability_flight_events"


class FlightRecorder:
    """Bounded ring of recent structured events + the dump machinery."""

    def __init__(self):
        self._ring: Optional[collections.deque] = None
        self._dump_seq = 0
        # two threads can dump at the same moment (an SLO breach on a
        # serving thread, the excepthook on another); serialize so
        # neither post-mortem is lost
        self._dump_lock = threading.Lock()

    # -- recording --------------------------------------------------------
    def _buffer(self) -> collections.deque:
        if self._ring is None:
            from ..core import flags

            try:
                maxlen = int(flags.get_flag(_CAPACITY_FLAG))
            except KeyError:
                maxlen = 512
            self._ring = collections.deque(maxlen=max(1, maxlen))
        return self._ring

    def record(self, kind: str, fields: Dict[str, Any],
               ts: Optional[float] = None):
        """Append one event (no-op while observability is off)."""
        if not _gate.state.on:
            return
        self._buffer().append(
            {"ts": time.time() if ts is None else ts, "kind": kind,
             **fields})

    def snapshot(self) -> List[Dict[str, Any]]:
        return list(self._buffer())

    def clear(self):
        if self._ring is not None:
            self._ring.clear()

    # -- dumping ----------------------------------------------------------
    def dump_dir(self) -> Optional[str]:
        return os.environ.get(FLIGHT_DIR_ENV) or None

    def dump_dict(self, reason: str, exc: Optional[BaseException] = None,
                  context: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
        from .metrics import registry

        d: Dict[str, Any] = {
            "kind": FLIGHT_DUMP_KIND,
            "version": FLIGHT_VERSION,
            "reason": reason,
            "generated_unix": time.time(),
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "events": self.snapshot(),
            "metrics": registry.to_dict(),
        }
        if context:
            # what the dumping site knows and the recorder does not (an
            # SLO breach: the rule, its value, the tail exemplars)
            d["context"] = dict(context)
        if exc is not None:
            d["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc),
                "traceback": traceback.format_exception(
                    type(exc), exc, exc.__traceback__),
            }
        # the reference adds its runtime module's device-memory gauges
        # here; the port has no such module yet (ROADMAP item 5)
        return d

    def dump(self, reason: str, exc: Optional[BaseException] = None,
             path: Optional[str] = None,
             context: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write the post-mortem JSON; returns the path, or None when no
        target directory is configured. Must never raise — it runs from
        the excepthook and the serving loop."""
        try:
            with self._dump_lock:
                if path is None:
                    d = self.dump_dir()
                    if not d:
                        return None
                    os.makedirs(d, exist_ok=True)
                    self._dump_seq += 1
                    path = os.path.join(
                        d, f"flight-{os.getpid()}-{self._dump_seq}.json")
                doc = self.dump_dict(reason, exc, context=context)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(doc, f, indent=1, default=str)
                os.replace(tmp, path)
                return path
        except Exception:
            return None


#: process-global recorder every instrumented site records into.
recorder = FlightRecorder()

_prev_excepthook = None


def _flight_excepthook(exc_type, exc, tb):
    if _gate.state.on and recorder.dump_dir():
        e = exc if isinstance(exc, BaseException) else exc_type(exc)
        path = recorder.dump("unhandled_exception", e)
        if path:
            print(f"paddle_tpu_torch flight recorder: wrote {path}",
                  file=sys.stderr)
    if _prev_excepthook is not None:
        _prev_excepthook(exc_type, exc, tb)


def install_excepthook():
    """Chain a sys.excepthook that writes the flight dump on an unhandled
    exception (idempotent)."""
    global _prev_excepthook
    if sys.excepthook is _flight_excepthook:
        return
    _prev_excepthook = sys.excepthook
    sys.excepthook = _flight_excepthook
