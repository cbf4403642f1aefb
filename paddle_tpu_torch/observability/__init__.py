"""paddle_tpu_torch.observability — metrics, events, request tracing, SLOs.

The port's counterpart of ``paddle_tpu/observability``, so far:

- the metrics registry (``metrics.py``) and the define-or-get
  ``counter`` / ``gauge`` / ``histogram``;
- structured events (``events.py``: ``Event``, ``emit``, ``events``,
  ``span``, which opens a ``torch.profiler.record_function`` range) and
  the flight recorder (``flight.py``: a ring of recent events and the
  JSON post-mortem under ``PADDLE_TPU_FLIGHT_DIR``);
- request tracing for the serving engine (``tracing.py``:
  ``ServeTracer`` grows a span tree on every request, with a Chrome-trace
  export through ``chrome.py`` and tail exemplars) and SLO monitors
  (``slo.py``: ``SloMonitor`` over ``SloRule`` s). Turn them on with
  ``ServeEngine(trace=True, slo=[...])`` or the reference's variables
  ``PADDLE_TPU_TRACE`` and ``PADDLE_TPU_SLO``.

Gating: event recording at the instrumentation sites is off by default;
:func:`enable` turns it on, and so does ``PADDLE_TPU_FLIGHT_DIR`` at
import (which also arms the excepthook that writes the crash dump).
Metric objects always record when called directly.

Health, time series, the fleet aggregator, the op profiler, the
report renderer and the runtime gauges wait for ROADMAP queue A item 5's
rest.
"""
from __future__ import annotations

import os

from ._gate import state
from .metrics import CLAIMED_SUBSYSTEMS, registry
from .events import Event, emit, events, span
from . import flight
from .flight import FlightRecorder
from . import slo
from .slo import SloMonitor, SloRule
from . import tracing
from .tracing import (RequestTrace, ServeTracer, Span, TailExemplars,
                      check_tracing_overhead, validate_trace)
from . import chrome

__all__ = [
    "state", "enable", "disable",
    "registry", "counter", "gauge", "histogram", "CLAIMED_SUBSYSTEMS",
    "Event", "emit", "events", "span",
    "flight", "FlightRecorder",
    "slo", "SloMonitor", "SloRule",
    "tracing", "Span", "RequestTrace", "ServeTracer", "TailExemplars",
    "check_tracing_overhead", "validate_trace",
    "chrome",
]

counter = registry.counter
gauge = registry.gauge
histogram = registry.histogram


def enable():
    """Turn on event recording at the instrumentation sites, and arm the
    crash-dump hook (idempotent; it writes nothing unless
    ``PADDLE_TPU_FLIGHT_DIR`` is set when it fires)."""
    state.on = True
    flight.install_excepthook()


def disable():
    state.on = False


def _init_from_env():
    if os.environ.get(flight.FLIGHT_DIR_ENV):
        # a configured crash-dump directory implies recording and arms
        # the excepthook, as in the reference
        state.on = True
        flight.install_excepthook()


_init_from_env()
