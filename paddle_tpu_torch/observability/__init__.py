"""paddle_tpu_torch.observability — metrics, events, step telemetry,
health monitoring, request tracing, SLOs and the metrics report.

The port's counterpart of ``paddle_tpu/observability``, under the
reference's names:

- the metrics registry (``metrics.py``) and the define-or-get
  ``counter`` / ``gauge`` / ``histogram``;
- structured events (``events.py``: ``Event``, ``emit``, ``events``,
  ``span``, which opens a ``torch.profiler.record_function`` range) and
  the flight recorder (``flight.py``: a ring of recent events and the
  JSON post-mortem under ``PADDLE_TPU_FLIGHT_DIR``, with the device
  memory gauges);
- step telemetry (``runtime.py``: ``step_region`` / ``StepTimer`` record
  ``train.step_seconds`` (device time between CUDA events on the card),
  ``train.items_per_second`` and ``train.mfu``; ``sample_device_memory``
  the ``device.hbm_*`` gauges; ``measure_step_flops`` and
  ``default_peak_flops``, 989e12 on the H100 SXM);
- metric time-series and health detectors (``timeseries.py``:
  ``SeriesRecorder``; ``health.py``: ``HealthMonitor`` over
  ``HealthRule`` s, PTL601–PTL604, fed by ``step_region`` and
  ``ServeEngine.step``);
- the dump and its renderers (``report.py``: ``dump``, ``summary``,
  ``render_report``, ``render_flight``, ``render_health``; the CLI is
  ``python -m paddle_tpu_torch.tools.metrics_report``);
- request tracing for the serving engine (``tracing.py``, ``chrome.py``)
  and SLO monitors (``slo.py``).

Usage::

    import paddle_tpu_torch.observability as obs
    obs.enable()
    timer = obs.StepTimer("train", items_per_step=b * s, unit="tokens")
    timer.measure_flops(train_step, batch)   # runs one step
    for batch in loader:
        with timer.region():
            train_step(batch)
    timer.flush()
    print(obs.summary())
    obs.dump("metrics.json")

Gating: event recording at the instrumentation sites is off by default;
:func:`enable` turns it on, and so do ``PADDLE_TPU_METRICS_DUMP``,
``PADDLE_TPU_FLIGHT_DIR`` and ``PADDLE_TPU_HEALTH`` at import (the
reference's variables). Metric objects always record when called
directly.

Not here yet, each waiting for its ROADMAP item: ``fleet.py`` (the
cross-rank aggregator ships through the elastic store, queue A item 4)
and ``opprof.py`` (replays a static ``Program`` op by op, item 7).
"""
from __future__ import annotations

import atexit
import os

from ._gate import state
from .metrics import (CLAIMED_SUBSYSTEMS, Counter, Gauge, Histogram,
                      MetricsRegistry, NAME_RE, registry)
from .events import Event, emit, events, span
from .report import (dump, dump_dict, render_flight, render_health,
                     render_report, render_trend_table, sparkline,
                     summary)
from . import flight
from .flight import FlightRecorder
from . import runtime
from .runtime import (FakeClock, StepTimer, default_peak_flops,
                      measure_step_flops, sample_device_memory,
                      step_region)
from . import slo
from .slo import SloMonitor, SloRule
from . import timeseries
from .timeseries import SeriesRecorder, merge_timeseries
from . import health
from .health import HealthMonitor, HealthRule
from . import tracing
from .tracing import (RequestTrace, ServeTracer, Span, TailExemplars,
                      check_tracing_overhead, validate_trace)
from . import chrome

__all__ = [
    "state", "enabled", "enable", "disable", "reset",
    "registry", "counter", "gauge", "histogram",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Event", "emit", "events", "span",
    "dump", "dump_dict", "render_report", "render_flight", "summary",
    "render_health", "render_trend_table", "sparkline",
    "CLAIMED_SUBSYSTEMS", "NAME_RE",
    "flight", "FlightRecorder",
    "StepTimer", "step_region", "FakeClock",
    "sample_device_memory", "measure_step_flops", "default_peak_flops",
    "slo", "SloMonitor", "SloRule",
    "timeseries", "SeriesRecorder", "merge_timeseries",
    "health", "HealthMonitor", "HealthRule",
    "tracing", "Span", "RequestTrace", "ServeTracer", "TailExemplars",
    "check_tracing_overhead", "validate_trace",
    "chrome",
]

counter = registry.counter
gauge = registry.gauge
histogram = registry.histogram


def enabled() -> bool:
    return state.on


def enable():
    """Turn on event recording at the instrumentation sites, and arm the
    crash-dump hook (idempotent; it writes nothing unless
    ``PADDLE_TPU_FLIGHT_DIR`` is set when it fires)."""
    state.on = True
    flight.install_excepthook()


def disable():
    state.on = False


_reset_hooks = []


def add_reset_hook(fn):
    """Register a callable run by :func:`reset` — instrumented modules
    use it to clear private bookkeeping."""
    _reset_hooks.append(fn)


def reset():
    """Zero all metric series, drop buffered events (both rings), the
    sampled watermarks, the steps still waiting for the card and the
    installed health monitor's history; run reset hooks."""
    registry.reset()
    from .events import clear as _clear_events

    _clear_events()
    flight.recorder.clear()
    runtime._clear_watermarks()
    runtime._pending.clear()
    health._reset_active()
    for fn in _reset_hooks:
        fn()


def _init_from_env():
    if os.environ.get("PADDLE_TPU_METRICS_DUMP"):
        state.on = True
        atexit.register(dump)
    if os.environ.get(flight.FLIGHT_DIR_ENV):
        # a configured crash-dump directory implies recording and arms
        # the excepthook, as in the reference
        state.on = True
        flight.install_excepthook()
    if health.monitor_from_env() is not None:
        # PADDLE_TPU_HEALTH implies recording: detectors read the
        # registry, which only fills while the gate is on
        state.on = True


_init_from_env()
