"""Metric time-series: the time dimension of the telemetry plane.

The port's copy of ``paddle_tpu/observability/timeseries.py``. Every
other observability layer is point-in-time (one dump, one rolling SLO
window); a :class:`SeriesRecorder` keeps a bounded *history*: it samples
a tracked set of registry metrics at step boundaries (driven by the
``obs.step_region`` / ``ServeEngine.step`` hooks via
``observability/health.py``) and stores ``(t, value)`` points in
per-series ring buffers, so detectors can ask how a series has moved
instead of what it is now.

Sampling semantics by metric kind:

- **counters** are recorded as *deltas* between consecutive samples
  (the first sample only sets the baseline);
- **gauges** are recorded as *levels* (multi-labelset gauges collapse
  to the max across series, the conservative choice for watermarks and
  occupancies);
- **histograms** are recorded as *per-window* statistics from
  bucket-count deltas: the window mean under the metric's own name and
  an interpolated window quantile under ``<name>.p90``.

Memory is bounded by ``observability_ts_points`` points per series (512
unless the flag exists); the clock is injectable (``obs.FakeClock``
works). The sampling reads host-side registry values only: no device
value, so a recorder in the serving loop adds no sync.
"""
from __future__ import annotations

import collections
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import flight
from .events import ring_len as _events_ring_len
from .metrics import Counter, Gauge, Histogram, registry

M_POINTS = registry.counter(
    "ts.points_recorded",
    "time-series points recorded by SeriesRecorder, labeled by series")

#: capacity flag; read lazily at recorder construction so tests can
#: set the flag first (same pattern as events/flight ring buffers).
_CAPACITY_FLAG = "observability_ts_points"

#: registry metrics sampled by default. Unregistered names are skipped
#: silently — tracking is declarative, the subsystems stay decoupled.
DEFAULT_TRACKED = (
    "train.step_seconds",          # histogram -> window mean + .p90
    "train.items_per_second",      # gauge
    "serve.tokens_per_sec",        # gauge
    "serve.pool_occupancy",        # gauge
    "serve.queue_depth",           # gauge
    "serve.tokens_generated",      # counter -> per-window delta
    "device.hbm_watermark_bytes",  # gauge
    "elastic.steps_lost",          # counter -> per-window delta
    "fleet.ship_failures",         # counter -> per-window delta
)

#: quantile recorded for tracked histograms (as ``<name>.p90``).
HIST_QUANTILE = 0.90


def _default_capacity() -> int:
    from ..core import flags

    try:
        return max(2, int(flags.get_flag(_CAPACITY_FLAG)))
    except KeyError:
        return 512


def _resolve_clock(clock) -> Callable[[], float]:
    if clock is None:
        return time.time
    if callable(clock):
        return clock
    return clock.time  # clock object (FakeClock satisfies both)


def _bucket_quantile(bounds: Sequence[float], deltas: Sequence[int],
                     q: float) -> Optional[float]:
    """Interpolated quantile from per-window bucket-count deltas."""
    total = sum(deltas)
    if total <= 0:
        return None
    rank = q * total
    seen = 0
    lo = 0.0
    for i, n in enumerate(deltas):
        hi = bounds[i] if i < len(bounds) else bounds[-1]
        if n and seen + n >= rank:
            if i >= len(bounds):      # overflow bucket: clamp to last bound
                return float(bounds[-1])
            frac = (rank - seen) / n
            return lo + (hi - lo) * frac
        seen += n
        lo = hi
    return float(bounds[-1])


class SeriesRecorder:
    """Ring-buffered ``(t, value)`` history for a tracked metric set.

    ``record()`` appends a raw level point; ``sample()`` walks the
    tracked registry metrics applying the per-kind semantics above,
    plus two host-side ring-length probes (``host.events_ring_len`` /
    ``host.flight_ring_len``) so a Python-side buffer that stops
    honoring its bound shows up as a leak like any other series.
    """

    def __init__(self, capacity: Optional[int] = None, clock=None,
                 tracked: Optional[Sequence[str]] = None):
        self.capacity = int(capacity) if capacity else _default_capacity()
        self._clock = _resolve_clock(clock)
        self.tracked = tuple(tracked if tracked is not None
                             else DEFAULT_TRACKED)
        self._series: Dict[str, collections.deque] = {}
        self._prev_counter: Dict[str, int] = {}
        self._prev_hist: Dict[str, Tuple[int, float, Tuple[int, ...]]] = {}
        self.samples = 0

    # -- raw points -------------------------------------------------------
    def record(self, name: str, value: float,
               t: Optional[float] = None) -> None:
        dq = self._series.get(name)
        if dq is None:
            dq = self._series[name] = collections.deque(
                maxlen=self.capacity)
        dq.append((self._clock() if t is None else float(t), value))
        M_POINTS.inc(series=name)

    # -- per-kind sampling ------------------------------------------------
    def _sample_counter(self, name: str, m: Counter, now: float) -> None:
        total = m.total()
        prev = self._prev_counter.get(name)
        self._prev_counter[name] = total
        if prev is None:
            return  # baseline only: lifetime total is not a window delta
        self.record(name, total - prev, t=now)

    def _sample_gauge(self, name: str, m: Gauge, now: float) -> None:
        values = [v for v in m._series.values()
                  if isinstance(v, (int, float)) and math.isfinite(v)]
        if not values:
            return
        self.record(name, max(values), t=now)

    def _sample_histogram(self, name: str, m: Histogram,
                          now: float) -> None:
        count, total = 0, 0.0
        buckets = [0] * (len(m.bounds) + 1)
        for s in m._series.values():
            count += s.count
            total += s.sum
            for i, n in enumerate(s.bucket_counts):
                buckets[i] += n
        prev = self._prev_hist.get(name)
        self._prev_hist[name] = (count, total, tuple(buckets))
        if prev is None:
            return
        pcount, psum, pbuckets = prev
        dcount = count - pcount
        if dcount <= 0:
            return  # no observations this window: record nothing
        self.record(name, (total - psum) / dcount, t=now)
        deltas = [b - pb for b, pb in zip(buckets, pbuckets)]
        quant = _bucket_quantile(m.bounds, deltas, HIST_QUANTILE)
        if quant is not None:
            self.record(f"{name}.p90", quant, t=now)

    def sample(self, now: Optional[float] = None) -> None:
        """Take one sample of every tracked series (one step boundary)."""
        t = self._clock() if now is None else float(now)
        self.samples += 1
        for name in self.tracked:
            m = registry.get(name)
            if isinstance(m, Counter):
                self._sample_counter(name, m, t)
            elif isinstance(m, Histogram):
                self._sample_histogram(name, m, t)
            elif isinstance(m, Gauge):
                self._sample_gauge(name, m, t)
        self.record("host.events_ring_len", _events_ring_len(), t=t)
        self.record("host.flight_ring_len",
                    len(flight.recorder._ring)
                    if flight.recorder._ring is not None else 0, t=t)

    # -- access -----------------------------------------------------------
    def window(self, name: str) -> List[Tuple[float, float]]:
        return list(self._series.get(name, ()))

    def values(self, name: str) -> List[float]:
        return [v for _t, v in self._series.get(name, ())]

    def names(self) -> List[str]:
        return sorted(self._series)

    def points_total(self) -> int:
        return sum(len(dq) for dq in self._series.values())

    def clear(self) -> None:
        self._series.clear()
        self._prev_counter.clear()
        self._prev_hist.clear()
        self.samples = 0

    # -- serialization (shipped inside fleet snapshots) -------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "capacity": self.capacity,
            "samples": self.samples,
            "series": {name: [[t, v] for t, v in dq]
                       for name, dq in sorted(self._series.items())},
        }


def merge_timeseries(snapshots: Sequence[Dict[str, Any]],
                     own: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """Fold shipped per-rank histories into fleet-wide per-rank lanes.

    Returns ``{series_name: {"lanes": {rank: [[t, v], ...]}}}`` — ranks
    stay separate (a leak on rank 3 must not be averaged away by seven
    healthy peers); cross-rank reduction is the *reader's* choice.
    """
    merged: Dict[str, Dict[str, Any]] = {}

    def _fold(rank, ts_doc):
        if not isinstance(ts_doc, dict):
            return
        for name, points in (ts_doc.get("series") or {}).items():
            lane = merged.setdefault(name, {"lanes": {}})
            lane["lanes"][str(rank)] = points

    for snap in snapshots:
        _fold(snap.get("rank", "?"), snap.get("timeseries"))
    if own is not None:
        _fold(own.get("rank", "own"), own.get("timeseries"))
    return merged
