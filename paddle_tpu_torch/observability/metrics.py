"""Metrics registry: named counters, gauges and histograms with labels.

The port's own copy of ``paddle_tpu/observability/metrics.py`` (that
module imports nothing of jax, but the port imports nothing of
``paddle_tpu`` at all). A process-global registry of typed metric
series, separate from the reference package's registry.

Naming convention: every metric name is ``<subsystem>.<noun_verb>``
(``serve.queue_depth``). A subsystem claims its prefix by adding it to
:data:`CLAIMED_SUBSYSTEMS` next to its first metric.

Concurrency: increments are plain dict updates under the GIL. A lost
increment under a data race costs one count of telemetry, never
correctness, so the hot path takes no lock.
"""
from __future__ import annotations

import re
import sys
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

#: subsystems that have claimed a metric-name prefix in the port
CLAIMED_SUBSYSTEMS = {
    "comm",        # distributed/communication — collectives + watchdog
    "jit",         # jit/_capture.py — CUDA graph captures and their
                   # seconds, by site
    "serve",       # serve/engine.py — continuous-batching server: queue
                   # depth, TTFT, tokens/sec, preemptions, pool
                   # occupancy, batch fill, decode/prefill traces;
                   # prefix-cache sharing (prefix_hits,
                   # prefix_blocks_shared, cow_copies) and decode
                   # bursts (burst_tokens, host_roundtrips)
    "trace",       # observability/tracing.py + slo.py — request-scoped
                   # span tracing: per-phase seconds, tail exemplars,
                   # decode-gap accounting, SLO breaches, overhead guard
    "train",       # observability/runtime.py — step seconds,
                   # throughput, MFU
    "device",      # observability/runtime.py — memory gauges
                   # (device/memory.py)
    "ts",          # observability/timeseries.py — recorder
                   # self-metrics (points recorded)
    "health",      # observability/health.py — latched alerts by
                   # rule/series, detector evaluations
    "test",        # scratch names registered by the test suite
}

#: ``subsystem.noun_verb`` — two snake_case segments, one dot.
NAME_RE = re.compile(r"^[a-z][a-z0-9_]*\.[a-z][a-z0-9_]*$")

#: default histogram bucket upper bounds, in seconds (wall-time shaped:
#: sub-ms steps up to multi-minute runs).
DEFAULT_TIME_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0,
)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    if not labels:
        return ()
    items = [(k, v if type(v) is str else str(v))
             for k, v in labels.items()]
    if len(items) > 1:
        items.sort()  # canonical across call sites with other kwarg order
    return tuple(items)


class Metric:
    """Base: one named metric holding a family of labeled series."""

    kind = "metric"
    __slots__ = ("name", "doc", "_series")

    def __init__(self, name: str, doc: str = ""):
        if not NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} does not match the "
                f"'subsystem.noun_verb' scheme ({NAME_RE.pattern})")
        self.name = name
        self.doc = doc
        self._series: Dict[LabelKey, Any] = {}

    def labelsets(self) -> List[Dict[str, str]]:
        return [dict(k) for k in self._series]

    def reset(self):
        self._series.clear()

    # -- serialization ----------------------------------------------------
    def _series_dict(self, key: LabelKey, value) -> Dict[str, Any]:
        return {"labels": dict(key), "value": value}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "doc": self.doc,
            "series": [self._series_dict(k, v)
                       for k, v in sorted(self._series.items())],
        }


class Counter(Metric):
    kind = "counter"
    __slots__ = ()

    def inc(self, n: int = 1, **labels):
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0) + n

    def value(self, **labels) -> int:
        return self._series.get(_label_key(labels), 0)

    def total(self) -> int:
        return sum(self._series.values())


class Gauge(Metric):
    kind = "gauge"
    __slots__ = ()

    def set(self, value, **labels):
        self._series[_label_key(labels)] = value

    def value(self, default=None, **labels):
        return self._series.get(_label_key(labels), default)


class _HistSeries:
    __slots__ = ("count", "sum", "min", "max", "bucket_counts")

    def __init__(self, n_buckets: int):
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max = 0.0
        # one slot per bound plus the overflow (+inf) slot
        self.bucket_counts = [0] * (n_buckets + 1)


class Histogram(Metric):
    """Time/size histogram: count, sum, min, max + cumulative-free
    per-bucket counts over fixed upper bounds."""

    kind = "histogram"
    __slots__ = ("bounds",)

    def __init__(self, name: str, doc: str = "",
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        super().__init__(name, doc)
        self.bounds = tuple(sorted(float(b) for b in buckets))

    def observe(self, value: float, **labels):
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries(len(self.bounds))
        value = float(value)
        s.count += 1
        s.sum += value
        s.min = value if s.min is None else min(s.min, value)
        s.max = max(s.max, value)
        for i, b in enumerate(self.bounds):
            if value <= b:
                s.bucket_counts[i] += 1
                return
        s.bucket_counts[-1] += 1

    def time(self, **labels):
        """Context manager observing the elapsed wall seconds."""
        return _Timer(self, labels)

    def stats(self, **labels) -> Dict[str, float]:
        s = self._series.get(_label_key(labels))
        if s is None:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "avg": 0.0}
        return {"count": s.count, "sum": s.sum, "min": s.min or 0.0,
                "max": s.max, "avg": s.sum / s.count if s.count else 0.0}

    def _series_dict(self, key: LabelKey, s: _HistSeries) -> Dict[str, Any]:
        return {
            "labels": dict(key), "count": s.count, "sum": s.sum,
            "min": s.min if s.min is not None else 0.0, "max": s.max,
            "bounds": list(self.bounds), "bucket_counts": list(s.bucket_counts),
        }


class _Timer:
    __slots__ = ("_hist", "_labels", "_t0", "seconds")

    def __init__(self, hist: Histogram, labels: Dict[str, Any]):
        self._hist = hist
        self._labels = labels
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        self._hist.observe(self.seconds, **self._labels)
        return False


class MetricsRegistry:
    """Process-global metric namespace (the PD flag-registry pattern:
    ``counter()``/``gauge()``/``histogram()`` are define-or-get, so two
    modules naming the same metric share one series family — but a name
    re-claimed as a DIFFERENT kind is a hard error)."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        # name -> source files that called counter()/gauge()/histogram()
        # for it. Define-or-get means a name collision SHARES one series
        # family silently, so the registry records where each definition
        # came from, so a name claimed from more than one module
        # (accidental cross-subsystem reuse) can be found.
        self._sites: Dict[str, set] = {}

    def _define(self, cls, name: str, doc: str, **kwargs) -> Metric:
        try:
            site = sys._getframe(2).f_code.co_filename
            self._sites.setdefault(name, set()).add(site)
        except Exception:
            pass
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"cannot re-register as {cls.kind}")
            return m
        m = cls(name, doc, **kwargs)
        self._metrics[name] = m
        return m

    def counter(self, name: str, doc: str = "") -> Counter:
        return self._define(Counter, name, doc)

    def gauge(self, name: str, doc: str = "") -> Gauge:
        return self._define(Gauge, name, doc)

    def histogram(self, name: str, doc: str = "",
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS
                  ) -> Histogram:
        return self._define(Histogram, name, doc, buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def __iter__(self) -> Iterator[Metric]:
        return iter(list(self._metrics.values()))

    def __len__(self) -> int:
        return len(self._metrics)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def definition_sites(self) -> Dict[str, List[str]]:
        return {n: sorted(s) for n, s in self._sites.items()}

    def reset(self):
        """Zero every series (metric definitions stay registered)."""
        for m in self._metrics.values():
            m.reset()

    def to_dict(self) -> Dict[str, Any]:
        return {name: m.to_dict()
                for name, m in sorted(self._metrics.items())}


#: the process-global registry every subsystem registers into.
registry = MetricsRegistry()
