"""Continuous health monitoring: declarative detectors over time-series.

The port's copy of ``paddle_tpu/observability/health.py``. The SLO
layer (``observability/slo.py``) judges serving against *fixed
objectives*; this module judges any plane against *its own history*. A
:class:`HealthMonitor` owns a :class:`~.timeseries.SeriesRecorder`,
samples it at step boundaries (``maybe_on_step`` is wired into
``obs.step_region`` and ``ServeEngine.step``), and evaluates declarative
rules over the recorded windows:

=========  ==========================================================
``drift``  z-score + relative-change gate of the recent samples
           against the window's own baseline half (PTL601 up / PTL603
           down by default)
``leak``   monotonic growth across the window with a minimum total
           rise (PTL602); sawtooth series stay quiet
``rate``   rate-of-change alarm on a counter-delta series: fires when
           the windowed sum of deltas crosses the threshold (PTL603)
=========  ==========================================================

A firing rule latches (one alert per excursion, re-arming on recovery)
and produces every artifact at once: the ``health.alerts{rule,series}``
counter, a ``health.alert`` structured event, a PTL6xx diagnostic on
:attr:`HealthMonitor.report` (codes of ``static/analysis/diagnostics.py``
``CODES``), and a flight dump with reason ``health_alert`` whose context
carries the offending series window. A rule whose series is missing or
non-finite files PTL604 once instead of evaluating garbage.

The hook runs on the host after a step (in the serving loop: after the
tick's replay, outside any captured graph) and reads only registry
values, never a device value, so it adds no sync.

Enablement: ``PADDLE_TPU_HEALTH=1`` installs the default rules (and
implies ``obs.enable()``); set it to inline JSON or a JSON-file path
for custom rules. Unset, no monitor exists and the step hooks reduce
to one global load + None check.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from . import flight
from .events import emit
from .metrics import registry
from .timeseries import SeriesRecorder

__all__ = ["HealthRule", "HealthMonitor", "parse_rules", "default_rules",
           "rules_from_env", "monitor_from_env", "install",
           "active_monitor", "maybe_on_step", "HEALTH_ENV",
           "HEALTH_CODES", "RULE_KINDS"]

HEALTH_ENV = "PADDLE_TPU_HEALTH"

#: diagnostic codes of the health layer (the reference's
#: tools/bench_compare.py emits PTL605) — documented in
#: static/analysis/diagnostics.py CODES.
HEALTH_CODES = ("PTL601", "PTL602", "PTL603", "PTL604", "PTL605")

RULE_KINDS = ("drift", "leak", "rate")

M_ALERTS = registry.counter(
    "health.alerts",
    "health-detector alert episodes (a rule fires once per excursion, "
    "re-arming on recovery), by rule and series")
M_EVALS = registry.counter(
    "health.evaluations",
    "health-rule evaluation passes (one per sampled step boundary), "
    "by rule")


@dataclass
class HealthRule:
    """One declarative detector over a recorded series."""

    name: str                      # the rule= label alerts carry
    kind: str                      # one of RULE_KINDS
    series: str                    # SeriesRecorder series name
    code: str = ""                 # PTL6xx; default per kind/direction
    direction: str = "up"          # drift only: "up" | "down" is bad
    min_points: int = 8            # don't judge a thin window
    threshold_z: float = 4.0       # drift: z-score gate
    rel_min: float = 0.05          # drift: minimum relative change
    min_growth_pct: float = 10.0   # leak: total rise across window (%)
    window_points: int = 8         # rate: trailing deltas summed
    threshold: float = 1.0         # rate: fires when windowed sum >= this

    def __post_init__(self):
        if self.kind not in RULE_KINDS:
            raise ValueError(
                f"health rule {self.name!r}: unknown kind {self.kind!r} "
                f"(expected one of {RULE_KINDS})")
        if self.direction not in ("up", "down"):
            raise ValueError(
                f"health rule {self.name!r}: direction must be 'up' or "
                f"'down', got {self.direction!r}")
        if not self.code:
            if self.kind == "leak":
                self.code = "PTL602"
            elif self.kind == "rate":
                self.code = "PTL603"
            else:
                self.code = "PTL601" if self.direction == "up" \
                    else "PTL603"

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "kind": self.kind,
                "series": self.series, "code": self.code,
                "direction": self.direction,
                "min_points": self.min_points,
                "threshold_z": self.threshold_z, "rel_min": self.rel_min,
                "min_growth_pct": self.min_growth_pct,
                "window_points": self.window_points,
                "threshold": self.threshold}


def default_rules() -> List[HealthRule]:
    """The detector set ``PADDLE_TPU_HEALTH=1`` installs."""
    return [
        HealthRule("step_time_drift", "drift", "train.step_seconds",
                   direction="up"),
        HealthRule("serve_throughput_drift", "drift",
                   "serve.tokens_per_sec", direction="down"),
        HealthRule("hbm_watermark_leak", "leak",
                   "device.hbm_watermark_bytes"),
        HealthRule("kv_pool_leak", "leak", "serve.pool_occupancy"),
        HealthRule("steps_lost_rate", "rate", "elastic.steps_lost",
                   threshold=8.0),
        HealthRule("ship_failure_rate", "rate", "fleet.ship_failures",
                   threshold=4.0),
    ]


def parse_rules(spec) -> List[HealthRule]:
    """Rules from a list of ``HealthRule``/dicts, an inline JSON string,
    a JSON-file path, or the literal enable values (``1``/``true``) for
    the defaults — the ``slo.parse_rules`` contract."""
    if spec is None:
        return []
    if isinstance(spec, str):
        s = spec.strip()
        if not s or s in ("0", "false", "off"):
            return []
        if s in ("1", "true", "on", "default"):
            return default_rules()
        if not s.startswith("["):
            with open(s) as f:
                s = f.read()
        spec = json.loads(s)
    if isinstance(spec, dict):
        spec = [spec]
    return [r if isinstance(r, HealthRule) else HealthRule(**r)
            for r in spec]


def rules_from_env() -> List[HealthRule]:
    return parse_rules(os.environ.get(HEALTH_ENV))


class HealthMonitor:
    """Samples the recorder and evaluates every rule at step boundaries.

    One ``on_step()`` = one recorder sample + one evaluation pass.
    Detectors are windowed over the recorder's ring, so memory stays
    bounded and a restarted excursion re-fires only after recovery
    (the ``_latched`` set, same episode semantics as ``SloMonitor``)."""

    def __init__(self, rules=None, *, recorder: Optional[SeriesRecorder]
                 = None, clock=None):
        self.rules = parse_rules(rules) if rules is not None \
            else default_rules()
        self.recorder = recorder if recorder is not None \
            else SeriesRecorder(clock=clock)
        self._latched: set = set()
        self._malformed: set = set()    # rules that already filed PTL604
        self.alerts: List[Dict[str, Any]] = []
        # the DiagnosticReport is created on first access:
        # monitor_from_env() runs at package-import time, where pulling
        # static.analysis in would be a circular import
        self._report = None

    @property
    def report(self):
        if self._report is None:
            from ..static.analysis.diagnostics import DiagnosticReport

            self._report = DiagnosticReport()
        return self._report

    # -- driving -----------------------------------------------------------
    def on_step(self, now: Optional[float] = None
                ) -> List[Dict[str, Any]]:
        """Sample the tracked series and evaluate every rule. Returns
        the alerts that FIRED this step (newly latched)."""
        self.recorder.sample(now)
        t = now if now is not None else self.recorder._clock()
        fired = []
        for rule in self.rules:
            M_EVALS.inc(rule=rule.name)
            rec = self._evaluate(rule, t)
            if rec is not None:
                fired.append(rec)
        return fired

    # -- detector math -----------------------------------------------------
    def _judge(self, rule: HealthRule,
               values: Sequence[float]) -> Optional[Dict[str, Any]]:
        """None = healthy / not enough data; dict = breach details."""
        if rule.kind == "rate":
            window = values[-rule.window_points:]
            if not window:
                return None
            total = sum(window)
            if total >= rule.threshold:
                return {"value": total, "threshold": rule.threshold,
                        "detail": f"sum of last {len(window)} deltas"}
            return None
        if len(values) < rule.min_points:
            return None
        if rule.kind == "leak":
            lo, hi = values[0], values[-1]
            for a, b in zip(values, values[1:]):
                if b < a:
                    return None       # freed at least once: sawtooth
            base = abs(lo) if lo else 1.0
            growth_pct = 100.0 * (hi - lo) / base
            if hi > lo and growth_pct >= rule.min_growth_pct:
                return {"value": hi, "growth_pct": round(growth_pct, 3),
                        "detail": f"monotonic {lo:g} -> {hi:g} over "
                                  f"{len(values)} samples"}
            return None
        # drift: baseline = first half of window, recent = last 3 points
        half = max(rule.min_points // 2, len(values) // 2)
        baseline = values[:half]
        recent = values[-min(3, len(values) - half):]
        if not baseline or not recent:
            return None
        bmean = sum(baseline) / len(baseline)
        bvar = sum((v - bmean) ** 2 for v in baseline) / len(baseline)
        bstd = max(math.sqrt(bvar), 0.01 * abs(bmean), 1e-12)
        rmean = sum(recent) / len(recent)
        z = (rmean - bmean) / bstd
        rel = (rmean - bmean) / abs(bmean) if bmean else 0.0
        if rule.direction == "down":
            z, rel = -z, -rel
        if z >= rule.threshold_z and rel >= rule.rel_min:
            return {"value": rmean, "baseline": round(bmean, 9),
                    "z": round(z, 3), "rel_change": round(rel, 4),
                    "detail": f"{'+' if rule.direction == 'up' else '-'}"
                              f"{100 * rel:.1f}% vs baseline, "
                              f"z={z:.1f}"}
        return None

    def _evaluate(self, rule: HealthRule,
                  now: float) -> Optional[Dict[str, Any]]:
        from ..static.analysis.diagnostics import Severity

        window = self.recorder.window(rule.series)
        values = [v for _t, v in window]
        bad = [v for v in values
               if not isinstance(v, (int, float)) or not math.isfinite(v)]
        if bad:
            if rule.name not in self._malformed:
                self._malformed.add(rule.name)
                self.report.add(
                    "PTL604", Severity.WARNING,
                    f"health rule {rule.name!r}: series {rule.series!r} "
                    f"carries {len(bad)} non-finite/non-numeric "
                    f"point(s) — detector cannot evaluate",
                    hint="a NaN step time or gauge usually means the "
                         "instrumented site computed 0/0; fix the "
                         "producer, the detector will resume on its own")
            return None
        breach = self._judge(rule, values)
        if breach is None:
            self._latched.discard(rule.name)
            return None
        if rule.name in self._latched:
            return None                # still the same excursion
        self._latched.add(rule.name)
        M_ALERTS.inc(rule=rule.name, series=rule.series)
        # "rule_kind", not "kind": the rec doubles as emit() **fields
        rec = {"rule": rule.name, "rule_kind": rule.kind,
               "series": rule.series, "code": rule.code,
               "at": round(now, 6), **breach}
        self.alerts.append(rec)
        emit("health.alert", **rec)
        self.report.add(
            rule.code, Severity.WARNING,
            f"health rule {rule.name!r} fired on {rule.series!r}: "
            f"{breach['detail']} (value {breach['value']:.6g})",
            hint="the health_alert flight dump context carries the "
                 "offending series window; render it with "
                 "python -m paddle_tpu_torch.tools.metrics_report "
                 "--health",
            suggestion={"rule": rule.to_dict(), **breach})
        flight.recorder.dump(
            flight.REASON_HEALTH_ALERT,
            context={**rec,
                     "window": [[round(t, 6), v] for t, v in window]})
        return rec


# -- process-global monitor (the step_region/ServeEngine hook target) ----
_active: Optional[HealthMonitor] = None


def install(monitor: Optional[HealthMonitor]) -> Optional[HealthMonitor]:
    """Install (or clear, with None) the process-global monitor that
    ``maybe_on_step`` drives. Returns the monitor for chaining."""
    global _active
    _active = monitor
    return monitor


def active_monitor() -> Optional[HealthMonitor]:
    return _active


def maybe_on_step(now: Optional[float] = None) -> None:
    """Step-boundary hook: one global load + None check when health
    monitoring is off — the zero-overhead contract."""
    mon = _active
    if mon is None:
        return
    try:
        mon.on_step(now)
    except Exception:
        pass  # telemetry must never take down the training/serving loop


def monitor_from_env() -> Optional[HealthMonitor]:
    """Build + install a monitor from ``PADDLE_TPU_HEALTH`` (None and
    no-op when the env is unset/disabled)."""
    rules = rules_from_env()
    if not rules:
        return None
    return install(HealthMonitor(rules))


def _reset_active() -> None:
    """obs.reset() support: clear the installed monitor's state (rules
    and recorder capacity survive; history, latches and alerts do not)."""
    mon = _active
    if mon is None:
        return
    mon.recorder.clear()
    mon._latched.clear()
    mon._malformed.clear()
    mon.alerts.clear()
    mon._report = None
