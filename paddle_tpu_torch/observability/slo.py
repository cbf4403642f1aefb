"""Declarative SLO guardrails for the serving plane.

The port's copy of ``paddle_tpu/observability/slo.py``.
Production serving is run against objectives — "p99 TTFT under 200 ms",
"never below 500 tokens/sec", "preemption storms are an incident" — not
against raw histograms. This module evaluates declarative rolling-window
rules at engine step boundaries and turns a breach into every artifact
an operator needs at once:

- the ``trace.slo_breaches{rule}`` counter (one increment per breach
  *episode*: a rule latches while out of bounds and can fire again only
  after recovering);
- a ``trace.slo_breach`` structured event on the export + flight rings;
- a PTL401 diagnostic accumulated on :attr:`SloMonitor.report`;
- a flight-recorder dump with reason ``slo_breach`` — carrying the tail
  exemplars from ``observability/tracing.py``, so the post-mortem file
  already contains the span trees of the worst requests that defined
  the breached percentile.

Rule kinds (all evaluated over a trailing ``window_seconds``):

====================  ====================================================
``ttft_p99``          p99 of observed TTFTs (seconds); breach when above
                      ``threshold`` (``bound="max"``)
``tokens_per_sec``    generated tokens / window span; breach when below
                      ``threshold`` (``bound="min"``)
``pool_exhaustion_rate``  preemptions per engine step; breach when above
                      ``threshold``
====================  ====================================================

Configuration: pass ``SloRule`` objects (or plain dicts) to
``ServeEngine(slo=[...])``, or set ``PADDLE_TPU_SLO`` to inline JSON
(``[{"name": "ttft", "kind": "ttft_p99", "threshold": 0.2}]``) or to the
path of a JSON rules file.
"""
from __future__ import annotations

import collections
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from . import flight
from .events import emit
from .metrics import registry

__all__ = ["SloRule", "SloMonitor", "parse_rules", "rules_from_env",
           "SLO_ENV", "SLO_CODES", "RULE_KINDS"]

SLO_ENV = "PADDLE_TPU_SLO"

#: diagnostic codes this module emits (documented in
#: static/analysis/diagnostics.py:CODES)
SLO_CODES = ("PTL401",)

RULE_KINDS = ("ttft_p99", "tokens_per_sec", "pool_exhaustion_rate")

M_SLO_BREACHES = registry.counter(
    "trace.slo_breaches",
    "SLO rule breach episodes (a rule fires once per excursion out of "
    "bounds, re-arming on recovery), by rule")


@dataclass
class SloRule:
    """One declarative objective over a rolling window."""

    name: str                      # the rule= label breaches carry
    kind: str                      # one of RULE_KINDS
    threshold: float
    bound: str = ""                # "max" | "min"; default per kind
    window_seconds: float = 5.0
    min_samples: int = 3           # ttft_p99 only: don't judge 2 points

    def __post_init__(self):
        if self.kind not in RULE_KINDS:
            raise ValueError(
                f"SLO rule {self.name!r}: unknown kind {self.kind!r} "
                f"(expected one of {RULE_KINDS})")
        if not self.bound:
            self.bound = "min" if self.kind == "tokens_per_sec" else "max"
        if self.bound not in ("min", "max"):
            raise ValueError(
                f"SLO rule {self.name!r}: bound must be 'min' or 'max', "
                f"got {self.bound!r}")

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "kind": self.kind,
                "threshold": self.threshold, "bound": self.bound,
                "window_seconds": self.window_seconds,
                "min_samples": self.min_samples}


def parse_rules(spec) -> List[SloRule]:
    """Rules from a list of ``SloRule``/dicts, an inline JSON string, or
    a path to a JSON file holding the list."""
    if spec is None:
        return []
    if isinstance(spec, str):
        s = spec.strip()
        if not s:
            return []
        if not s.startswith("["):
            with open(s) as f:
                s = f.read()
        spec = json.loads(s)
    if isinstance(spec, dict):
        spec = [spec]
    rules = []
    for r in spec:
        rules.append(r if isinstance(r, SloRule) else SloRule(**r))
    return rules


def rules_from_env() -> List[SloRule]:
    return parse_rules(os.environ.get(SLO_ENV))


class SloMonitor:
    """Evaluates the rules at every engine step boundary.

    The engine feeds it per-step deltas (``on_step``) and raw TTFT
    observations (``observe_ttft``); everything else — windowing,
    latching, the breach artifacts — happens here. ``exemplars`` is the
    tracer's :class:`~.tracing.TailExemplars` (or None): its current
    worst span trees ride the ``slo_breach`` flight dump."""

    def __init__(self, rules, *, engine: str = "default", clock=None,
                 exemplars=None):
        import time as _time

        self.rules = parse_rules(rules)
        self.engine = str(engine)
        self._clock = clock if clock is not None else _time.perf_counter
        self.exemplars = exemplars
        self._ttfts: collections.deque = collections.deque()    # (t, v)
        self._tokens: collections.deque = collections.deque()   # (t, n)
        self._steps: collections.deque = collections.deque()    # (t, pre)
        self._latched: set = set()
        self.breaches: List[Dict[str, Any]] = []
        from ..static.analysis.diagnostics import DiagnosticReport

        self.report = DiagnosticReport()

    # -- feeding -----------------------------------------------------------
    def observe_ttft(self, seconds: float, now: Optional[float] = None):
        self._ttfts.append(
            (self._clock() if now is None else now, float(seconds)))

    def on_step(self, *, tokens: int = 0, preemptions: int = 0,
                now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Record one engine step's deltas and evaluate every rule.
        Returns the breaches that FIRED this step (newly latched)."""
        now = self._clock() if now is None else now
        self._steps.append((now, int(preemptions)))
        if tokens:
            self._tokens.append((now, int(tokens)))
        self._prune(now)
        return self._evaluate(now)

    def _prune(self, now: float):
        horizon = max(r.window_seconds for r in self.rules) \
            if self.rules else 5.0
        for ring in (self._ttfts, self._tokens, self._steps):
            while ring and ring[0][0] < now - horizon:
                ring.popleft()

    # -- evaluation --------------------------------------------------------
    def current_value(self, rule: SloRule,
                      now: Optional[float] = None) -> Optional[float]:
        """The rule's windowed value right now (None = not enough data
        to judge)."""
        now = self._clock() if now is None else now
        lo = now - rule.window_seconds
        if rule.kind == "ttft_p99":
            vals = sorted(v for t, v in self._ttfts if t >= lo)
            if len(vals) < max(1, rule.min_samples):
                return None
            idx = (len(vals) - 1) * 0.99
            i, frac = int(idx), idx - int(idx)
            hi = min(i + 1, len(vals) - 1)
            return vals[i] * (1 - frac) + vals[hi] * frac
        if rule.kind == "tokens_per_sec":
            pts = [(t, n) for t, n in self._tokens if t >= lo]
            if not pts:
                return None
            span = max(now - max(pts[0][0], lo), 1e-9)
            return sum(n for _t, n in pts) / span
        if rule.kind == "pool_exhaustion_rate":
            steps = [(t, p) for t, p in self._steps if t >= lo]
            if not steps:
                return None
            return sum(p for _t, p in steps) / len(steps)
        return None

    def _evaluate(self, now: float) -> List[Dict[str, Any]]:
        from ..static.analysis.diagnostics import Severity

        fired = []
        for rule in self.rules:
            val = self.current_value(rule, now)
            if val is None:
                continue
            breached = (val > rule.threshold if rule.bound == "max"
                        else val < rule.threshold)
            if not breached:
                self._latched.discard(rule.name)
                continue
            if rule.name in self._latched:
                continue               # still the same excursion
            self._latched.add(rule.name)
            M_SLO_BREACHES.inc(engine=self.engine, rule=rule.name)
            # key is "rule_kind", not "kind": the rec doubles as the
            # **fields of emit(), whose first parameter is the EVENT kind
            rec = {"rule": rule.name, "rule_kind": rule.kind,
                   "value": round(float(val), 6),
                   "threshold": rule.threshold, "bound": rule.bound,
                   "engine": self.engine, "at": round(now, 6)}
            self.breaches.append(rec)
            fired.append(rec)
            emit("trace.slo_breach", **rec)
            self.report.add(
                "PTL401", Severity.WARNING,
                f"SLO {rule.name!r} breached: {rule.kind} = {val:.6g} "
                f"{'>' if rule.bound == 'max' else '<'} "
                f"threshold {rule.threshold:g} "
                f"(window {rule.window_seconds:g}s, engine "
                f"{self.engine})",
                hint="the slo_breach flight dump carries the tail "
                     "exemplars — the per-phase breakdown of the worst "
                     "requests names the culprit phase",
                suggestion=rec)
            context = dict(rec)
            if self.exemplars is not None:
                context["exemplars"] = self.exemplars.to_dict()
            flight.recorder.dump(flight.REASON_SLO_BREACH,
                                 context=context)
        return fired
