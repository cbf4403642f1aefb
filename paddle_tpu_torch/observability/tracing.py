"""Request-lifecycle span tracing for the serving plane.

The port's copy of ``paddle_tpu/observability/tracing.py``. The
``ServeEngine`` reports aggregate histograms (``serve.ttft_seconds`` and
friends); this module answers the question those cannot: *which*
request was slow and *why*. Every non-warmup request carries a span tree
(``Request.trace``) covering its full lifecycle —

    submit -> queue -> prefill(bucket) -> decode
                 ^                          |
                 +-- preempt <- ------------+   (pool exhausted)
                 |
                 +-> resume -> recompute -> decode -> ... -> finish

— where consecutive phases share boundaries (each transition closes the
open phase at the same timestamp that opens the next), so the leaf
durations sum to the request's total latency by construction and the
per-phase breakdown attributes ~100% of TTFT and latency to named
phases. All hooks are host-side bookkeeping on the engine's scheduler
path: nothing runs inside a captured graph (the decode tick, the
bursts, the prefill buckets), so ``serve.decode_traces`` stays pinned at
1 with tracing enabled.

Three consumers sit on top:

- **Chrome-trace export** (:meth:`ServeTracer.chrome_trace_dict`): one
  lane per decode slot plus a queue-wait lane and an engine lane of
  batched decode steps, in the same ``{"traceEvents": [...]}`` format as
  the reference's serve traces (``observability/chrome.py``).
- **Tail exemplars** (:class:`TailExemplars`): the N worst-TTFT and
  worst-latency requests keep their full span trees with a per-phase
  breakdown ("p99 request spent 82% in queue"), attached to SLO-breach
  flight dumps by ``observability/slo.py``.
- **Decode-gap accounting**: host-side time between consecutive decode
  steps while slots were runnable (``trace.decode_gap_seconds``) — the
  host time decode bursts exist to cut, linted as PTL404 by
  ``static/analysis/serve_trace_lint.py``.

Enablement: ``ServeEngine(trace=True)`` or ``PADDLE_TPU_TRACE=1``. The
tracer records through plain metric objects (always live once
constructed) because construction itself is the opt-in; overhead is
guarded by :func:`check_tracing_overhead` (PTL402, run by chip_smoke.py's
serving phase). PTL403 (:func:`validate_trace`) covers malformed trees.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import chrome
from .metrics import registry

__all__ = [
    "Span", "RequestTrace", "ServeTracer", "TailExemplars",
    "validate_trace", "check_tracing_overhead", "render_phase_table",
    "render_serve_trace", "trace_enabled_from_env", "TRACE_ENV",
    "TRACE_CODES", "PHASES",
]

TRACE_ENV = "PADDLE_TPU_TRACE"

#: diagnostic codes this module emits (documented in
#: static/analysis/diagnostics.py:CODES)
TRACE_CODES = ("PTL402", "PTL403")

#: leaf phase names a request span tree is built from, in lifecycle order
PHASES = ("queue", "prefill", "decode", "preempt", "resume", "recompute")

#: wait phases live on the queue lane of the Chrome export; the rest on
#: the slot lane the request occupied
_WAIT_PHASES = ("queue", "preempt")

# --- trace. metric subsystem (prefix claimed in CLAIMED_SUBSYSTEMS) ----
M_REQUESTS_TRACED = registry.counter(
    "trace.requests_traced",
    "finished requests that carried a full span tree")
M_SPANS = registry.counter(
    "trace.spans_recorded", "leaf lifecycle spans closed, by phase "
    "(queue/prefill/decode/preempt/resume/recompute)")
M_PHASE_SECONDS = registry.histogram(
    "trace.phase_seconds",
    "per-request wall seconds spent in each lifecycle phase — the "
    "distribution behind the tail-attribution table")
M_DECODE_GAP = registry.gauge(
    "trace.decode_gap_seconds",
    "cumulative host-side gap between consecutive decode steps while "
    "slots were runnable (the fused-decode opportunity; PTL404)")
M_EXEMPLARS = registry.gauge(
    "trace.exemplars_kept",
    "tail exemplar span trees currently retained, by kind "
    "(ttft / latency)")
M_MALFORMED = registry.counter(
    "trace.spans_malformed",
    "span-tree validation findings (PTL403), by reason")
M_OVERHEAD = registry.gauge(
    "trace.overhead_pct",
    "tokens/sec cost of tracing: 100*(off-on)/off measured by the "
    "tracing-overhead guard (PTL402 above tolerance)")


def trace_enabled_from_env() -> bool:
    """True when ``PADDLE_TPU_TRACE`` opts serving engines into tracing."""
    return os.environ.get(TRACE_ENV, "").strip().lower() not in (
        "", "0", "false", "no", "off")


@dataclass
class Span:
    """One node of a request span tree: a named phase with wall-clock
    bounds on the engine's clock and free-form attributes (slot, prefill
    bucket, preemption reason, ...)."""

    name: str
    start: float
    end: Optional[float] = None
    attrs: Dict[str, Any] = field(default_factory=dict)
    children: List["Span"] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return 0.0 if self.end is None else max(self.end - self.start, 0.0)

    def close(self, t: float):
        if self.end is None:
            self.end = t

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "start": round(self.start, 9),
            "end": None if self.end is None else round(self.end, 9),
            "seconds": round(self.seconds, 9),
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class RequestTrace:
    """The span tree carried on one request (``Request.trace``).

    A ``request`` root span brackets submit->finish; leaf phases are its
    ordered children. Transitions are atomic — :meth:`begin_phase`
    closes the open phase at the timestamp that starts the next — so
    leaf durations tile the root exactly and attribution is loss-free.
    Every mutator is a no-op after :meth:`finish` (a late hook from the
    engine must not re-open a closed tree)."""

    __slots__ = ("request_id", "root", "open", "finished",
                 "first_token_time")

    def __init__(self, request_id: int, submit_time: float):
        self.request_id = request_id
        self.root = Span("request", submit_time)
        self.open: Optional[Span] = None
        self.finished = False
        self.first_token_time: Optional[float] = None

    def begin_phase(self, name: str, t: float, **attrs) -> Optional[Span]:
        if self.finished:
            return None
        if self.open is not None:
            self.open.close(t)
        s = Span(name, t, attrs=dict(attrs))
        self.root.children.append(s)
        self.open = s
        return s

    def annotate(self, **attrs):
        """Attach attributes to the currently open phase (e.g. the
        prefill bucket, known only once the padded shape is computed)."""
        if self.open is not None and not self.finished:
            self.open.attrs.update(attrs)

    def finish(self, t: float, reason: Optional[str] = None):
        if self.finished:
            return
        if self.open is not None:
            self.open.close(t)
            self.open = None
        self.root.close(t)
        if reason is not None:
            self.root.attrs["finish_reason"] = reason
        self.finished = True

    # -- attribution -------------------------------------------------------
    def phase_seconds(self) -> Dict[str, float]:
        """Total seconds per leaf phase name (a request can visit
        decode/preempt/resume/recompute several times)."""
        out: Dict[str, float] = {}
        for c in self.root.children:
            out[c.name] = out.get(c.name, 0.0) + c.seconds
        return out

    def attributed_seconds(self, upto: Optional[float] = None
                           ) -> Dict[str, float]:
        """Per-phase seconds clipped to ``[root.start, upto]`` — with
        ``upto=first_token_time`` this is the TTFT attribution."""
        if upto is None:
            return self.phase_seconds()
        out: Dict[str, float] = {}
        for c in self.root.children:
            end = upto if c.end is None else min(c.end, upto)
            ov = max(end - c.start, 0.0)
            if ov > 0:
                out[c.name] = out.get(c.name, 0.0) + ov
        return out


def _attributed_pct(breakdown: Dict[str, float], total: float
                    ) -> Optional[float]:
    if total is None or total <= 0:
        return None
    return round(100.0 * min(sum(breakdown.values()) / total, 1.0), 2)


class TailExemplars:
    """Keeps the N worst-TTFT and N worst-latency request span trees.

    ``offer()`` takes the finished-request doc the tracer builds; both
    lists stay sorted worst-first so the report reads p-worst down."""

    def __init__(self, n: int = 4, engine: str = "default"):
        self.n = max(1, int(n))
        self.engine = engine
        self.worst_ttft: List[Dict[str, Any]] = []
        self.worst_latency: List[Dict[str, Any]] = []

    def _insert(self, lst: List[Dict[str, Any]], doc: Dict[str, Any],
                key: str):
        v = doc.get(key)
        if v is None:
            return
        keys = [-(d[key]) for d in lst]
        lst.insert(bisect.bisect_right(keys, -v), doc)
        del lst[self.n:]

    def offer(self, doc: Dict[str, Any]):
        self._insert(self.worst_ttft, doc, "ttft_seconds")
        self._insert(self.worst_latency, doc, "latency_seconds")
        M_EXEMPLARS.set(len(self.worst_ttft), engine=self.engine,
                        kind="ttft")
        M_EXEMPLARS.set(len(self.worst_latency), engine=self.engine,
                        kind="latency")

    def to_dict(self) -> Dict[str, Any]:
        return {"n": self.n, "worst_ttft": list(self.worst_ttft),
                "worst_latency": list(self.worst_latency)}

    def render(self) -> str:
        lines = [f"tail exemplars (engine={self.engine}, "
                 f"keeping worst {self.n}):"]
        for title, lst, key, bkey in (
                ("worst TTFT", self.worst_ttft, "ttft_seconds",
                 "ttft_breakdown"),
                ("worst latency", self.worst_latency, "latency_seconds",
                 "breakdown")):
            lines.append(f"  {title}:")
            if not lst:
                lines.append("    (none)")
                continue
            for d in lst:
                total = d.get(key) or 0.0
                parts = sorted((d.get(bkey) or {}).items(),
                               key=lambda kv: -kv[1])
                split = ", ".join(
                    f"{name} {100 * sec / total:.0f}% ({sec * 1e3:.1f} ms)"
                    for name, sec in parts if total > 0)
                lines.append(
                    f"    req {d.get('id')}: {total * 1e3:.1f} ms "
                    f"[{d.get('preemptions', 0)} preemption(s)]"
                    + (f" — {split}" if split else ""))
        return "\n".join(lines)


class ServeTracer:
    """Request-scoped span tracer for one :class:`~paddle_tpu_torch.
    serve.engine.ServeEngine` (the engine calls the ``on_*`` hooks from its
    scheduler path; all of them are host-side and O(1)).

    Retention is bounded: finished-request docs ride a ring
    (``max_requests``), decode-step records another (``max_decode_steps``),
    and only the tail exemplars keep full span trees indefinitely."""

    def __init__(self, engine: str = "default", clock=None, *,
                 max_slots: int = 0, exemplars: int = 4,
                 max_requests: int = 1024, max_decode_steps: int = 8192):
        import time as _time

        self.engine = str(engine)
        self._clock = clock if clock is not None else _time.perf_counter
        self.max_slots = int(max_slots)
        self.exemplars = TailExemplars(exemplars, engine=self.engine)
        self.requests: collections.deque = collections.deque(
            maxlen=max(1, int(max_requests)))
        self.decode_steps: collections.deque = collections.deque(
            maxlen=max(1, int(max_decode_steps)))
        self.total_decode_gap = 0.0
        self.n_traced = 0
        self._last_step_end: Optional[float] = None
        self._last_step_active = 0

    # -- engine hooks ------------------------------------------------------
    def on_submit(self, req):
        req.trace = RequestTrace(req.id, req.submit_time)
        req.trace.begin_phase("queue", req.submit_time)

    def on_admit(self, req, slot: int, resumed: bool):
        tr = req.trace
        if tr is None:
            return
        t = self._clock()
        if resumed:
            tr.begin_phase("resume", t, slot=slot,
                           preemptions=req.preemptions)
        else:
            tr.begin_phase("prefill", t, slot=slot)

    def on_prefill(self, req, bucket: int, tokens: int):
        tr = req.trace
        if tr is None:
            return
        if tr.open is not None and tr.open.name == "resume":
            # the re-prefill of prompt+generated after a preemption is
            # RECOMPUTE work, not first-time prefill — name it so the
            # breakdown bills eviction, not the prompt
            tr.begin_phase("recompute", self._clock(),
                           slot=req.slot, bucket=bucket, tokens=tokens)
        else:
            tr.annotate(bucket=bucket, tokens=tokens)

    def on_first_token(self, req, t: float):
        if req.trace is not None:
            req.trace.first_token_time = t

    def on_decode_begin(self, req):
        tr = req.trace
        if tr is None or tr.finished:
            return
        tr.begin_phase("decode", self._clock(), slot=req.slot)

    def on_preempt(self, req, reason: str = "pool_exhausted"):
        tr = req.trace
        if tr is None or tr.finished:
            return
        tr.begin_phase("preempt", self._clock(), reason=reason)

    def on_finish(self, req):
        tr = req.trace
        if tr is None:
            return
        tr.finish(req.finish_time, req.finish_reason)
        doc = self._request_doc(req)
        for c in tr.root.children:
            M_SPANS.inc(engine=self.engine, phase=c.name)
            M_PHASE_SECONDS.observe(c.seconds, engine=self.engine,
                                    phase=c.name)
        M_REQUESTS_TRACED.inc(engine=self.engine)
        self.n_traced += 1
        findings = validate_trace(doc)
        for d in findings:
            reason = (d.suggestion or {}).get("reason", "malformed")
            M_MALFORMED.inc(engine=self.engine, reason=reason)
        if findings.diagnostics:
            doc["malformed"] = [d.render() for d in findings]
        self.requests.append(doc)
        self.exemplars.offer(doc)

    def on_decode_step(self, start: float, end: float,
                       active_after: int, queued: int,
                       tokens: int = 1):
        """One batched decode dispatch on the engine lane — a single
        step, or a fused burst of ``tokens`` in-scan steps when the
        engine runs with ``decode_burst > 1`` (one host round-trip
        either way, which is exactly the point). The gap between the
        previous dispatch's end and this start, while the previous one
        left runnable slots behind, is host-side scheduler time the
        chip sat idle — the fused-decode opportunity PTL404 lints;
        bursts shrink the number of such gaps ~N x."""
        if self._last_step_end is not None and self._last_step_active > 0:
            gap = start - self._last_step_end
            if gap > 0:
                self.total_decode_gap += gap
                M_DECODE_GAP.set(round(self.total_decode_gap, 6),
                                 engine=self.engine)
        self._last_step_end = end
        self._last_step_active = int(active_after)
        self.decode_steps.append(
            {"start": round(start, 9), "end": round(end, 9),
             "active": int(active_after), "queued": int(queued),
             "tokens": int(tokens)})

    # -- per-request doc ---------------------------------------------------
    def _request_doc(self, req) -> Dict[str, Any]:
        tr = req.trace
        ttft = req.ttft
        latency = (None if req.finish_time is None
                   else req.finish_time - req.submit_time)
        breakdown = {k: round(v, 9)
                     for k, v in tr.phase_seconds().items()}
        ttft_breakdown = {
            k: round(v, 9)
            for k, v in tr.attributed_seconds(tr.first_token_time).items()}
        return {
            "id": req.id,
            "engine": self.engine,
            "submit": round(req.submit_time, 9),
            "finish": (None if req.finish_time is None
                       else round(req.finish_time, 9)),
            "finish_reason": req.finish_reason,
            "n_prompt": req.n_prompt,
            "n_generated": req.n_generated,
            "preemptions": req.preemptions,
            "ttft_seconds": None if ttft is None else round(ttft, 9),
            "latency_seconds": (None if latency is None
                                else round(latency, 9)),
            "breakdown": breakdown,
            "ttft_breakdown": ttft_breakdown,
            "ttft_attributed_pct": _attributed_pct(ttft_breakdown, ttft),
            "latency_attributed_pct": _attributed_pct(breakdown, latency),
            "spans": tr.root.to_dict(),
        }

    # -- exports -----------------------------------------------------------
    def _lane(self, span_dict: Dict[str, Any]) -> int:
        if span_dict["name"] in _WAIT_PHASES:
            return 0
        slot = (span_dict.get("attrs") or {}).get("slot")
        return 1 + int(slot) if slot is not None else 0

    def chrome_trace_events(self, pid: int = 0) -> List[Dict[str, Any]]:
        """Chrome ``traceEvents``: one lane (tid) per decode slot, a
        queue/preempt wait lane, and an engine lane of batched decode
        steps — built on the shared ``observability.chrome`` exporter,
        so the ts/dur µs conventions and lane metadata are the
        reference's (pid re-mapped per rank when traces are merged)."""
        max_lane = self.max_slots
        evs: List[Dict[str, Any]] = []
        for doc in self.requests:
            for c in (doc.get("spans") or {}).get("children", ()):
                if c.get("end") is None:
                    continue
                lane = self._lane(c)
                max_lane = max(max_lane, lane)
                evs.append(chrome.complete_event(
                    c["name"], c["start"], c["end"], cat="serve",
                    pid=pid, tid=lane,
                    args={"request": doc["id"], **(c.get("attrs") or {})}))
        engine_lane = max_lane + 1
        for s in self.decode_steps:
            evs.append(chrome.complete_event(
                "decode_step", s["start"], s["end"], cat="serve",
                pid=pid, tid=engine_lane,
                args={"active": s["active"], "queued": s["queued"],
                      "tokens": s.get("tokens", 1)}))
        meta = [chrome.process_name_event(pid, f"serve:{self.engine}"),
                chrome.thread_name_event(pid, 0, "queue/preempt wait"),
                chrome.thread_name_event(pid, engine_lane,
                                         "engine (decode steps)")]
        for lane in range(1, engine_lane):
            meta.append(chrome.thread_name_event(pid, lane,
                                                 f"slot {lane - 1}"))
        return meta + evs

    def chrome_trace_dict(self, pid: int = 0) -> Dict[str, Any]:
        return chrome.trace_dict(self.chrome_trace_events(pid))

    def write_chrome_trace(self, path: str, pid: int = 0) -> str:
        return chrome.write_chrome_trace(path, self.chrome_trace_dict(pid))

    def dump_dict(self) -> Dict[str, Any]:
        return {
            "kind": "serve_trace",
            "version": 1,
            "engine": self.engine,
            "requests_traced": self.n_traced,
            "decode_gap_seconds": round(self.total_decode_gap, 6),
            "requests": list(self.requests),
            "decode_steps": list(self.decode_steps),
            "exemplars": self.exemplars.to_dict(),
        }

    def dump(self, path: str) -> str:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.dump_dict(), f, indent=1, default=str)
        os.replace(tmp, path)
        return path


# --- validation (PTL403) + overhead guard (PTL402) ------------------------

def validate_trace(doc: Dict[str, Any]):
    """Structural check of one finished-request doc: phases must close,
    nest inside the root, stay in order, and never run backwards. Emits
    PTL403 findings (each with a machine-readable ``reason`` slug the
    ``trace.spans_malformed`` counter labels by)."""
    from ..static.analysis.diagnostics import (DiagnosticReport,
                                               Severity)

    report = DiagnosticReport()

    def bad(reason, msg):
        report.add("PTL403", Severity.WARNING,
                   f"request {doc.get('id')}: {msg}",
                   hint="span-tree hooks ran out of order — a tracer "
                        "hook fired after finish() or a phase closed "
                        "before it opened",
                   suggestion={"reason": reason})

    spans = doc.get("spans") or {}
    root_start, root_end = spans.get("start"), spans.get("end")
    if root_end is None:
        bad("root_open", "root span never closed (request not finished)")
    children = spans.get("children") or []
    if not children:
        bad("no_phases", "span tree has no lifecycle phases")
    eps = 1e-9
    prev_end = None
    for c in children:
        name, s, e = c.get("name"), c.get("start"), c.get("end")
        if name not in PHASES:
            bad("unknown_phase", f"unknown phase {name!r}")
        if e is None:
            bad("phase_open", f"phase {name!r} never closed")
            continue
        if e < s - eps:
            bad("negative_span", f"phase {name!r} ends before it starts")
        if root_start is not None and s < root_start - eps:
            bad("outside_root", f"phase {name!r} starts before submit")
        if root_end is not None and e > root_end + eps:
            bad("outside_root", f"phase {name!r} ends after finish")
        if prev_end is not None and s < prev_end - eps:
            bad("overlap",
                f"phase {name!r} overlaps the previous phase")
        prev_end = e
    return report


def check_tracing_overhead(tokens_per_sec_on: float,
                           tokens_per_sec_off: float, *,
                           tolerance_pct: float = 3.0,
                           engine: str = "default"):
    """The instrumentation-cost guard: tokens/sec with tracing on must
    stay within ``tolerance_pct`` of tracing off. Publishes
    ``trace.overhead_pct`` and returns a report carrying PTL402 when the
    budget is exceeded (chip_smoke.py's serving phase runs this; a tracer
    that costs real throughput is a tracer nobody leaves enabled)."""
    from ..static.analysis.diagnostics import (DiagnosticReport,
                                               Severity)

    report = DiagnosticReport()
    if tokens_per_sec_off <= 0:
        return report
    overhead = 100.0 * (tokens_per_sec_off - tokens_per_sec_on) \
        / tokens_per_sec_off
    M_OVERHEAD.set(round(overhead, 3), engine=engine)
    if overhead > tolerance_pct:
        report.add(
            "PTL402", Severity.WARNING,
            f"tracing overhead {overhead:.2f}% exceeds the "
            f"{tolerance_pct:.1f}% budget ({tokens_per_sec_on:.1f} "
            f"tok/s traced vs {tokens_per_sec_off:.1f} untraced)",
            hint="the tracer hooks are host-side O(1); an overhead this "
                 "large means a hook landed on the per-token path or "
                 "retention bounds grew — profile the engine step",
            suggestion={"overhead_pct": round(overhead, 3),
                        "tolerance_pct": tolerance_pct})
    return report


# --- rendering ------------------------------------------------------------

def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = (len(sorted_vals) - 1) * q
    lo, hi = int(idx), min(int(idx) + 1, len(sorted_vals) - 1)
    frac = idx - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def render_phase_table(request_docs) -> str:
    """Per-phase p50/p99 table over per-request phase totals — the
    exact-sample companion to the bucket-interpolated quantiles of the
    ``trace.phase_seconds`` histogram."""
    per_phase: Dict[str, List[float]] = {}
    total_latency = 0.0
    for d in request_docs:
        for phase, sec in (d.get("breakdown") or {}).items():
            per_phase.setdefault(phase, []).append(float(sec))
        total_latency += float(d.get("latency_seconds") or 0.0)
    if not per_phase:
        return "no traced requests"
    rows = [("phase", "reqs", "p50 ms", "p99 ms", "total s", "share")]
    order = {p: i for i, p in enumerate(PHASES)}
    for phase in sorted(per_phase, key=lambda p: order.get(p, 99)):
        vals = sorted(per_phase[phase])
        tot = sum(vals)
        share = (100.0 * tot / total_latency) if total_latency > 0 else 0.0
        rows.append((phase, str(len(vals)),
                     f"{_percentile(vals, 0.50) * 1e3:.2f}",
                     f"{_percentile(vals, 0.99) * 1e3:.2f}",
                     f"{tot:.4f}", f"{share:.1f}%"))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    return "\n".join(
        "  ".join(col.rjust(w) if i else col.ljust(w)
                  for i, (col, w) in enumerate(zip(r, widths)))
        for r in rows)


def render_serve_trace(doc: Dict[str, Any]) -> str:
    """Human report for one ``serve_trace`` dump (the
    :meth:`ServeTracer.dump_dict` JSON): header, per-phase p50/p99
    breakdown, tail exemplars."""
    if doc.get("kind") != "serve_trace":
        raise ValueError(
            f"not a serve_trace dump (kind={doc.get('kind')!r})")
    reqs = doc.get("requests") or []
    lines = [
        f"serve trace (engine={doc.get('engine')}): "
        f"{doc.get('requests_traced', len(reqs))} request(s) traced, "
        f"{len(doc.get('decode_steps') or [])} decode step(s), "
        f"decode gap {float(doc.get('decode_gap_seconds') or 0) * 1e3:.1f}"
        f" ms",
        "",
        render_phase_table(reqs),
    ]
    ex = doc.get("exemplars")
    if ex:
        t = TailExemplars(ex.get("n", 4), engine=doc.get("engine", "?"))
        t.worst_ttft = list(ex.get("worst_ttft") or [])
        t.worst_latency = list(ex.get("worst_latency") or [])
        lines += ["", t.render()]
    return "\n".join(lines)
