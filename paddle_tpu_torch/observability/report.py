"""Metrics dump (JSON) + human summary rendering.

The port's copy of ``paddle_tpu/observability/report.py``, whole:
``dump()`` serializes the registry plus the event ring buffer into one
JSON document; ``render_report()`` turns that document (live or
re-loaded from disk: ``python -m paddle_tpu_torch.tools.metrics_report``)
into the human table, so the dump round-trips by construction.
``render_flight()`` does the same for flight-recorder crash dumps and
``render_health()`` for the recorded time-series and health alerts. The
renderers produce the reference's text for the same dump dict, so a dump
of either package reads the same.

Rows are grouped by subsystem (the ``<subsystem>.`` metric-name prefix),
value columns are unit-aware (``*_seconds`` renders ms/s, ``*_bytes``
renders KiB/MiB/GiB, everything else raw), and ``top=N`` keeps only the
N largest series per metric. ``dump_dict`` first records the
device-timed steps still waiting for the card
(``runtime.flush_steps``), so a dump holds every bracketed step.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from . import _gate
from .events import events as _list_events
from .metrics import registry

DUMP_ENV = "PADDLE_TPU_METRICS_DUMP"
DUMP_VERSION = 1


def dump_dict() -> Dict[str, Any]:
    from .runtime import flush_steps

    flush_steps()
    d = {
        "version": DUMP_VERSION,
        "generated_unix": time.time(),
        "enabled": _gate.state.on,
        "metrics": registry.to_dict(),
        "events": [e.to_dict() for e in _list_events()],
    }
    from . import health as _health

    mon = _health.active_monitor()
    if mon is not None:
        # only when health monitoring is on — an unmonitored process
        # dumps byte-identical documents (solo equivalence)
        d["timeseries"] = mon.recorder.to_dict()
        d["health_alerts"] = list(mon.alerts)
    return d


def dump(path: Optional[str] = None) -> Dict[str, Any]:
    """Serialize all metrics + events; write JSON to ``path`` (or the
    ``PADDLE_TPU_METRICS_DUMP`` env path) when one is given. Always
    returns the dump dict."""
    d = dump_dict()
    path = path or os.environ.get(DUMP_ENV)
    if path:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(d, f, indent=1, default=str)
        os.replace(tmp, path)
    return d


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_secs(s: float) -> str:
    return f"{s * 1e3:.3f}ms" if s < 1.0 else f"{s:.3f}s"


def _fmt_bytes(b: float) -> str:
    b = float(b)
    for unit, div in (("GiB", 2**30), ("MiB", 2**20), ("KiB", 2**10)):
        if abs(b) >= div:
            return f"{b / div:.2f}{unit}"
    return f"{b:.0f}B"


def _fmt_raw(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _value_formatter(name: str):
    """Unit from the metric-name suffix (the `noun_verb` convention makes
    `_seconds` / `_bytes` the unit authority)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf.endswith("seconds"):
        return _fmt_secs
    if leaf.endswith("bytes"):
        return _fmt_bytes
    return _fmt_raw


_WIDTH = 64


def _trim(rows: List, top: Optional[int]) -> Tuple[List, int]:
    """Keep the ``top`` largest rows (rows pre-sorted desc); returns
    (kept, dropped_count)."""
    if top is None or top <= 0 or len(rows) <= top:
        return rows, 0
    return rows[:top], len(rows) - top


def render_report(d: Dict[str, Any], max_events: int = 20,
                  top: Optional[int] = None) -> str:
    """Human table over a dump dict (live or loaded from a JSON file),
    grouped by metric subsystem. ``top`` keeps only the N largest series
    per metric (by count/value)."""
    metrics = d.get("metrics", {}) if isinstance(d, dict) else None
    if not isinstance(metrics, dict):
        raise ValueError("not a metrics dump: no 'metrics' mapping")

    # subsystem -> list of (kind, row...) preserving per-metric blocks
    groups: Dict[str, Dict[str, List]] = {}
    for name in sorted(metrics):
        m = metrics[name]
        kind = m.get("kind")
        sub = name.split(".", 1)[0]
        g = groups.setdefault(sub, {"counter": [], "gauge": [],
                                    "histogram": []})
        fmt = _value_formatter(name)
        series = m.get("series", [])
        if kind == "counter":
            rows = sorted(
                ((name + _fmt_labels(s.get("labels", {})),
                  s.get("value", 0)) for s in series),
                key=lambda r: -_as_num(r[1]))
            rows, dropped = _trim(rows, top)
            g["counter"] += [(n, fmt(v)) for n, v in rows]
            if dropped:
                g["counter"].append((f"  ... {dropped} more series", ""))
        elif kind == "gauge":
            rows = sorted(
                ((name + _fmt_labels(s.get("labels", {})),
                  s.get("value")) for s in series),
                key=lambda r: -_as_num(r[1]))
            rows, dropped = _trim(rows, top)
            g["gauge"] += [(n, fmt(v) if v is not None else "-")
                           for n, v in rows]
            if dropped:
                g["gauge"].append((f"  ... {dropped} more series", ""))
        elif kind == "histogram":
            rows = []
            for s in series:
                cnt = s.get("count", 0)
                total = s.get("sum", 0.0) or 0.0
                avg = total / cnt if cnt else 0.0
                rows.append((name + _fmt_labels(s.get("labels", {})),
                             cnt, total, avg, s.get("max", 0.0) or 0.0))
            rows.sort(key=lambda r: -_as_num(r[1]))
            rows, dropped = _trim(rows, top)
            g["histogram"] += [
                (n, str(c), fmt(t), fmt(a), fmt(mx))
                for n, c, t, a, mx in rows]
            if dropped:
                g["histogram"].append(
                    (f"  ... {dropped} more series", "", "", "", ""))

    lines: List[str] = []
    for sub in sorted(groups):
        g = groups[sub]
        if not (g["counter"] or g["gauge"] or g["histogram"]):
            continue
        if lines:
            lines.append("")
        lines.append(f"=== {sub} ===")
        if sub == "opt":
            opt_lines = render_opt_table(metrics)
            if opt_lines:
                lines += opt_lines + [""]
        if sub == "cost":
            cost_lines = render_cost_table(metrics)
            if cost_lines:
                lines += cost_lines + [""]
            comm_lines = render_comm_table(metrics)
            if comm_lines:
                lines += comm_lines + [""]
        if g["counter"]:
            lines += ["Counters", "-" * (_WIDTH + 14)]
            lines += [f"{n[:_WIDTH]:<{_WIDTH}}{v:>14}"
                      for n, v in g["counter"]]
        if g["gauge"]:
            if g["counter"]:
                lines.append("")
            lines += ["Gauges", "-" * (_WIDTH + 14)]
            lines += [f"{n[:_WIDTH]:<{_WIDTH}}{v:>14}"
                      for n, v in g["gauge"]]
        if g["histogram"]:
            if g["counter"] or g["gauge"]:
                lines.append("")
            header = (f"{'Histogram':<{_WIDTH}}{'Count':>8}{'Total':>12}"
                      f"{'Avg':>12}{'Max':>12}")
            lines += [header, "-" * len(header)]
            lines += [f"{n[:_WIDTH]:<{_WIDTH}}{c:>8}{t:>12}{a:>12}{mx:>12}"
                      for n, c, t, a, mx in g["histogram"]]
    lines_events = _render_events(d.get("events", []), max_events)
    if lines_events:
        if lines:
            lines.append("")
        lines += lines_events
    if not lines:
        lines = ["(no metrics recorded)"]
    return "\n".join(lines)


def _as_num(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return 0.0


def render_opt_table(metrics: Dict[str, Any]) -> List[str]:
    """Per-code fixed/remaining table for the lint->rewrite loop
    (``opt.findings_fixed`` / ``opt.findings_remaining``), rendered next
    to the per-pass timing view inside the ``opt`` subsystem section —
    the at-a-glance answer to "what did optimize_program actually fix,
    and what is still outstanding"."""
    def by_code(name):
        out = {}
        for s in (metrics.get(name) or {}).get("series", []):
            code = (s.get("labels") or {}).get("code")
            if code is not None:
                out[code] = s.get("value", 0)
        return out

    fixed = by_code("opt.findings_fixed")
    remaining = by_code("opt.findings_remaining")
    if not fixed and not remaining:
        return []
    header = f"{'code':<10}{'fixed':>10}{'remaining':>12}"
    lines = ["lint -> rewrite, findings by code", header,
             "-" * len(header)]
    for code in sorted(set(fixed) | set(remaining)):
        rem = remaining.get(code)
        lines.append(f"{code:<10}{fixed.get(code, 0):>10}"
                     f"{'-' if rem is None else rem:>12}")
    return lines


def render_cost_table(metrics: Dict[str, Any]) -> List[str]:
    """Predicted-vs-measured FLOPs/HBM table for the static cost model
    (``cost.predicted_*`` vs ``cost.measured_*`` gauges, by program
    name), rendered inside the ``cost`` subsystem section next to the
    ``opt`` per-code view — the at-a-glance answer to "is the cost
    model still telling the truth" (PTL302 fires when it is not)."""
    def by_name(metric_name):
        out = {}
        for s in (metrics.get(metric_name) or {}).get("series", []):
            name = (s.get("labels") or {}).get("name")
            if name is not None:
                out[name] = s.get("value")
        return out

    pred_f = by_name("cost.predicted_flops")
    meas_f = by_name("cost.measured_flops")
    err = by_name("cost.model_flops_error_pct")
    pred_m = by_name("cost.predicted_peak_hbm_bytes")
    meas_m = by_name("cost.measured_peak_hbm_bytes")
    pred_s = by_name("cost.predicted_step_seconds")
    meas_s = by_name("cost.measured_step_seconds")
    err_s = by_name("cost.model_step_error_pct")
    names = sorted(set(pred_f) | set(pred_m))
    step_names = sorted(set(pred_s) | set(meas_s))
    if not names and not step_names:
        return []

    def fmt(v, f=_fmt_raw):
        return "-" if v is None else f(v)

    lines: List[str] = []
    if names:
        header = (f"{'program':<16}{'pred flops':>14}{'xla flops':>14}"
                  f"{'err%':>8}{'pred peak':>12}{'measured':>12}")
        lines += ["cost model, predicted vs measured", header,
                  "-" * len(header)]
        for n in names:
            lines.append(
                f"{n[:16]:<16}{fmt(pred_f.get(n)):>14}"
                f"{fmt(meas_f.get(n)):>14}{fmt(err.get(n)):>8}"
                f"{fmt(pred_m.get(n), _fmt_bytes):>12}"
                f"{fmt(meas_m.get(n), _fmt_bytes):>12}")
    if step_names:
        header2 = (f"{'program':<16}{'pred step':>14}{'measured':>14}"
                   f"{'err%':>8}")
        if lines:
            lines.append("")
        lines += ["step-time model, predicted vs measured "
                  "(PTL304 guards the drift)", header2,
                  "-" * len(header2)]
        for n in step_names:
            lines.append(
                f"{n[:16]:<16}{fmt(pred_s.get(n), _fmt_secs):>14}"
                f"{fmt(meas_s.get(n), _fmt_secs):>14}"
                f"{fmt(err_s.get(n)):>8}")
    return lines


def render_comm_table(metrics: Dict[str, Any]) -> List[str]:
    """Per-collective predicted comm-cost table
    (``cost.comm_predicted_bytes``/``_seconds``, by program name +
    collective kind) rendered next to the cost table — the analytical
    decomposition of the step-time model's comm term, so "why is this
    placement predicted slower" reads straight off the dump."""
    rows: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for metric, col in (("cost.comm_predicted_bytes", "bytes"),
                        ("cost.comm_predicted_seconds", "seconds")):
        for s in (metrics.get(metric) or {}).get("series", []):
            labels = s.get("labels") or {}
            name, kind = labels.get("name"), labels.get("kind")
            if name is None or kind is None:
                continue
            rows.setdefault((name, kind), {})[col] = s.get("value")
    if not rows:
        return []
    header = (f"{'program':<16}{'collective':<16}{'wire bytes':>14}"
              f"{'seconds':>12}")
    lines = ["predicted comm cost, by collective kind", header,
             "-" * len(header)]
    for (name, kind) in sorted(rows, key=lambda k: (
            k[0], k[1] == "all", k[1])):  # per-kind rows, then the roll-up
        r = rows[(name, kind)]
        b, sec = r.get("bytes"), r.get("seconds")
        lines.append(
            f"{name[:16]:<16}{kind:<16}"
            f"{'-' if b is None else _fmt_bytes(b):>14}"
            f"{'-' if sec is None else _fmt_secs(float(sec)):>12}")
    return lines


#: eight-level block ramp for unicode sparklines.
SPARK_CHARS = "▁▂▃▄▅▆▇█"


def sparkline(values: List[float], width: int = 32) -> str:
    """Render a numeric series as a unicode sparkline (empty string for
    an empty series). Series longer than ``width`` are mean-downsampled
    so the whole window fits one glance."""
    vals = [_as_num(v) for v in values]
    if not vals:
        return ""
    if len(vals) > width:
        n = len(vals)
        vals = [sum(vals[i * n // width:(i + 1) * n // width])
                / max(1, (i + 1) * n // width - i * n // width)
                for i in range(width)]
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return SPARK_CHARS[0] * len(vals)
    scale = (len(SPARK_CHARS) - 1) / (hi - lo)
    return "".join(SPARK_CHARS[int((v - lo) * scale)] for v in vals)


def render_trend_table(series: Dict[str, List],
                       title: str = "Time-series") -> List[str]:
    """Trend table over ``{name: [[t, v], ...]}`` windows: point count,
    first/last values, total change, and the sparkline."""
    if not series:
        return []
    header = (f"{title:<40}{'Pts':>6}{'First':>12}{'Last':>12}"
              f"{'Change':>9}  Trend")
    lines = [header, "-" * len(header)]
    for name in sorted(series):
        points = series[name] or []
        vals = [p[1] for p in points if isinstance(p, (list, tuple))
                and len(p) == 2]
        if not vals:
            continue
        # quantile series ("train.step_seconds.p90") format like their
        # parent metric
        fmt = _value_formatter(name.rsplit(".p", 1)[0]
                               if name.rpartition(".p")[2].isdigit()
                               else name)
        first, last = _as_num(vals[0]), _as_num(vals[-1])
        change = (f"{100.0 * (last - first) / abs(first):+.1f}%"
                  if first else "-")
        lines.append(f"{name[:40]:<40}{len(vals):>6}"
                     f"{fmt(first):>12}{fmt(last):>12}{change:>9}  "
                     f"{sparkline(vals)}")
    return lines


def render_health(d: Dict[str, Any]) -> str:
    """Health view of a dump: the recorded time-series as trend tables
    plus any alerts. Accepts a metrics dump carrying ``timeseries``
    (``PADDLE_TPU_HEALTH`` runs), a ``health_alert`` flight dump (the
    offending window rides the context), or a fleet dump whose
    ``timeseries`` holds per-rank lanes."""
    from .flight import FLIGHT_DUMP_KIND

    lines: List[str] = []
    if isinstance(d, dict) and d.get("kind") == FLIGHT_DUMP_KIND:
        ctx = d.get("context") or {}
        lines.append(f"HEALTH ALERT — rule {ctx.get('rule', '?')!r} "
                     f"({ctx.get('code', '?')}) on series "
                     f"{ctx.get('series', '?')!r}")
        detail = " ".join(
            f"{k}={v}" for k, v in sorted(ctx.items())
            if k not in ("window", "rule", "code", "series"))
        if detail:
            lines.append(detail)
        window = ctx.get("window") or []
        if window:
            lines += [""] + render_trend_table(
                {str(ctx.get("series", "series")): window},
                title="Offending window")
        return "\n".join(lines) if lines else "(no health context)"

    ts = (d or {}).get("timeseries") or {}
    series = ts.get("series")
    if series is not None:                       # per-process dump
        lines += render_trend_table(series)
    else:                                        # fleet dump: rank lanes
        lanes_by_name = {
            f"{name} [rank {rank}]": points
            for name, doc in ts.items()
            for rank, points in sorted((doc.get("lanes") or {}).items())
        }
        lines += render_trend_table(lanes_by_name,
                                    title="Time-series (per-rank lanes)")
    alerts = (d or {}).get("health_alerts") or []
    if alerts:
        if lines:
            lines.append("")
        lines.append(f"Alerts ({len(alerts)})")
        lines.append("-" * (_WIDTH + 14))
        for a in alerts:
            lines.append(
                f"{a.get('code', '?')} {a.get('rule', '?')} on "
                f"{a.get('series', '?')}: "
                + " ".join(f"{k}={v}" for k, v in sorted(a.items())
                           if k not in ("code", "rule", "series")))
    ham = (d or {}).get("metrics", {}).get("health.alerts", {})
    rows = ham.get("series") or []
    if rows:
        if lines:
            lines.append("")
        lines.append("health.alerts")
        lines.append("-" * (_WIDTH + 14))
        for s in rows:
            lines.append(f"{_fmt_labels(s.get('labels', {})):<{_WIDTH}}"
                         f"{s.get('value', 0):>14}")
    if not lines:
        return ("(no time-series recorded — set PADDLE_TPU_HEALTH=1 "
                "or install a HealthMonitor)")
    return "\n".join(lines)


def _render_events(evs: List[Dict[str, Any]], max_events: int) -> List[str]:
    if not evs or max_events <= 0:
        return []
    lines = [f"Events (last {min(max_events, len(evs))} of {len(evs)})",
             "-" * (_WIDTH + 14)]
    for e in evs[-max_events:]:
        e = dict(e)
        ts, kind = e.pop("ts", 0.0), e.pop("kind", "?")
        fields = " ".join(f"{k}={v}" for k, v in e.items())
        lines.append(f"{time.strftime('%H:%M:%S', time.localtime(_as_num(ts)))} "
                     f"{kind}: {fields}")
    return lines


def render_flight(d: Dict[str, Any], max_events: int = 50,
                  top: Optional[int] = None) -> str:
    """Human rendering of a flight-recorder crash dump
    (``observability.flight.FlightRecorder.dump``): the post-mortem
    header (reason, pid, exception), the last-N event trail, then the
    metrics snapshot through the normal grouped renderer."""
    from .flight import FLIGHT_DUMP_KIND

    if not isinstance(d, dict) or d.get("kind") != FLIGHT_DUMP_KIND:
        raise ValueError("not a flight-recorder dump: kind != "
                         f"{FLIGHT_DUMP_KIND!r}")
    reason = d.get("reason", "?")
    lines = [f"FLIGHT RECORDER DUMP — reason: {reason}",
             f"pid {d.get('pid', '?')}  generated "
             + time.strftime("%Y-%m-%d %H:%M:%S",
                             time.localtime(_as_num(d.get("generated_unix",
                                                          0))))]
    ctx = d.get("context")
    if ctx:
        # the exemplars payload (slo_breach dumps) is a span-tree bundle
        # and the window payload (health_alert dumps) is a point list,
        # not scalars — both render as their own blocks below the header
        lines.append("context: " + "  ".join(
            f"{k}={v}" for k, v in sorted(ctx.items())
            if k not in ("exemplars", "window")))
    # elastic-training post-mortems get a one-line interpretation so an
    # operator triaging a directory of per-worker dumps reads the story
    # without knowing the reason vocabulary
    if reason == "peer_death":
        lines.append(
            "(a peer worker's elastic heartbeat went stale; this worker "
            "dumped and exited for the coordinated restart)")
    elif reason == "rejoin":
        lines.append(
            "(this worker re-rendezvoused at a new generation and "
            "resumed from the latest checkpoint)")
    elif reason == "straggler":
        lines.append(
            "(the fleet aggregator flagged this rank as a persistent "
            "straggler — its recent step times exceeded the peer median "
            "threshold — and requested this post-mortem via the store "
            "flag)")
    elif reason == "slo_breach":
        lines.append(
            "(a serving SLO rule latched out of bounds — the context "
            "names the rule/value/threshold, and the tail exemplars "
            "below carry the span trees of the worst requests behind "
            "the breached percentile)")
        ex = (ctx or {}).get("exemplars")
        if ex:
            from .tracing import TailExemplars

            t = TailExemplars(ex.get("n", 4),
                              engine=(ctx or {}).get("engine", "?"))
            t.worst_ttft = list(ex.get("worst_ttft") or [])
            t.worst_latency = list(ex.get("worst_latency") or [])
            lines += ["", t.render()]
    elif reason == "health_alert":
        lines.append(
            "(a continuous-health detector latched — the context names "
            "the rule/series/code and the offending series window below "
            "shows the drift/leak trajectory that tripped it)")
        window = (ctx or {}).get("window")
        if window:
            lines += [""] + render_trend_table(
                {str((ctx or {}).get("series", "series")): window},
                title="Offending window")
    mem = d.get("device_memory")
    if mem:
        lines.append(
            "device memory: "
            f"in_use={_fmt_bytes(mem.get('bytes_in_use', 0))} "
            f"watermark={_fmt_bytes(mem.get('watermark_bytes', 0))} "
            f"limit={_fmt_bytes(mem.get('bytes_limit', 0))}")
    exc = d.get("exception")
    if exc:
        lines += ["", f"exception: {exc.get('type')}: {exc.get('message')}"]
        tb = exc.get("traceback") or []
        lines += [ln.rstrip("\n") for ln in tb]
    lines.append("")
    ev_lines = _render_events(d.get("events", []), max_events)
    lines += ev_lines if ev_lines else ["(empty event ring)"]
    if d.get("metrics"):
        lines += ["", render_report({"metrics": d["metrics"]},
                                    max_events=0, top=top)]
    return "\n".join(lines)


def summary(max_events: int = 20, top: Optional[int] = None) -> str:
    """Human-readable table over the live registry."""
    return render_report(dump_dict(), max_events=max_events, top=top)
