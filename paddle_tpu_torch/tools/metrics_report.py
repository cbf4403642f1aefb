"""Render a paddle_tpu_torch.observability metrics dump as a human report.

The port's counterpart of the reference's ``tools/metrics_report.py``,
over the port's ``observability.report`` renderers (which produce the
reference's text for the same dump)::

    python -m paddle_tpu_torch.tools.metrics_report metrics.json [--events N] [--top N]
    python -m paddle_tpu_torch.tools.metrics_report flight-1234-1.json
    python -m paddle_tpu_torch.tools.metrics_report /tmp/flight_dir
    python -m paddle_tpu_torch.tools.metrics_report --serve-trace /tmp/serve_trace
    python -m paddle_tpu_torch.tools.metrics_report --health metrics.json

Input is the JSON written by ``paddle_tpu_torch.observability.dump(path)``
(or any run with ``PADDLE_TPU_METRICS_DUMP=metrics.json``), or a
flight-recorder dump written to ``PADDLE_TPU_FLIGHT_DIR``: the kind is
detected. Metric rows come out grouped by subsystem; ``--top`` keeps the
N largest series per metric. A DIRECTORY renders every
``flight-*.json`` in it after a one-line index. ``--serve-trace`` renders
a ``ServeTracer`` dump (``serve_requests.json`` or its directory) and
runs the PTL404/PTL405 serve-trace lint. ``--health`` renders the
recorded time-series as trend tables with sparklines, the fired alerts
and the ``health.alerts`` counts, from a metrics dump of a monitored run
or ``health_alert`` flight dumps. The reference's ``--fleet`` and
``--opprof`` views wait for the port's ``observability/fleet.py`` (ROADMAP
queue A item 4) and ``opprof.py`` (item 7). Exits non-zero on a file
that is no dump.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _render_flight_dir(dirname: str, events, top) -> int:
    """Render every flight dump in an incident directory, newest last,
    with a one-line index first so the story (peer_death ... rejoin)
    reads before the detail."""
    import glob

    from paddle_tpu_torch.observability.report import render_flight

    paths = sorted(glob.glob(os.path.join(dirname, "flight-*.json")))
    if not paths:
        print(f"metrics_report: no flight-*.json dumps in {dirname!r}",
              file=sys.stderr)
        return 1
    docs = []
    for path in paths:
        try:
            with open(path) as f:
                docs.append((path, json.load(f)))
        except (OSError, json.JSONDecodeError) as e:
            print(f"metrics_report: skipping {path!r}: {e}",
                  file=sys.stderr)
    docs.sort(key=lambda pd: pd[1].get("generated_unix", 0))
    print(f"{len(docs)} flight dump(s) in {dirname}:")
    for path, d in docs:
        ctx = d.get("context") or {}
        ctx_s = " ".join(f"{k}={v}" for k, v in sorted(ctx.items()))
        print(f"  {os.path.basename(path)}  reason={d.get('reason')}  "
              f"pid={d.get('pid')}  {ctx_s}")
    for path, d in docs:
        print("\n" + "=" * 72)
        print(os.path.basename(path))
        print("=" * 72)
        n_events = (len(d.get("events") or []) if events is None
                    else events)
        try:
            print(render_flight(d, max_events=n_events, top=top))
        except ValueError as e:
            print(f"metrics_report: {path!r}: {e}", file=sys.stderr)
    return 0


def _render_serve_trace(path: str) -> int:
    """Render one serve_trace dump (a ``serve_requests.json`` file or
    the ``--trace-out`` directory holding it) + the PTL404/PTL405 lint."""
    from paddle_tpu_torch.observability.tracing import render_serve_trace
    from paddle_tpu_torch.static.analysis import lint_serve_trace

    if os.path.isdir(path):
        path = os.path.join(path, "serve_requests.json")
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"metrics_report: cannot read {path!r}: {e}",
              file=sys.stderr)
        return 1
    try:
        print(render_serve_trace(doc))
        report = lint_serve_trace(doc)
    except ValueError as e:
        print(f"metrics_report: {path!r}: {e}", file=sys.stderr)
        return 1
    print()
    print(report.render(
        f"serve trace lint ({os.path.basename(path)}):"))
    return 0


def _render_health(path: str) -> int:
    """Render the health view of a dump: recorded time-series trend
    tables + sparklines, alerts, and the latched ``health.alerts``
    counts. Accepts a metrics dump from a ``PADDLE_TPU_HEALTH`` run, a
    ``health_alert`` flight dump (or a directory of flight dumps, the
    health ones selected), or a fleet_metrics.json with per-rank
    lanes."""
    from paddle_tpu_torch.observability.flight import FLIGHT_DUMP_KIND
    from paddle_tpu_torch.observability.report import render_health

    paths = [path]
    if os.path.isdir(path):
        import glob

        fleet_dump = os.path.join(path, "fleet_metrics.json")
        paths = sorted(glob.glob(os.path.join(path, "flight-*.json")))
        if os.path.exists(fleet_dump):
            paths.insert(0, fleet_dump)
        if not paths:
            print(f"metrics_report: no flight-*.json or "
                  f"fleet_metrics.json in {path!r}", file=sys.stderr)
            return 1
    shown = 0
    for p in paths:
        try:
            with open(p) as f:
                d = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"metrics_report: cannot read {p!r}: {e}",
                  file=sys.stderr)
            return 1
        if (isinstance(d, dict) and d.get("kind") == FLIGHT_DUMP_KIND
                and d.get("reason") != "health_alert"):
            continue  # directory mode: only health dumps are relevant
        if shown:
            print("\n" + "=" * 72)
        if len(paths) > 1:
            print(f"{os.path.basename(p)}:")
        print(render_health(d))
        shown += 1
    if not shown:
        print(f"metrics_report: no health_alert dumps under {path!r}",
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dump", help="JSON written by observability.dump(), a "
                                 "flight-recorder crash dump, or a "
                                 "directory of flight dumps")
    ap.add_argument("--events", type=int, default=None,
                    help="how many trailing events to show (default 20 for "
                         "metrics dumps, the full ring for flight dumps)")
    ap.add_argument("--top", type=int, default=None,
                    help="show only the N largest series per metric")
    ap.add_argument("--serve-trace", action="store_true",
                    help="treat the path as a ServeTracer dump "
                         "(serve_requests.json or the --trace-out dir): "
                         "per-phase breakdown + tail exemplars + the "
                         "PTL404/PTL405 serve-trace lint")
    ap.add_argument("--health", action="store_true",
                    help="health view: recorded metric time-series as "
                         "trend tables + sparklines, fired alerts and "
                         "latched health.alerts counts (metrics dump "
                         "from a PADDLE_TPU_HEALTH run, a health_alert "
                         "flight dump or a directory of them)")
    args = ap.parse_args(argv)

    if args.health:
        return _render_health(args.dump)

    if args.serve_trace:
        return _render_serve_trace(args.dump)

    if os.path.isdir(args.dump):
        return _render_flight_dir(args.dump, args.events, args.top)

    try:
        with open(args.dump) as f:
            d = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"metrics_report: cannot read {args.dump!r}: {e}",
              file=sys.stderr)
        return 1

    from paddle_tpu_torch.observability.flight import FLIGHT_DUMP_KIND
    from paddle_tpu_torch.observability.report import render_flight, render_report

    try:
        if isinstance(d, dict) and d.get("kind") == FLIGHT_DUMP_KIND:
            n_events = (len(d.get("events") or []) if args.events is None
                        else args.events)
            print(render_flight(d, max_events=n_events, top=args.top))
            return 0
        report = render_report(
            d, max_events=20 if args.events is None else args.events,
            top=args.top)
    except ValueError as e:
        print(f"metrics_report: {args.dump!r}: {e}", file=sys.stderr)
        return 1
    generated = d.get("generated_unix")
    if generated:
        import time

        print(f"metrics dump v{d.get('version', '?')} generated "
              f"{time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(generated))}"
              f" (enabled={d.get('enabled')})\n")
    print(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
