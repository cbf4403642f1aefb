"""Shared Chrome-trace (about:tracing / Perfetto) JSON emission.

The port's copy of ``paddle_tpu/observability/chrome.py``: the serve
tracer (``tracing.ServeTracer``) exports through it, in the same dialect
as the reference's timelines, so a trace of the port and one of the
reference can be merged and viewed side by side. The conventions this
module pins down (and the per-producer code must NOT re-invent):

- durations are "X" (complete) events with ``ts``/``dur`` in
  MICROSECONDS — producers hold seconds, the conversion lives here;
- ``pid`` is the process lane (re-mapped to the rank when traces of
  several processes are merged), ``tid`` the within-process lane
  (decode slot, op stream, ...);
- lanes are named by "M" metadata events (``process_name`` /
  ``thread_name``) so the viewer shows "serve:default / slot 3"
  instead of bare integers;
- files are the ``{"traceEvents": [...], "displayTimeUnit": "ms"}``
  envelope, written atomically (tmp + ``os.replace``) so a merge racing
  a writer never reads a torn file.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, Optional, Union

__all__ = [
    "complete_event", "process_name_event", "thread_name_event",
    "trace_dict", "write_chrome_trace",
]


def complete_event(name: str, start_seconds: float, end_seconds: float,
                   *, pid: int = 0, tid: int = 0, cat: str = "",
                   args: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """One "X" (complete) event: a named span on lane ``(pid, tid)``.

    Takes SECONDS on the producer's clock; the µs conversion the chrome
    format wants happens here and nowhere else."""
    return {
        "name": name, "ph": "X", "cat": cat,
        "pid": pid, "tid": tid,
        "ts": start_seconds * 1e6,
        "dur": (end_seconds - start_seconds) * 1e6,
        "args": dict(args) if args else {},
    }


def process_name_event(pid: int, name: str) -> Dict[str, Any]:
    """"M" metadata naming the ``pid`` lane (the per-rank process row)."""
    return {"ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": name}}


def thread_name_event(pid: int, tid: int, name: str) -> Dict[str, Any]:
    """"M" metadata naming the ``tid`` lane inside process ``pid``."""
    return {"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
            "args": {"name": name}}


def trace_dict(events: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Wrap events in the standard chrome-trace envelope."""
    return {"traceEvents": list(events), "displayTimeUnit": "ms"}


def write_chrome_trace(path: str,
                       events_or_doc: Union[Iterable[Dict[str, Any]],
                                            Dict[str, Any]]) -> str:
    """Atomically write a chrome trace file.

    Accepts either a bare event list (wrapped via :func:`trace_dict`)
    or an already-enveloped document."""
    doc = events_or_doc if isinstance(events_or_doc, dict) \
        else trace_dict(events_or_doc)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path
