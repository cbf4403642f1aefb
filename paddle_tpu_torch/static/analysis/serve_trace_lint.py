"""Serve-trace lint: scheduling pathologies read off a serve_trace dump.

The port's copy of ``paddle_tpu/static/analysis/serve_trace_lint.py``.
It reads the ``serve_trace`` dump a
:class:`~paddle_tpu_torch.observability.tracing.ServeTracer` writes
(``ServeTracer.dump_dict()``) for the two pathologies the
continuous-batching engine can hide inside healthy-looking aggregates:

- **PTL404 — decode-burst gaps**: consecutive batched decode steps with
  host-side dead time between them while the previous step left runnable
  slots behind. The card sits idle while the host runs admission,
  sampling and bookkeeping — the signal decode bursts
  (``ServeEngine(decode_burst=N)``) answer.
- **PTL405 — preemption thrash**: one request preempted >= K times. Each
  preemption throws away that stream's KV blocks and bills a full
  recompute prefill on resume; a request evicted over and over is paying
  for pool pressure the admission policy should have absorbed.
"""
from __future__ import annotations

from typing import Any, Dict, List

from .diagnostics import DiagnosticReport, Severity

__all__ = ["lint_serve_trace", "SERVE_TRACE_LINT_CODES"]

#: codes this lint emits — documented in diagnostics.CODES
SERVE_TRACE_LINT_CODES = ("PTL404", "PTL405")

#: stop after this many PTL404 findings per dump: one systemic host-side
#: stall produces a gap after EVERY step, and 4000 copies of the same
#: finding bury the report (the truncation is announced as a NOTE)
_MAX_GAP_FINDINGS = 8


def _median(vals: List[float]) -> float:
    if not vals:
        return 0.0
    vals = sorted(vals)
    n = len(vals)
    mid = n // 2
    return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])


def lint_serve_trace(doc: Dict[str, Any], *,
                     min_gap_seconds: float = 0.010,
                     gap_ratio: float = 4.0,
                     thrash_k: int = 3) -> DiagnosticReport:
    """Lint one ``serve_trace`` dump (the ``ServeTracer.dump_dict()``
    JSON). A decode gap is flagged when it exceeds both
    ``min_gap_seconds`` and ``gap_ratio`` x the median decode-step
    duration (short host turnarounds are the engine working as designed;
    a gap several steps long is the chip waiting on the host). A request
    is thrash when preempted >= ``thrash_k`` times."""
    report = DiagnosticReport()
    if not isinstance(doc, dict) or doc.get("kind") != "serve_trace":
        raise ValueError(
            f"lint_serve_trace wants a serve_trace dump, got "
            f"kind={doc.get('kind') if isinstance(doc, dict) else type(doc).__name__!r}")

    steps = doc.get("decode_steps") or []
    durs = [float(s["end"]) - float(s["start"]) for s in steps]
    med = _median(durs)
    threshold = max(min_gap_seconds, gap_ratio * med)
    n_gaps = 0
    for prev, nxt in zip(steps, steps[1:]):
        if int(prev.get("active", 0)) <= 0:
            continue        # slots drained: waiting on arrivals, not host
        gap = float(nxt["start"]) - float(prev["end"])
        if gap <= threshold:
            continue
        n_gaps += 1
        if n_gaps <= _MAX_GAP_FINDINGS:
            report.add(
                "PTL404", Severity.WARNING,
                f"decode-burst gap: {gap * 1e3:.2f} ms host-side between "
                f"decode steps at t={float(prev['end']):.4f}s with "
                f"{prev.get('active')} runnable slot(s) "
                f"(median step {med * 1e3:.2f} ms)",
                hint="the engine loop is host-driven — one device "
                     "round-trip per token; run N-token decode bursts "
                     "(decode_burst=N) between scheduler passes so "
                     "steady-state decode stays on the device",
                suggestion={"gap_seconds": round(gap, 6),
                            "at": float(prev["end"]),
                            "active": int(prev.get("active", 0))})
    if n_gaps > _MAX_GAP_FINDINGS:
        report.add(
            "PTL404", Severity.NOTE,
            f"{n_gaps - _MAX_GAP_FINDINGS} further decode-burst gap(s) "
            f"over the same threshold suppressed — the stall is "
            f"systemic, not incidental",
            suggestion={"suppressed": n_gaps - _MAX_GAP_FINDINGS})

    for r in doc.get("requests") or []:
        k = int(r.get("preemptions") or 0)
        if k >= thrash_k:
            recompute = (r.get("breakdown") or {}).get("recompute", 0.0)
            report.add(
                "PTL405", Severity.WARNING,
                f"preemption thrash: request {r.get('id')} preempted "
                f"{k} time(s) (>= {thrash_k}), paying "
                f"{float(recompute) * 1e3:.2f} ms of recompute prefill",
                hint="grow the KV pool (num_blocks), lower the slot "
                     "count, or gate admission on projected working "
                     "set — youngest-first eviction is starving this "
                     "stream's pool residency",
                suggestion={"request": r.get("id"), "preemptions": k})
    return report
