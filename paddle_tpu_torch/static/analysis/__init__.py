"""paddle_tpu_torch.static.analysis — coded diagnostics.

The port's counterpart of ``paddle_tpu/static/analysis``, so far:

- ``diagnostics.py``: ``Severity``, ``Diagnostic``, ``DiagnosticReport``,
  ``ProgramVerificationError`` and the ``CODES`` table;
- ``serve_trace_lint.py``: PTL404 (decode gaps while slots were
  runnable) and PTL405 (preemption thrash) over a ``ServeTracer`` dump.

The program verifier, the lints, the cost and memory models and the
sharding lints wait for ROADMAP queue A item 7.
"""
from __future__ import annotations

from .diagnostics import (  # noqa: F401
    CODES, Diagnostic, DiagnosticReport, ProgramVerificationError, Severity,
)
from .serve_trace_lint import (  # noqa: F401
    SERVE_TRACE_LINT_CODES, lint_serve_trace,
)

__all__ = [
    "CODES", "Diagnostic", "DiagnosticReport", "ProgramVerificationError",
    "Severity", "SERVE_TRACE_LINT_CODES", "lint_serve_trace",
]
