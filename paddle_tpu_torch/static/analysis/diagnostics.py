"""Diagnostic records: coded, located, actionable findings.

The port's copy of ``paddle_tpu/static/analysis/diagnostics.py``.
Verifier errors and lint warnings funnel into one coded record type so
they share formatting, filtering and test assertions. The whole
:data:`CODES` table is kept as data, so a code means the same thing in
both packages; of its emitters the port has the serving ones (PTL4xx:
``observability/slo.py``, ``observability/tracing.py``,
``serve_trace_lint.py``). The program verifier, the lints and the cost
model (PTL0xx–PTL3xx) wait for the static-graph layer.

Code namespace (``PTLxxx``):

- ``PTL0xx`` — structural verifier errors (`verify.py`): the program is
  malformed and replay is undefined behaviour.
- ``PTL1xx`` — lint findings (`lint.py`): the program is valid but
  suspicious (dead code, redundant ops, silent dtype demotion, ...).
- ``PTL2xx`` — sharding-aware lints (`lint.py`/`sharding_lint.py`):
  layout/placement findings feeding the auto-parallel planner.
- ``PTL3xx`` — cost/memory analysis (`cost.py`/`memory.py`/
  `rewrite.py`): predicted OOM, cost-model drift, no-benefit passes.
- ``PTL4xx`` — serving observability (`observability/slo.py`,
  `observability/tracing.py`, `serve_trace_lint.py`): SLO breaches,
  tracing overhead, malformed span trees, decode-burst gaps,
  preemption thrash.
- ``PTL5xx`` — execution profiling (`observability/opprof.py`): per-op
  measured-vs-predicted drift, attribution shortfall, profiling
  overhead — the measured half of the PTL3xx cost model.
- ``PTL6xx`` — continuous health monitoring (`observability/health.py`,
  `tools/bench_compare.py`): time-series anomaly detectors (perf drift,
  resource leaks, throughput degradation) and BENCH regression gating.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

__all__ = [
    "Severity", "Diagnostic", "DiagnosticReport",
    "ProgramVerificationError", "CODES",
]


class Severity(enum.IntEnum):
    NOTE = 0
    WARNING = 1
    ERROR = 2

    def __str__(self):  # "error" not "Severity.ERROR" in rendered reports
        return self.name.lower()


# Registry of every code this layer can emit — one place to look up what a
# code means, and the source of truth tests assert against.
CODES = {
    # verifier (errors)
    "PTL001": "unknown primitive (not in dispatch.PRIMITIVES)",
    "PTL002": "use of an undefined value id (use-before-def or dangling input)",
    "PTL003": "duplicate value-id definition (out_vid redefined)",
    "PTL004": "dangling out_vid (value id was never allocated by this program)",
    "PTL005": "feed placeholder vid also bound as a constant",
    "PTL006": "unhashable static attribute (breaks executable caching)",
    "PTL007": "malformed __gradients__ instruction (placement/operands/fwd_len)",
    "PTL008": "InferMeta audit: recorded output shape diverges from eval_shape",
    "PTL009": "InferMeta audit: recorded output dtype diverges from eval_shape",
    "PTL010": "InferMeta audit: shape inference failed or output arity mismatch",
    # lints (warnings/notes)
    "PTL101": "dead op: outputs never reach a fetch target",
    "PTL102": "unused feed: placeholder is never consumed",
    "PTL103": "redundant cast (no-op cast or losslessly collapsible chain)",
    "PTL104": "redundant transpose chain (cancels out or composes to one)",
    "PTL105": "common-subexpression candidate (identical op computed twice)",
    "PTL106": "silent float64 -> float32 demotion",
    "PTL107": "non-jittable primitive inside a jit-replayed program",
    "PTL108": "cast chain with a narrowing intermediate (numerics-changing, "
              "NOT redundant — informational only)",
    # sharding-aware lints (PTL2xx) — layout/placement findings feeding
    # the auto-parallel planner (lint.py + sharding_lint.py)
    "PTL201": "float32 operand on a bfloat16 compute hot path (mixed-dtype "
              "GEMM upcasts to the fp32 rate)",
    "PTL202": "placement mismatch forces an avoidable collective (reshard/"
              "allgather a consistent plan would not need)",
    "PTL203": "collective serializes against compute in the merged fleet "
              "trace (no overlap with any compute span on that rank)",
    # cost/memory-analysis diagnostics (PTL3xx) — the static cost model
    # and liveness peak-memory estimator (cost.py + memory.py)
    "PTL301": "predicted OOM before compile: liveness peak-memory estimate "
              "exceeds the device budget",
    "PTL302": "cost-model drift: analytical FLOPs estimate diverges from "
              "XLA's compiled cost analysis beyond tolerance",
    "PTL303": "no-benefit pass: a rewrite pass was scheduled out because "
              "the pre-pass lint found nothing it could fix",
    "PTL304": "step-time model drift: predicted step time (compute + "
              "comm model) diverges from measured train.step_seconds "
              "beyond tolerance",
    "PTL305": "auto-sharding search found a placement predicted strictly "
              "faster than the derived plan (informational: the derived "
              "plan is not comm-optimal)",
    # serving-observability diagnostics (PTL4xx) — request-lifecycle
    # tracing + SLO guardrails (observability/slo.py + tracing.py +
    # serve_trace_lint.py)
    "PTL401": "SLO breach: a declarative rolling-window serving rule "
              "(p99 TTFT / tokens-per-sec floor / pool-exhaustion rate) "
              "left its bound",
    "PTL402": "tracing overhead exceeded: tokens/sec with request "
              "tracing enabled fell more than the tolerance below the "
              "untraced run",
    "PTL403": "span-tree malformed: a request's lifecycle spans are "
              "unclosed, out of order, or escape the request envelope",
    "PTL404": "decode-burst gap: the engine sat host-side between decode "
              "steps while slots were runnable (fused multi-token decode "
              "would close the gap)",
    "PTL405": "preemption thrash: the same request was preempted and "
              "recomputed too many times (pool sizing / admission "
              "pressure)",
    # execution-profiling diagnostics (PTL5xx) — the op-level profiler
    # that closes the predicted-vs-measured loop (observability/opprof.py)
    "PTL501": "hot-op drift: a profiled op's measured time diverges from "
              "the cost model's per-op prediction beyond tolerance (the "
              "per-op decomposition of PTL302/PTL304)",
    "PTL502": "attribution shortfall: the op profiler's spans fail to "
              "tile the measured step (unattributed step time above "
              "threshold — the profile cannot be trusted)",
    "PTL503": "profiling overhead exceeded: steps/sec with op profiling "
              "enabled fell more than the budget below the unprofiled "
              "run (the PTL402 analog for the training plane)",
    # continuous-health diagnostics (PTL6xx) — detectors evaluated over
    # metric time-series (observability/health.py) plus the BENCH
    # record comparator (tools/bench_compare.py)
    "PTL601": "perf drift: a step-time series drifted beyond the "
              "z-score/relative-change gate against its own baseline "
              "window (the continuous form of PTL302 — no model needed, "
              "the job is compared against its younger self)",
    "PTL602": "resource leak: a watermark/occupancy series grows "
              "monotonically across the observation window (HBM "
              "watermark, KV-pool occupancy, host-side ring sizes) — "
              "the job will eventually OOM or thrash",
    "PTL603": "throughput degradation: a rate series (tokens/sec, or a "
              "failure counter's rate-of-change) left its healthy band "
              "— serving slowdown or elastic/fleet instability",
    "PTL604": "detector input malformed: a health rule's series is "
              "missing, non-numeric, or non-finite — the detector "
              "cannot evaluate and says so instead of staying silent",
    "PTL605": "regression vs baseline: a benchmark config's headline "
              "metric moved beyond the noise band against the previous "
              "BENCH record (tools/bench_compare.py CI gate)",
}


@dataclass
class Diagnostic:
    """One finding: coded, located, and actionable.

    ``op_index`` is the instruction index in ``Program._insts`` (None for
    program-level findings like feed/const overlap). ``suggestion`` is an
    optional machine-readable fix payload — a plain JSON-able dict so
    automated consumers act on structure instead of parsing the rendered
    message."""

    code: str
    severity: Severity
    message: str
    op_index: Optional[int] = None
    hint: Optional[str] = None
    suggestion: Optional[dict] = None

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unregistered diagnostic code {self.code!r}")

    def render(self) -> str:
        loc = f"op#{self.op_index}: " if self.op_index is not None else ""
        s = f"{self.code} {self.severity}: {loc}{self.message}"
        if self.hint:
            s += f"\n    hint: {self.hint}"
        return s

    def __str__(self):
        return self.render()


@dataclass
class DiagnosticReport:
    """Ordered collection of diagnostics with an overall verdict."""

    diagnostics: List[Diagnostic] = field(default_factory=list)

    def add(self, code, severity, message, op_index=None, hint=None,
            suggestion=None):
        self.diagnostics.append(
            Diagnostic(code, severity, message, op_index, hint, suggestion))

    def extend(self, other: "DiagnosticReport"):
        self.diagnostics.extend(other.diagnostics)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == Severity.ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == Severity.WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self):
        return {d.code for d in self.diagnostics}

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def render(self, header: Optional[str] = None) -> str:
        lines = []
        if header:
            lines.append(header)
        if not self.diagnostics:
            lines.append("no diagnostics")
        lines.extend(d.render() for d in self.diagnostics)
        return "\n".join(lines)

    def raise_if_errors(self, context: Optional[str] = None):
        if self.errors:
            raise ProgramVerificationError(self, context=context)

    def __len__(self):
        return len(self.diagnostics)

    def __iter__(self):
        return iter(self.diagnostics)

    def __str__(self):
        return self.render()


class ProgramVerificationError(RuntimeError):
    """Raised when verification finds structural errors.

    ``context`` carries provenance — the PassManager attaches the name of
    the rewrite pass after which verification failed (the pir::PassManager
    verify-between-passes behaviour)."""

    def __init__(self, report: DiagnosticReport, context: Optional[str] = None):
        self.report = report
        self.context = context
        where = f" [{context}]" if context else ""
        errs = report.errors
        msg = (f"program verification failed{where}: "
               f"{len(errs)} error(s)\n" +
               "\n".join(d.render() for d in errs))
        super().__init__(msg)
