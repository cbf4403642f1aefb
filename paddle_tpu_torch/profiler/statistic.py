"""Summary statistics over collected host events and device kernels.

Counterpart of ``paddle_tpu/profiler/statistic.py`` (Paddle's
``profiler_statistic.py``): the host table by span name (calls, total,
avg, max, min, ratio) is the reference's; the device tables read the
card's kernels and copies as ``profiler/kineto.py`` returns them (chrome
``"X"`` events with ``cat == "device"``), where the reference reads the
TPU's XLA ops.

Kernel classes (:func:`op_class`), the counterpart of the reference's
HLO buckets:

- ``custom kernel (port)``: the port's hand-written kernels
  (``flash_*``, ``vflash_*``, ``rms_norm_*``, ``paged_decode_*``,
  ``tiled_mm_*``), the counterpart of ``custom-call (pallas)``;
- ``convolution``: cuDNN's kernels (``fprop`` / ``dgrad`` / ``wgrad``,
  its implicit GEMMs and NCHW <-> NHWC layout copies) and torch's own
  convolutions;
- ``matmul``: cuBLAS (``nvjet_*``, ``*gemm*``, CUTLASS, ``xmma``);
- ``collective``: NCCL;
- ``data-movement``: copies and fills (``Memcpy``, ``Memset``, copy
  kernels, concatenation, transposes);
- ``fusion``: generated kernels (``triton_*``);
- ``other``: the rest (torch's elementwise and reduction kernels).
"""
from __future__ import annotations

import re
from typing import Dict, List

from .host_tracer import HostEvent, flatten_events


class _Item:
    __slots__ = ("name", "calls", "total_ns", "max_ns", "min_ns")

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self.total_ns = 0
        self.max_ns = 0
        self.min_ns = None

    def add(self, ns: int):
        self.calls += 1
        self.total_ns += ns
        self.max_ns = max(self.max_ns, ns)
        self.min_ns = ns if self.min_ns is None else min(self.min_ns, ns)

    @property
    def avg_ns(self):
        return self.total_ns / self.calls if self.calls else 0.0


def collect_statistic(roots: List[HostEvent]) -> Dict[str, _Item]:
    items: Dict[str, _Item] = {}
    for ev in flatten_events(roots):
        it = items.setdefault(ev.name, _Item(ev.name))
        it.add(ev.duration_ns)
    return items


def _fmt_ms(ns) -> str:
    return f"{ns / 1e6:.3f}"


def summary_table(roots: List[HostEvent], sorted_by: str = "total",
                  time_unit: str = "ms") -> str:
    items = sorted(collect_statistic(roots).values(),
                   key=lambda it: -it.total_ns if sorted_by == "total"
                   else -it.avg_ns)
    wall = sum(r.duration_ns for r in roots) or 1
    header = (f"{'Name':<40}{'Calls':>8}{'Total(ms)':>12}{'Avg(ms)':>10}"
              f"{'Max(ms)':>10}{'Min(ms)':>10}{'Ratio(%)':>10}")
    lines = ["-" * len(header), header, "-" * len(header)]
    for it in items:
        lines.append(
            f"{it.name[:39]:<40}{it.calls:>8}{_fmt_ms(it.total_ns):>12}"
            f"{_fmt_ms(it.avg_ns):>10}{_fmt_ms(it.max_ns):>10}"
            f"{_fmt_ms(it.min_ns or 0):>10}{100.0 * it.total_ns / wall:>10.2f}")
    lines.append("-" * len(header))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Device (CUDA kernel) statistics over the events profiler/kineto.py returns
# (reference: profiler_statistic.py's kernel summary tables, there fed by
# CUPTI kernel records, which is what torch.profiler reads here too).
# ---------------------------------------------------------------------------

#: chrome-trace lanes of device work (kineto.py's lanes)
_OP_LANES = ("Kernels", "Memcpy", "Memset")

#: the class of the port's own kernels
PORT_CLASS = "custom kernel (port)"

_CLASS_PATTERNS = (
    (PORT_CLASS, re.compile(
        r"(?<![A-Za-z0-9])v?(flash_|rms_norm_|paged_decode_|tiled_mm_)")),
    ("collective", re.compile(r"nccl", re.I)),
    ("convolution", re.compile(
        r"fprop|dgrad|wgrad|cudnn|convolve|conv2d|conv_depthwise|Conv|"
        r"nchwToNhwc|nhwcToNchw")),
    ("matmul", re.compile(r"nvjet|gemm|Gemm|GEMM|cutlass|xmma|matmul")),
    ("data-movement", re.compile(
        r"^(Memcpy|Memset)|copy_kernel|direct_copy|CatArrayBatchedCopy|"
        r"transpose|Transpose")),
    ("fusion", re.compile(r"^triton_")),
)


def op_class(base_name: str) -> str:
    """Map a CUDA kernel's base name to a coarse class for the overview
    table (module docstring)."""
    for cls, pat in _CLASS_PATTERNS:
        if pat.search(base_name):
            return cls
    return "other"


def _base_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters (``void flash_fwd_tc_kernel<__nv_bfloat16, 128>(...)`` ->
    ``flash_fwd_tc_kernel``; anonymous namespaces dropped), so every
    instance of one kernel aggregates; a ``<name>.<id>`` loses its numeric
    id, as the reference's HLO names do."""
    s = name.strip().replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    cut = min((i for i in (s.find("<"), s.find("(")) if i >= 0),
              default=len(s))
    s = s[:cut].strip() or name
    head, _, tail = s.rpartition(".")
    if head and tail.isdigit():
        return head
    return s


def collect_device_statistic(trace_events, by: str = "op",
                             lanes=_OP_LANES) -> Dict[str, _Item]:
    """Aggregate exported chrome events with cat == 'device'.

    by='op' groups kernel base names; by='class' groups op_class buckets.
    Durations in the chrome export are microseconds; items store ns so
    the host/device tables share formatting.
    """
    items: Dict[str, _Item] = {}
    for ev in trace_events:
        if not isinstance(ev, dict) or ev.get("cat") != "device":
            continue
        if lanes is not None and ev.get("tid") not in lanes:
            continue
        base = _base_name(str(ev.get("name", "")))
        key = op_class(base) if by == "class" else base
        it = items.setdefault(key, _Item(key))
        it.add(int(float(ev.get("dur", 0.0)) * 1e3))
    return items


def device_summary_table(trace_events, sorted_by: str = "total",
                         by: str = "op", top: int = 30) -> str:
    """Per-kernel device-time table (the kernel summary of the
    reference)."""
    items = sorted(collect_device_statistic(trace_events, by=by).values(),
                   key=lambda it: -it.total_ns if sorted_by == "total"
                   else -it.avg_ns)
    wall = sum(it.total_ns for it in items) or 1
    title = "Device (CUDA kernel) Summary" if by == "op" \
        else "Device Kernel-Class Summary"
    header = (f"{'Kernel':<40}{'Calls':>8}{'Total(ms)':>12}{'Avg(ms)':>10}"
              f"{'Max(ms)':>10}{'Min(ms)':>10}{'Ratio(%)':>10}")
    lines = [title, "-" * len(header), header, "-" * len(header)]
    for it in items[:top]:
        lines.append(
            f"{it.name[:39]:<40}{it.calls:>8}{_fmt_ms(it.total_ns):>12}"
            f"{_fmt_ms(it.avg_ns):>10}{_fmt_ms(it.max_ns):>10}"
            f"{_fmt_ms(it.min_ns or 0):>10}{100.0 * it.total_ns / wall:>10.2f}")
    lines.append("-" * len(header))
    return "\n".join(lines)


def statistic_from_trace(path: str, by: str = "op") -> Dict[str, _Item]:
    """Per-kernel device statistics from a saved chrome trace (the file
    ``Profiler.export`` writes)."""
    import json

    with open(path) as f:
        d = json.load(f)
    evs = d.get("traceEvents", d) if isinstance(d, dict) else d
    return collect_device_statistic(evs, by=by)
