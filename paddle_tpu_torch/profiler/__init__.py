"""paddle_tpu_torch.profiler — tracing and profiling.

Counterpart of ``paddle_tpu/profiler`` (Paddle's ``profiler``
``__all__``): host spans through ``HostTracer`` / ``RecordEvent``, the
card's kernels through ``torch.profiler`` (``kineto.py``, the
counterpart of the reference's xplane reader), the summary tables of
``statistic.py`` and the step timer of ``timer.py``.
"""
from . import kineto  # noqa: F401
from .host_tracer import TracerEventType
from .profiler import (Profiler, ProfilerState, ProfilerTarget, SummaryView,
                       export_chrome_tracing, export_protobuf, get_profiler,
                       make_scheduler)
from .utils import RecordEvent, in_profiler_mode, load_profiler_result
from .statistic import (collect_device_statistic, device_summary_table,
                        op_class, statistic_from_trace, summary_table)

__all__ = [
    "Profiler", "ProfilerState", "ProfilerTarget", "SortedKeys",
    "SummaryView", "TracerEventType", "RecordEvent", "make_scheduler",
    "export_chrome_tracing", "export_protobuf", "load_profiler_result",
    "in_profiler_mode", "get_profiler", "collect_device_statistic",
    "device_summary_table", "op_class", "statistic_from_trace",
    "summary_table",
]


class SortedKeys:
    """Summary-table sort orders (Paddle's ``SortedKeys``)."""

    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7
