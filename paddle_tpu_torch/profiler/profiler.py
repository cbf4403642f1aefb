"""Profiler facade: host spans + the card's kernels + chrome export.

Counterpart of ``paddle_tpu/profiler/profiler.py`` (Paddle's
``profiler/profiler.py``: ``ProfilerState``, ``ProfilerTarget``,
``make_scheduler``, ``export_chrome_tracing``, ``Profiler``). The
scheduler and the step state machine are the reference's. Where the
reference captures an XLA device trace (xplane) while a window records,
the port runs ``torch.profiler`` over the window, with CPU activity and,
when ``ProfilerTarget.GPU`` is a target (the default where a card is
visible), CUDA activity: its kernels become the device tables of
:meth:`Profiler.summary` (``profiler/kineto.py`` reads them,
``statistic.py`` tabulates them by kernel and by class). A ``READY``
step starts the torch profiler's warm-up, so recording starts warm, and
a window that records the card waits for its kernels before it closes.
Host spans (``RecordEvent``, ``ProfileStep#n``) are the host tracer's,
as in the reference.
"""
from __future__ import annotations

import json
import os
import time
from enum import Enum
from typing import Callable, Iterable, List, Optional, Union

import torch

from .host_tracer import TracerEventType, flatten_events, get_host_tracer
from .statistic import device_summary_table, summary_table
from .utils import RecordEvent, _set_profiler_mode


class SummaryView(Enum):
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3
    TPU = 4


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """Window scheduler: skip_first → [closed → ready → record]*repeat."""
    num_steps = closed + ready + record

    def getter(step: int) -> ProfilerState:
        assert step >= 0
        if step < skip_first:
            return ProfilerState.CLOSED
        step -= skip_first
        period = step // num_steps
        if repeat > 0 and period >= repeat:
            return ProfilerState.CLOSED
        pos = step % num_steps
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == num_steps - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    assert closed >= 0 and ready >= 0 and record > 0 and repeat >= 0
    return getter


def _default_state_scheduler(step: int) -> ProfilerState:
    return ProfilerState.RECORD


def export_chrome_tracing(dir_name: str,
                          worker_name: Optional[str] = None) -> Callable:
    """on_trace_ready callback writing chrome-trace json into dir_name."""

    def handle(prof: "Profiler"):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"host_{os.getpid()}"
        path = os.path.join(dir_name, f"{name}_time_{prof._span_idx}.json")
        prof.export(path, format="json")

    return handle


def export_protobuf(dir_name: str,
                    worker_name: Optional[str] = None) -> Callable:
    # as the reference: no protobuf schema of our own, so the window is
    # written as a chrome trace
    return export_chrome_tracing(dir_name, worker_name)


def _get_supported_targets() -> Iterable[ProfilerTarget]:
    targets = [ProfilerTarget.CPU]
    if torch.cuda.is_available():
        targets.append(ProfilerTarget.GPU)
    return targets


_RECORDING = (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)


class Profiler:
    """Collect host spans and (with the GPU target) the card's kernels over
    scheduled step windows.

    Usage::

        p = profiler.Profiler(scheduler=(2, 5))
        p.start()
        for it, batch in enumerate(loader):
            train_step(batch)
            p.step()
        p.stop()
        p.summary()

    ``device_events`` holds the last window's kernels and copies
    (``kineto.py``'s shape).
    """

    def __init__(self, *, targets: Optional[Iterable[ProfilerTarget]] = None,
                 scheduler: Union[Callable, tuple, None] = None,
                 on_trace_ready: Optional[Callable] = None,
                 record_shapes: bool = False, profile_memory: bool = False,
                 timer_only: bool = False, emit_nvtx: bool = False,
                 custom_device_types: list = []):
        self.targets = list(targets) if targets else list(_get_supported_targets())
        if callable(scheduler):
            self._scheduler = scheduler
        elif isinstance(scheduler, (tuple, list)):
            start, end = scheduler
            self._scheduler = make_scheduler(
                closed=max(start - 1, 0), ready=min(start, 1),
                record=end - start, repeat=1)
        else:
            self._scheduler = _default_state_scheduler
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.record_shapes = record_shapes
        self.profile_memory = profile_memory
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self._span_idx = 0
        self._events = []
        self.device_events: List[dict] = []
        self._torch_prof = None
        self._trace_t0_us = 0.0
        self._record_step_event: Optional[RecordEvent] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        from .timer import benchmark
        benchmark().step()
        if self.timer_only:
            return
        self.current_state = self._scheduler(self.step_num)
        if self.current_state == ProfilerState.READY:
            self._prepare()
        elif self.current_state in _RECORDING:
            self._start_record()
        self._open_step_span()

    def stop(self):
        from .timer import benchmark
        benchmark().step()
        if self.timer_only:
            return
        self._close_step_span()
        if self.current_state in _RECORDING:
            self._stop_record()
            if self.on_trace_ready:
                self.on_trace_ready(self)
            self._span_idx += 1
        elif self._torch_prof is not None:     # stopped while READY
            self._torch_prof.stop_trace()
            self._torch_prof = None
        self.current_state = ProfilerState.CLOSED

    def step(self, num_samples: Optional[int] = None):
        from .timer import benchmark
        benchmark().step(num_samples or 0)
        if self.timer_only:
            self.step_num += 1
            return
        self._close_step_span()
        prev = self.current_state
        self.step_num += 1
        self.current_state = self._scheduler(self.step_num)
        # RECORD_AND_RETURN always ends its window, even when the next window
        # starts immediately (closed=0, ready=0, repeat>1 back-to-back case)
        window_closed = prev == ProfilerState.RECORD_AND_RETURN or (
            prev in _RECORDING and self.current_state not in _RECORDING)
        if window_closed:
            self._stop_record()
            if self.on_trace_ready:
                self.on_trace_ready(self)
            self._span_idx += 1
            if self.current_state in _RECORDING:
                self._start_record()
        elif prev not in _RECORDING and self.current_state in _RECORDING:
            self._start_record()
        if self.current_state == ProfilerState.READY:
            self._prepare()
        self._open_step_span()

    def step_info(self, unit: str = "samples") -> str:
        from .timer import benchmark
        return benchmark().step_info(unit)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- internals ---------------------------------------------------------
    def _open_step_span(self):
        if self.current_state in _RECORDING:
            self._record_step_event = RecordEvent(
                f"ProfileStep#{self.step_num}", TracerEventType.ProfileStep)
            self._record_step_event.begin()

    def _close_step_span(self):
        if self._record_step_event is not None:
            self._record_step_event.end()
            self._record_step_event = None

    def _activities(self):
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if ProfilerTarget.GPU in self.targets and torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return acts

    def _prepare(self):
        """Start the torch profiler's warm-up (idempotent)."""
        if self._torch_prof is None:
            # one torch profile a window: nothing to clear between
            # cycles (acc_events also silences torch's warning on it)
            self._torch_prof = torch.profiler.profile(
                activities=self._activities(),
                record_shapes=self.record_shapes,
                profile_memory=self.profile_memory, acc_events=True)
            self._torch_prof.prepare_trace()

    def _start_record(self):
        get_host_tracer().start()
        _set_profiler_mode(True)
        self._prepare()
        self._trace_t0_us = time.perf_counter_ns() / 1e3
        self._torch_prof.start_trace()

    def _stop_record(self):
        _set_profiler_mode(False)
        prof, self._torch_prof = self._torch_prof, None
        self._events = get_host_tracer().stop()
        if prof is None:
            return
        if any(a.name == "CUDA" for a in prof.activities):
            # the window's kernels must have run before the trace closes,
            # or their records are lost (profiling is off the hot path)
            torch.cuda.synchronize()
        prof.stop_trace()
        from .kineto import device_trace_events

        host_names = {e.name for e in flatten_events(self._events)}
        self.device_events = device_trace_events(
            prof, t0_us=self._trace_t0_us, skip_names=host_names)

    # -- results -----------------------------------------------------------
    def export(self, path: str, format: str = "json"):
        """Write the window's host spans and device events as one chrome
        trace."""
        traces = []
        for ev in flatten_events(self._events):
            traces.append({
                "name": ev.name, "ph": "X", "cat": ev.type,
                "ts": ev.start_ns / 1e3, "dur": ev.duration_ns / 1e3,
                "pid": os.getpid(), "tid": ev.thread_id,
            })
        traces.extend(self.device_events)
        with open(path, "w") as f:
            json.dump({"traceEvents": traces,
                       "displayTimeUnit": "ms"}, f)
        return traces

    def summary(self, sorted_by=SummaryView.OverView, op_detail: bool = True,
                thread_sep: bool = False, time_unit: str = "ms"):
        """Host-span table plus, when the window recorded the card, the
        per-kernel and kernel-class device tables (reference:
        profiler_statistic.py's operator + kernel summaries)."""
        table = summary_table(self._events, time_unit=time_unit)
        if self.device_events:
            table += "\n\n" + device_summary_table(self.device_events,
                                                   by="op")
            if op_detail:
                table += "\n\n" + device_summary_table(self.device_events,
                                                       by="class")
        print(table)
        return table

    def get_summary(self) -> str:
        return summary_table(self._events)


def get_profiler(config_path: Optional[str] = None) -> Profiler:
    return Profiler()
