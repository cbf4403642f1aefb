"""Host-side span tracer.

The port's copy of ``paddle_tpu/profiler/host_tracer.py`` (Paddle's
HostTracer, ``paddle/fluid/platform/profiler/host_tracer.h``): spans
opened and closed on a host thread are collected into a per-thread event
list and merged into a tree for statistics and Chrome-trace export.
Device-side activity is traced by ``torch.profiler`` (the card's kernels,
read by ``profiler/kineto.py``) — see ``profiler.Profiler``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List


class TracerEventType:
    Operator = "Operator"
    Dataloader = "Dataloader"
    ProfileStep = "ProfileStep"
    CudaRuntime = "DeviceRuntime"
    Kernel = "Kernel"
    Memcpy = "Memcpy"
    Memset = "Memset"
    UserDefined = "UserDefined"
    OperatorInner = "OperatorInner"
    Forward = "Forward"
    Backward = "Backward"
    Optimization = "Optimization"
    Communication = "Communication"
    PythonOp = "PythonOp"
    PythonUserDefined = "PythonUserDefined"


@dataclass
class HostEvent:
    name: str
    type: str
    start_ns: int
    end_ns: int = 0
    thread_id: int = 0
    children: List["HostEvent"] = field(default_factory=list)

    @property
    def duration_ns(self) -> int:
        return max(0, self.end_ns - self.start_ns)

    def self_ns(self) -> int:
        return self.duration_ns - sum(c.duration_ns for c in self.children)


class _ThreadLocalState(threading.local):
    def __init__(self):
        self.stack: List[HostEvent] = []
        self.roots: List[HostEvent] = []


class HostTracer:
    """Collects nested host spans across threads while enabled."""

    def __init__(self):
        self._tls = _ThreadLocalState()
        self._lock = threading.Lock()
        self._all_roots: List[HostEvent] = []
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    def start(self):
        with self._lock:
            self._all_roots = []
        self._tls.roots = []
        self._tls.stack = []
        self._enabled = True

    def stop(self) -> List[HostEvent]:
        self._enabled = False
        self._flush_thread()
        with self._lock:
            roots, self._all_roots = self._all_roots, []
        return roots

    def push(self, name: str, type: str = TracerEventType.UserDefined) -> HostEvent:
        ev = HostEvent(name=name, type=type, start_ns=time.perf_counter_ns(),
                       thread_id=threading.get_ident())
        stack = self._tls.stack
        if stack:
            stack[-1].children.append(ev)
        else:
            self._tls.roots.append(ev)
        stack.append(ev)
        return ev

    def pop(self, ev: HostEvent):
        ev.end_ns = time.perf_counter_ns()
        stack = self._tls.stack
        while stack and stack[-1] is not ev:
            stack.pop()  # unbalanced push/pop (exception paths): close over-open spans
        if stack:
            stack.pop()
        if not stack:
            self._flush_thread()

    def _flush_thread(self):
        if self._tls.roots:
            with self._lock:
                self._all_roots.extend(self._tls.roots)
            self._tls.roots = []


_tracer = HostTracer()


def get_host_tracer() -> HostTracer:
    return _tracer


def flatten_events(roots: List[HostEvent]) -> List[HostEvent]:
    out: List[HostEvent] = []

    def rec(e: HostEvent):
        out.append(e)
        for c in e.children:
            rec(c)

    for r in roots:
        rec(r)
    return out
