"""Communication watchdog.

The port's copy of ``paddle_tpu/distributed/communication/watchdog.py``
(after Paddle's ``comm_task_manager.h``: ``CommTaskManager`` tracks
in-flight communication and flags hangs, with
``FLAGS_stop_check_timeout`` as the deadline). Register a task around
any blocking wait (the store rendezvous, ``barrier``); a daemon thread
flags the tasks that outlive their timeout: a warning, the
``comm.task_overdue`` counter, a ``comm.task_overdue`` event and a
flight-recorder dump with reason ``watchdog_timeout``. torch's NCCL
process group keeps its own watchdog over the collectives themselves,
with the same timeout (``init_parallel_env``).
"""
from __future__ import annotations

import threading
import time
import warnings
from typing import Dict, Optional

from ... import observability as _obs
from ...core import flags

__all__ = ["CommTask", "CommTaskManager", "get_comm_task_manager"]

# overdue tasks surface as metrics (not just log lines): comm.task_overdue
# is the alert series an operator watches, comm.task_seconds the latency
# distribution of every registered wait. An overdue task also writes the
# flight-recorder post-mortem — a watchdog timeout IS the multi-chip
# "job died" moment the recorder exists for.
_M_TASKS = _obs.counter(
    "comm.tasks_started",
    "communication/coordination waits registered with the watchdog, by "
    "task name")
_M_TASK_SECONDS = _obs.histogram(
    "comm.task_seconds",
    "wall seconds a registered comm task stayed in flight, by task name")
_M_TASK_OVERDUE = _obs.counter(
    "comm.task_overdue",
    "watchdog detections of a task outliving its timeout (each task "
    "counts once), by task name")
_M_SCANS = _obs.counter(
    "comm.watchdog_scans",
    "watchdog scan-loop passes over the in-flight task table")


class CommTask:
    """One in-flight communication/coordination op."""

    __slots__ = ("name", "start_s", "timeout_s", "done", "warned")

    def __init__(self, name: str, timeout_s: float):
        self.name = name
        self.start_s = time.time()
        self.timeout_s = timeout_s
        self.done = False
        self.warned = False

    def elapsed_s(self) -> float:
        return time.time() - self.start_s

    def overdue(self) -> bool:
        return not self.done and self.elapsed_s() > self.timeout_s


class CommTaskManager:
    """A loop thread scanning the in-flight tasks (Paddle's
    ``CommTaskManager``)."""

    def __init__(self, scan_interval_s: float = 1.0):
        self._tasks: Dict[int, CommTask] = {}
        self._lock = threading.Lock()
        self._seq = 0
        self._scan_interval_s = scan_interval_s
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._overdue_log = []

    # -- task lifecycle --------------------------------------------------
    def start_task(self, name: str, timeout_s: Optional[float] = None) -> int:
        if timeout_s is None:
            timeout_s = float(flags.get_flag("stop_check_timeout"))
        task = CommTask(name, timeout_s)
        with self._lock:
            self._seq += 1
            tid = self._seq
            self._tasks[tid] = task
        if _obs.state.on:
            _M_TASKS.inc(name=name)
        self._ensure_thread()
        return tid

    def end_task(self, tid: int):
        with self._lock:
            task = self._tasks.pop(tid, None)
            if task is not None:
                task.done = True
        if task is not None and _obs.state.on:
            _M_TASK_SECONDS.observe(task.elapsed_s(), name=task.name)

    def task(self, name: str, timeout_s: Optional[float] = None):
        """Context manager form: with manager.task('barrier'): ..."""
        import contextlib

        @contextlib.contextmanager
        def cm():
            tid = self.start_task(name, timeout_s)
            try:
                yield
            finally:
                self.end_task(tid)

        return cm()

    # -- watchdog loop ---------------------------------------------------
    def _ensure_thread(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self._scan_interval_s):
            with self._lock:
                tasks = list(self._tasks.values())
            if _obs.state.on:
                _M_SCANS.inc()
            if not tasks:
                continue
            for t in tasks:
                if t.overdue() and not t.warned:
                    t.warned = True
                    msg = (f"CommTaskManager: task '{t.name}' has been "
                           f"in-flight for {t.elapsed_s():.0f}s "
                           f"(timeout {t.timeout_s:.0f}s) — probable "
                           f"distributed hang")
                    self._overdue_log.append(msg)
                    # warn before flipping the metric: pollers treat
                    # comm.task_overdue as "the alert already happened"
                    warnings.warn(msg)
                    if _obs.state.on:
                        _obs.emit("comm.task_overdue", name=t.name,
                                  elapsed_s=round(t.elapsed_s(), 3),
                                  timeout_s=t.timeout_s)
                        # inc before the dump so the post-mortem's metric
                        # snapshot shows the overdue counter that fired it
                        _M_TASK_OVERDUE.inc(name=t.name)
                        # the post-mortem moment: a distributed wait blew
                        # its deadline, dump the flight ring while the
                        # process is still alive to write it
                        _obs.flight.recorder.dump(
                            "watchdog_timeout",
                            TimeoutError(msg),
                            context={"task": t.name,
                                     "elapsed_s": round(t.elapsed_s(), 3),
                                     "timeout_s": t.timeout_s})

    def overdue_tasks(self):
        with self._lock:
            return [t for t in self._tasks.values() if t.overdue()]

    def overdue_log(self):
        return list(self._overdue_log)

    def shutdown(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


_manager: Optional[CommTaskManager] = None
_manager_lock = threading.Lock()


def get_comm_task_manager() -> CommTaskManager:
    global _manager
    with _manager_lock:
        if _manager is None:
            _manager = CommTaskManager()
        return _manager
