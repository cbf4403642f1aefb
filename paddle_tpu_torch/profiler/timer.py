"""Step/throughput timing (ips) behind ``Profiler.step_info``.

The port's copy of ``paddle_tpu/profiler/timer.py`` (Paddle's
``profiler/timer.py``: ``TimeAverager``, ``Benchmark``, ``benchmark()``).
Host wall time between ``step()`` calls: on the card that is the host's
pace, which equals the card's only when the loop reads a result each
step (``observability.StepTimer`` times steps on the device).
"""
from __future__ import annotations

import time


class TimeAverager:
    def __init__(self):
        self.reset()

    def reset(self):
        self._total = 0.0
        self._count = 0
        self._total_samples = 0

    def record(self, usetime: float, num_samples: int = 0):
        self._total += usetime
        self._count += 1
        self._total_samples += num_samples

    def get_average(self) -> float:
        return self._total / self._count if self._count else 0.0

    def get_ips_average(self) -> float:
        return self._total_samples / self._total if self._total > 0 else 0.0


class Benchmark:
    """Tracks reader/batch cost and instantaneous ips across steps."""

    def __init__(self):
        self.reader = TimeAverager()
        self.batch = TimeAverager()
        self._batch_start = None
        self._reader_start = None
        self.num_samples = 0
        self.current_event = self

    def before_reader(self):
        self._reader_start = time.perf_counter()

    def after_reader(self):
        if self._reader_start is not None:
            self.reader.record(time.perf_counter() - self._reader_start)

    def step(self, num_samples: int = 0):
        now = time.perf_counter()
        if self._batch_start is not None:
            self.batch.record(now - self._batch_start, num_samples)
        self._batch_start = now

    def step_info(self, unit: str = "samples") -> str:
        ips = self.batch.get_ips_average()
        out = (f"avg_batch_cost: {self.batch.get_average():.5f} sec, "
               f"avg_reader_cost: {self.reader.get_average():.5f} sec")
        if ips:
            out += f", ips: {ips:.2f} {unit}/sec"
        self.reader.reset()
        self.batch.reset()
        return out


_benchmark = Benchmark()


def benchmark() -> Benchmark:
    return _benchmark
