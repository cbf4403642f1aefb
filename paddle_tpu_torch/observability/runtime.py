"""Step-level training telemetry: step time, throughput, MFU, memory gauges.

Counterpart of ``paddle_tpu/observability/runtime.py``, with its metric
names, labels and events:

- ``step_region()`` / :class:`StepTimer` bracket one optimizer step and
  record ``train.step_seconds``, ``train.items_per_second`` and, when a
  per-step FLOP count is known, ``train.mfu`` (model FLOPs utilization
  against the card's peak), emitting a ``train.step`` event that rides
  both the export ring and the flight recorder;
- :func:`sample_device_memory` reads ``device/memory.py``'s allocator
  stats into ``device.hbm_bytes_in_use`` / ``device.hbm_watermark_bytes``
  / ``device.hbm_bytes_limit``, with a scan of live CPU tensors as the
  CPU fallback;
- :func:`measure_step_flops` counts one step's FLOPs as it runs
  (``utils/flops.count_flops``: torch's products under
  ``FlopCounterMode``, each hand-written kernel at the work the
  reference's Pallas call declares; the convention is in
  ``utils/flops.py``).

**What a step's seconds are.** JAX and torch both dispatch
asynchronously, so the host's time around a step is the time it took to
*queue* it; a captured step (one CUDA graph replay) returns almost at
once. Where the card is in use and no clock is injected, a region
records a CUDA event (``enable_timing``) on the current stream at entry
and another at exit, and ``train.step_seconds`` is the device time
between them: the step as the card ran it, host gaps inside it
included. Reading it must not stall the loop, so a region is resolved
one step late: the exit of step N waits for step N-1's end event (the
card still has step N queued, so it never idles for it) and records
N-1's metrics; :func:`flush_steps` (``StepTimer.flush``, ``dump()``)
resolves the last one at the loop's end. The ``train.step`` event,
``train.mfu`` and ``train.items_per_second`` of a step are recorded
when it is resolved. With an injected clock (``FakeClock``), or on the
CPU, a region reads the clock at entry and exit and records at once, as
the reference does.

Everything is behind the ``observability.state.on`` gate: a disabled
process gets one shared no-op region and allocates nothing.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import torch

from . import _gate, flight
from .events import emit
from .metrics import registry

PEAK_FLOPS_ENV = "PADDLE_TPU_PEAK_FLOPS"

#: dense bf16 peak FLOP/s of the cards the port knows, by a part of
#: ``torch.cuda.get_device_name`` (NVIDIA's data sheet): the H100 SXM5,
#: which reports itself as "NVIDIA H100 80GB HBM3"
CARD_PEAK_FLOPS = (("H100 80GB HBM3", 989e12),)

#: the nominal CPU figure (the reference's, and bench.py's)
CPU_PEAK_FLOPS = 1e12


class FakeClock:
    """Deterministic injectable clock for timing-sensitive tests.

    Serves both clock protocols: calling it (or ``.time()``) returns the
    current fake time (the callable protocol ``ServeEngine(clock=...)``,
    ``StepTimer(clock=...)`` and ``step_region(clock=...)`` take) and
    ``.sleep(dt)`` advances it (the object protocol
    ``serve.load.run_load(clock=...)`` takes). ``tick`` advances the
    clock by a fixed amount on every read, so a path that reads it twice
    measures a positive, reproducible duration."""

    __slots__ = ("now", "tick")

    def __init__(self, start: float = 0.0, tick: float = 0.0):
        self.now = float(start)
        self.tick = float(tick)

    def time(self) -> float:
        t = self.now
        self.now += self.tick
        return t

    __call__ = time

    def sleep(self, dt: float):
        self.now += max(float(dt), 0.0)

    def advance(self, dt: float):
        self.now += float(dt)


M_STEP_SECONDS = registry.histogram(
    "train.step_seconds",
    "seconds per training step bracketed by obs.step_region(): device "
    "time between CUDA events on the card, the clock's otherwise")
M_STEPS = registry.counter(
    "train.steps", "training steps completed, by region name")
M_ITEMS_PER_SEC = registry.gauge(
    "train.items_per_second",
    "throughput of the last step (tokens- or samples-per-second — the "
    "unit label says which), by region name")
M_MFU = registry.gauge(
    "train.mfu",
    "model FLOPs utilization of the last step (0-1): step FLOPs / "
    "seconds / peak card FLOPs, by region name")
M_HBM_IN_USE = registry.gauge(
    "device.hbm_bytes_in_use",
    "device memory currently allocated, by device index (CPU fallback: "
    "sum of live CPU tensor bytes)")
M_HBM_WATERMARK = registry.gauge(
    "device.hbm_watermark_bytes",
    "high-water mark of device memory, by device index (the allocator's "
    "peak where it reports one, else the max in-use value this process "
    "has sampled)")
M_HBM_LIMIT = registry.gauge(
    "device.hbm_bytes_limit",
    "device memory capacity, by device index (0 where no card is in "
    "use)")

# host-side watermark per device label, for the CPU (no allocator
# peak): max bytes_in_use ever sampled here.
_seen_watermark: Dict[str, int] = {}


def _clear_watermarks():
    _seen_watermark.clear()


def default_peak_flops() -> float:
    """Peak FLOP/s for MFU: ``PADDLE_TPU_PEAK_FLOPS`` when set, else the
    card's dense bf16 peak from :data:`CARD_PEAK_FLOPS` (989e12 on the
    H100 SXM), or the nominal 1e12 where no card is visible. A card the
    table does not hold raises ``ValueError``: no figure is guessed."""
    env = os.environ.get(PEAK_FLOPS_ENV)
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    if not torch.cuda.is_available():
        return CPU_PEAK_FLOPS
    name = torch.cuda.get_device_name(torch.cuda.current_device())
    for part, peak in CARD_PEAK_FLOPS:
        if part in name:
            return peak
    raise ValueError(
        f"default_peak_flops: no peak FLOP/s is known for {name!r}; set "
        f"{PEAK_FLOPS_ENV} to the card's dense peak (FLOP/s) or pass "
        f"peak_flops=")


def measure_step_flops(fn, *args, **kwargs) -> int:
    """FLOPs of one ``fn(*args)`` step, counted while it runs
    (``utils/flops.count_flops``; the step runs once). Returns 0 rather
    than raising when the count fails."""
    from ..utils.flops import count_flops

    try:
        return int(count_flops(fn, *args, **kwargs))
    except Exception:
        return 0


def sample_device_memory(device_id: Optional[int] = None) -> Dict[str, int]:
    """Read device memory stats into the ``device.*`` gauges.

    Uses the caching allocator's stats where the card is in use
    (``device/memory.py:memory_stats``: host-side books, no sync);
    elsewhere falls back to summing live CPU tensor bytes. Never raises;
    returns ``{"bytes_in_use", "watermark_bytes", "bytes_limit"}``."""
    from ..device import memory as dev_mem

    stats = dev_mem.memory_stats(device_id)
    in_use = int(stats.get("bytes_in_use", 0))
    peak = int(stats.get("peak_bytes_in_use", 0))
    limit = int(stats.get("bytes_limit", 0))
    if "bytes_in_use" not in stats:
        in_use = dev_mem.live_array_bytes()
    label = str(device_id or 0)
    watermark = max(peak, in_use, _seen_watermark.get(label, 0))
    _seen_watermark[label] = watermark
    if _gate.state.on:
        M_HBM_IN_USE.set(in_use, device=label)
        M_HBM_WATERMARK.set(watermark, device=label)
        M_HBM_LIMIT.set(limit, device=label)
    return {"bytes_in_use": in_use, "watermark_bytes": watermark,
            "bytes_limit": limit}


def _card_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


#: device-timed regions whose end event is not read yet, oldest first
_pending: List["_StepRegion"] = []


def flush_steps() -> None:
    """Record every device-timed step still waiting for its end event
    (waits for the last one): the loop's-end counterpart of the one-step
    -late resolution (module docstring)."""
    while _pending:
        _pending.pop(0)._resolve()


class _StepRegion:
    """One bracketed step: a profiler host span + the train.* metrics.

    On a clean exit it records (or, device-timed, queues) the step's
    seconds, throughput and MFU; on an exception it emits a
    ``train.step_failed`` event and writes the flight-recorder dump
    (reason ``step_exception``) before re-raising.
    """

    __slots__ = ("name", "step", "items", "unit", "flops", "peak_flops",
                 "sample_memory", "fields", "_rec", "_t0", "seconds",
                 "mfu", "items_per_second", "_clock", "_events")

    def __init__(self, name: str, step: Optional[int], items: Optional[int],
                 unit: str, flops: Optional[int], peak_flops: Optional[float],
                 sample_memory: bool, fields: Dict[str, Any],
                 clock=None):
        self.name = name
        self.step = step
        self.items = items
        self.unit = unit
        self.flops = flops
        self.peak_flops = peak_flops
        self.sample_memory = sample_memory
        self.fields = fields
        self._rec = None
        self.seconds = 0.0
        self.mfu: Optional[float] = None
        self.items_per_second: Optional[float] = None
        self._clock = clock
        self._events = None

    def __enter__(self):
        from ..profiler.utils import RecordEvent

        self._rec = RecordEvent(f"{self.name}.step")
        self._rec.begin()
        if self._clock is None and _card_in_use():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events = [start]
        self._t0 = (self._clock or time.perf_counter)()
        return self

    def abandon(self):
        """Close the profiler span without recording any metrics — for a
        region superseded before its ``end()`` ran, so the span stack
        stays balanced."""
        if self._rec is not None:
            self._rec.end()
            self._rec = None

    def __exit__(self, exc_type, exc, tb):
        now = (self._clock or time.perf_counter)()
        # the host's seconds; a device-timed region replaces them with the
        # events' once resolved
        self.seconds = max(now - self._t0, 1e-12)
        if self._events is not None and exc is None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events.append(end)
        if self._rec is not None:
            self._rec.end()
            self._rec = None
        if not _gate.state.on:
            return False
        if exc is not None:
            emit("train.step_failed", name=self.name, step=self.step,
                 seconds=self.seconds, error=f"{exc_type.__name__}: {exc}")
            flight.recorder.dump("step_exception", exc)
            return False
        if self._events is not None:
            flush_steps()              # the steps before this one
            _pending.append(self)
        else:
            self._resolve()
        if self.sample_memory:
            sample_device_memory()
        from . import health
        health.maybe_on_step((self._clock or time.perf_counter)())
        return False

    def _resolve(self):
        """Record the step's metrics and its ``train.step`` event."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self.seconds = max(start.elapsed_time(end) / 1e3, 1e-12)
            self._events = None
        M_STEP_SECONDS.observe(self.seconds, name=self.name)
        M_STEPS.inc(name=self.name)
        ev: Dict[str, Any] = {"name": self.name, "seconds": self.seconds}
        if self.step is not None:
            ev["step"] = self.step
        if self.items:
            self.items_per_second = self.items / self.seconds
            M_ITEMS_PER_SEC.set(self.items_per_second, name=self.name,
                                unit=self.unit)
            ev["items"] = self.items
            ev[f"{self.unit}_per_second"] = round(self.items_per_second, 2)
        if self.flops:
            peak = self.peak_flops or default_peak_flops()
            self.mfu = self.flops / self.seconds / peak
            M_MFU.set(round(self.mfu, 5), name=self.name)
            ev["mfu"] = round(self.mfu, 5)
        ev.update(self.fields)
        emit("train.step", **ev)


class _DisabledRegion:
    """Shared no-op returned by :func:`step_region` while observability is
    off — the disabled hot path allocates nothing and opens no span."""

    seconds = 0.0
    mfu = None
    items_per_second = None
    items = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def abandon(self):
        pass


_DISABLED_REGION = _DisabledRegion()


def step_region(name: str = "train", *, step: Optional[int] = None,
                items: Optional[int] = None, unit: str = "items",
                flops: Optional[int] = None,
                peak_flops: Optional[float] = None,
                sample_memory: bool = False, clock=None, **fields):
    """Context manager bracketing ONE training step.

    ``items`` is the tokens/samples consumed this step (drives
    ``train.items_per_second``); ``flops`` the per-step FLOP count
    (drives ``train.mfu`` against ``peak_flops``, defaulting to the
    card's peak). Extra keyword fields ride the ``train.step`` event.
    ``clock`` (a callable) times the step on the host; without one a
    step on the card is timed by CUDA events (module docstring).

    Usage::

        for step, batch in enumerate(loader):
            with obs.step_region("train", step=step, items=bs * seq,
                                 unit="tokens", flops=step_flops):
                loss = train_step(batch)
        obs.runtime.flush_steps()
    """
    if not _gate.state.on:
        return _DISABLED_REGION
    return _StepRegion(name, step, items, unit, flops, peak_flops,
                       sample_memory, fields, clock=clock)


class StepTimer:
    """Loop-lifetime helper over :func:`step_region`: counts steps,
    remembers the per-step FLOP/item constants, samples device memory
    every ``sample_memory_every`` steps, and supports the split
    ``begin()``/``end()`` form callback-style loops need. Call
    :meth:`flush` after the loop to record the last device-timed step.
    """

    def __init__(self, name: str = "train", *,
                 flops_per_step: Optional[int] = None,
                 items_per_step: Optional[int] = None, unit: str = "items",
                 peak_flops: Optional[float] = None,
                 sample_memory_every: int = 16, clock=None):
        self.name = name
        self.flops_per_step = flops_per_step
        self.items_per_step = items_per_step
        self.unit = unit
        self.peak_flops = peak_flops
        self.clock = clock        # injectable (FakeClock) for determinism
        self.sample_memory_every = max(0, int(sample_memory_every))
        self.count = 0
        self.last: Optional[_StepRegion] = None
        self._open: Optional[_StepRegion] = None

    def measure_flops(self, fn, *args, **kwargs) -> int:
        """Fix ``flops_per_step`` by counting one ``fn(*args)`` call
        (it runs: :func:`measure_step_flops`)."""
        self.flops_per_step = measure_step_flops(fn, *args, **kwargs)
        return self.flops_per_step

    def region(self, items: Optional[int] = None, **fields) -> _StepRegion:
        sample = (self.sample_memory_every > 0
                  and self.count % self.sample_memory_every == 0)
        r = step_region(
            self.name, step=self.count,
            items=self.items_per_step if items is None else items,
            unit=self.unit, flops=self.flops_per_step,
            peak_flops=self.peak_flops, sample_memory=sample,
            clock=self.clock, **fields)
        self.count += 1
        self.last = r
        return r

    def flush(self) -> None:
        """Record the steps still waiting for the card (:func:`flush_steps`)."""
        flush_steps()

    # -- split form for callback-driven loops ------------------------------
    def begin(self, **fields):
        if self._open is not None:
            self.abandon()
        self._open = self.region(**fields)
        self._open.__enter__()

    def abandon(self):
        """Discard an open region without recording it (balances the
        profiler span stack when end() will never arrive)."""
        r, self._open = self._open, None
        if r is not None:
            r.abandon()

    def end(self, items: Optional[int] = None, failed: bool = False):
        r, self._open = self._open, None
        if r is None:
            return
        if items is not None:
            r.items = items
        if failed:
            # synthesize an exception-shaped exit without a live traceback
            r.__exit__(RuntimeError, RuntimeError("step failed"), None)
        else:
            r.__exit__(None, None, None)
