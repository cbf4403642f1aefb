"""Captured calls: the port's counterpart of a jitted step.

The reference compiles a step once (``jax.jit``) and runs the executable
on every later call. The port records a step's kernels into a CUDA graph
once and replays the graph, one launch from the host for the whole
step. :class:`Graphed` is the one captured-callable type of the port:
the serving engine's decode tick and bursts, ``generate``'s decode ticks
and ``jit.to_static`` use it.

A call copies its inputs into static buffers (device tensors the graph
reads; the caller packs host values into one tensor, so a call makes one
host-to-device copy), then:

- the first call on a CUDA device runs the function eagerly on the
  capture stream and gives that run's outputs. This warm-up is the
  call's real work; it also builds the kernels and sets their
  attributes, and allocates the workspaces and the BLAS library's
  handle outside the graph. The allocator's cached blocks are released,
  then the function is captured into a graph with its own private
  memory pool. The explicit generators the warm-up
  drew from (``core/generator.py:recording``) and those passed in are
  registered with the graph first, so each replay advances their
  offsets as an eager call does, and a replayed sampled stream equals
  the eager one from the same seed;
- every later call replays the graph.

On the CPU, and while capture is turned off (:func:`enable_capture`),
nothing is captured: every call runs the function eagerly on the same
static buffers, so the CPU tests run all the plumbing but the graph.

A capture that fails on CUDA raises :class:`CaptureFailed`, which
carries the warm-up's outputs. No caller quietly gives way to eager, but
``jit.to_static(full_graph=False)``, which falls back as the reference's
does. The first call runs under :func:`is_capturing` on every device,
so code that reads the device from the host (``GradScaler``,
``clip_grad_norm_(error_if_nonfinite=True)``) raises
:class:`CaptureError` there (:func:`no_host_read`), on the CPU as on the
card.

Launch counts. A kernel wrapper in ``ops/cuda`` adds to its count when
Python runs it, and a replay runs no Python. So the capture notes each
count's change while it ran, takes it back (the capture launched
nothing), and every replay adds it again: the counts stay the launches
the card ran.

The paged decode kernel keeps a workspace per stream
(``ops/cuda/paged_attention._workspace``). The warm-up allocates the
capture stream's, and the graph keeps a reference to it.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

from .. import observability as obs
from ..core import generator as _generator
from ..ops import cuda as _kernels
from ..ops.cuda import paged_attention as _paged

__all__ = ["Graphed", "CaptureError", "CaptureFailed", "is_capturing",
           "no_host_read", "enable_capture", "capture_enabled"]

_M_CAPTURES = obs.counter(
    "jit.graph_captures", "CUDA graphs captured, by site")
_M_CAPTURE_SECONDS = obs.histogram(
    "jit.graph_capture_seconds", "host wall time of a graph's first call "
    "(the warm-up run and the capture), by site")

_local = threading.local()
_enabled = True
_streams = {}


class CaptureError(RuntimeError):
    """A captured step tried to read a device value on the host."""


class CaptureFailed(RuntimeError):
    """The capture failed after the warm-up run succeeded: ``cause`` is
    the capture's error, ``outputs`` the warm-up's outputs (the call's
    real result)."""

    def __init__(self, cause, outputs):
        super().__init__(f"CUDA graph capture failed: "
                         f"{type(cause).__name__}: {cause}")
        self.cause = cause
        self.outputs = outputs


def is_capturing() -> bool:
    """True inside a :class:`Graphed` function's first call (its warm-up
    and capture) on any device."""
    return getattr(_local, "capturing", False)


def no_host_read(what: str) -> None:
    """Raise :class:`CaptureError` if ``what`` (about to read a device
    value on the host) runs inside a capture."""
    if is_capturing():
        raise CaptureError(
            f"{what} reads a device value on the host, which a captured "
            f"step cannot do; call it outside the captured function")


def enable_capture(flag: bool) -> None:
    """Turn CUDA-graph capture on or off for every :class:`Graphed` call
    that follows: off, each call runs its function eagerly."""
    global _enabled
    _enabled = bool(flag)


def capture_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def _first_call():
    prev = is_capturing()
    _local.capturing = True
    try:
        yield
    finally:
        _local.capturing = prev


def _capture_stream(device) -> torch.cuda.Stream:
    """One side stream per device for every warm-up and capture."""
    stream = _streams.get(device.index)
    if stream is None:
        stream = _streams[device.index] = torch.cuda.Stream(device)
    return stream


def _map(out, fn):
    """``fn`` applied to every tensor of a (nested) tuple/list/dict."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_map(o, fn) for o in out)
    if isinstance(out, dict):
        return {k: _map(v, fn) for k, v in out.items()}
    return out


def _fresh(t):
    return t.detach().clone()


class Graphed:
    """``fn(*static_inputs)`` captured once and replayed (module
    docstring).

    ``fn`` takes the static input buffers (one per input of the calls,
    same shapes and dtypes on every call) and returns a tensor, a
    (nested) tuple/list/dict of tensors, or None; it may also change
    state it closes over (KV caches, counters on the device), which a
    replay changes the same way. ``generators``: explicit generators to
    register besides those the warm-up draws from. ``fresh_outputs``
    False returns the graph's own output tensors, which the next call
    overwrites. ``capture_scope``: a context manager factory entered
    around the capture only (``to_static`` undoes the capture's Python
    side effects there).
    """

    def __init__(self, fn, device, *, name: str = "graph", generators=(),
                 fresh_outputs: bool = True, capture_scope=None):
        self._fn = fn
        self.device = torch.device(device)
        self.name = name
        self._generators = list(generators)
        self._fresh_outputs = fresh_outputs
        self._scope = capture_scope or contextlib.nullcontext
        self._inputs = None
        self._graph = None
        self._outputs = None
        self._deltas = None
        self._keep = None
        self.calls = 0
        self.replays = 0
        self.capture_seconds = None

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self, *inputs):
        self._load(inputs)
        first = self.calls == 0
        self.calls += 1
        if self._graph is not None and _enabled:
            self._graph.replay()
            _kernels.add_launch_counts(self._deltas)
            self.replays += 1
            out = self._outputs
        elif first and self.device.type == "cuda" and _enabled:
            out = self._warm_and_capture()
        elif first:
            with _first_call():
                out = self._fn(*self._inputs)
        else:
            out = self._fn(*self._inputs)
        return _map(out, _fresh) if self._fresh_outputs else out

    def _load(self, inputs):
        if self._inputs is None:
            self._inputs = [torch.empty(x.shape, dtype=x.dtype,
                                        device=self.device)
                            for x in inputs]
        if len(inputs) != len(self._inputs):
            raise ValueError(f"{self.name}: {len(inputs)} inputs, captured "
                             f"with {len(self._inputs)}")
        with torch.no_grad():
            for s, x in zip(self._inputs, inputs):
                if x.shape != s.shape or x.dtype != s.dtype:
                    raise ValueError(
                        f"{self.name}: input {tuple(x.shape)} {x.dtype}, "
                        f"captured with {tuple(s.shape)} {s.dtype}")
                s.copy_(x, non_blocking=True)

    def _warm_and_capture(self):
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        stream = _capture_stream(dev)
        t0 = time.perf_counter()
        stream.wait_stream(cur)
        failed = None
        try:
            with torch.cuda.stream(stream), _first_call():
                with _generator.recording() as drawn:
                    warm = self._fn(*self._inputs)
                # as torch.cuda.graph does: the warm-up's freed blocks go
                # back to the card, or the graph's private pool would be
                # reserved beside them (a train step's activations twice)
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
                graph = torch.cuda.CUDAGraph()
                gens = {id(g): g for g in self._generators}
                gens.update(drawn)
                for gen in gens.values():
                    if gen.device.type == "cuda":
                        graph.register_generator_state(gen)
                before = _kernels.read_launch_counts()
                try:
                    with self._scope():
                        graph.capture_begin(capture_error_mode="global")
                        try:
                            outputs = self._fn(*self._inputs)
                        except BaseException:
                            with contextlib.suppress(Exception):
                                graph.capture_end()
                            raise
                        graph.capture_end()
                except Exception as e:
                    failed = e
                finally:
                    deltas = [a - b for a, b in
                              zip(_kernels.read_launch_counts(), before)]
                    _kernels.add_launch_counts([-d for d in deltas])
        finally:
            cur.wait_stream(stream)
        if failed is not None:
            raise CaptureFailed(failed, _map(warm, _fresh)) from failed
        self._graph, self._outputs, self._deltas = graph, outputs, deltas
        self._keep = _paged._workspace_of(dev, stream)
        self.capture_seconds = time.perf_counter() - t0
        _M_CAPTURES.inc(site=self.name)
        _M_CAPTURE_SECONDS.observe(self.capture_seconds, site=self.name)
        return warm
