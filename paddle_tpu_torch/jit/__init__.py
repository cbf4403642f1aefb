"""paddle.jit of the port: ``to_static`` over CUDA-graph capture.

Counterpart of ``paddle_tpu/jit/__init__.py``. The reference traces a
function with jax into one XLA executable per input signature, with the
parameters, buffers, optimizer accumulators and RNG lifted to
functional state, so a whole train step (``loss.backward()`` and
``opt.step()`` included) becomes one executable. The port captures the
function's kernels into one CUDA graph per signature
(``jit/_capture.py``). State stays where it is: the graph reads and
writes the tensors themselves.

As in the reference:

- the cache key: the arguments' structure with each tensor's shape and
  dtype, the ``training`` flags of the modules the function touches and
  the ids of its optimizers (modules and optimizers are found in the
  function's ``self``, closure, globals and arguments, as there);
- the metrics ``jit.compiles``, ``jit.cache_hits``,
  ``jit.compile_seconds`` (the first call of an entry) and
  ``jit.fallbacks``;
- the fallback contract: with ``full_graph=False`` a failure while an
  entry is captured warns, counts one ``jit.fallbacks`` and runs that
  signature eagerly from then on; with ``full_graph=True`` it raises; a
  failure of a replay is never caught;
- optimizers: the rate and the 1-based step count are device scalars
  that a call fills before the graph runs (``_lr_override`` /
  ``_step_override``, see ``optimizer/optimizer.py``), accumulators are
  made before the capture (``_ensure_accumulators``), and each replay
  adds the captured step's ``_step_count`` increments on the host;
- ``GradScaler.step`` reads ``found_inf`` on the host, as the
  reference's does, so inside ``to_static`` it fails like the
  reference's trace: ``CaptureError`` with ``full_graph=True``, a
  fallback otherwise.

What differs, and why:

- The first call of an entry runs the function eagerly (the capture's
  warm-up; its effects are the call's), then captures it from the
  gradients the call found. The capture's Python side effects are
  undone: the step counts go back and the gradients point where the
  warm-up left them. After each replay the gradients point at the
  tensors the graph wrote. A failure in the warm-up puts back the
  gradients and step counts it found before the fallback runs the
  function again (an optimizer update it made stays).
- The key also holds grad mode and the storage of every parameter,
  buffer, gradient, accumulator and master weight: reassigning
  ``p.data`` or a gradient, or loading an optimizer state, gives a new
  capture, where the old graph would read the old memory. In-place
  writes (``copy_``) are seen by the graph as they are.
- Outputs are detached copies, which the next replay does not touch;
  inputs enter as fresh leaves (``requires_grad`` as given), so a
  gradient never flows out of the function, as in the reference.
- On the CPU nothing is captured: each call runs the function eagerly on
  the entry's static inputs. The first call of an entry still runs under
  ``_capture.is_capturing``, so ``GradScaler`` fails there as on the
  card; other host reads are caught only by a capture on the card.
- ``jit.save`` / ``jit.load`` are not ported (``ROADMAP.md`` queue A
  item 7) and raise ``NotImplementedError``.

``enable_capture(False)`` turns CUDA-graph capture off for every
captured path of the port (``to_static``, the serving engine, ``generate``):
each call runs eagerly, which is how ``chip_smoke.py`` compares the two.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import time
import types
import warnings
from typing import Any, Dict, List

import numpy as np
import torch

from .. import observability as obs
from ..optimizer.optimizer import Optimizer
from ._capture import (CaptureError, CaptureFailed, Graphed, capture_enabled,
                       enable_capture, is_capturing)

__all__ = ["to_static", "StaticFunction", "enable_to_static",
           "not_to_static", "ignore_module", "InputSpec", "set_code_level",
           "set_verbosity", "save", "load", "CaptureError", "enable_capture",
           "capture_enabled", "is_capturing"]

_M_JIT_COMPILES = obs.counter(
    "jit.compiles", "to_static compiles (new input-signature cache entry)")
_M_JIT_HITS = obs.counter(
    "jit.cache_hits", "to_static calls served by an existing entry")
_M_JIT_COMPILE_SECONDS = obs.histogram(
    "jit.compile_seconds",
    "wall time of a to_static entry's first run (warm-up run + capture)")
_M_JIT_FALLBACKS = obs.counter(
    "jit.fallbacks", "to_static signatures that fell back to eager")

_to_static_enabled = True


def enable_to_static(flag: bool):
    """Off, every ``to_static`` function runs as the plain function."""
    global _to_static_enabled
    _to_static_enabled = bool(flag)


def not_to_static(fn):
    fn._not_to_static = True
    return fn


def ignore_module(modules):
    pass


_SOT_CODE_LEVEL = 0
_SOT_VERBOSITY = 0


def set_code_level(level=100, also_to_stdout=False):
    """Accepted for parity (the reference's bytecode-translation log
    level); capture translates no bytecode."""
    global _SOT_CODE_LEVEL
    _SOT_CODE_LEVEL = int(level)


def set_verbosity(level=0, also_to_stdout=False):
    """Accepted for parity (the reference's dy2static log level)."""
    global _SOT_VERBOSITY
    _SOT_VERBOSITY = int(level)


class InputSpec:
    """``paddle.static.InputSpec``: a shape (None or -1 for any size), a
    dtype (name or ``torch.dtype``) and a name."""

    def __init__(self, shape, dtype="float32", name=None,
                 stop_gradient=True):
        self.shape = tuple(-1 if s is None else int(s) for s in shape)
        self.dtype = (dtype if isinstance(dtype, torch.dtype)
                      else getattr(torch, str(dtype)))
        self.name = name
        self.stop_gradient = stop_gradient


def save(layer, path, input_spec=None, **configs):
    raise NotImplementedError(
        "jit.save is not ported yet (ROADMAP.md queue A item 7)")


def load(path, **configs):
    raise NotImplementedError(
        "jit.load is not ported yet (ROADMAP.md queue A item 7)")


# --------------------------------------------------------------------------
# what the function touches
# --------------------------------------------------------------------------
def _closure_objects(fn):
    objs = []
    if getattr(fn, "__self__", None) is not None:
        objs.append(fn.__self__)
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            objs.append(cell.cell_contents)
        except ValueError:
            pass
    code = getattr(fn, "__code__", None)
    if code is not None:
        g = getattr(fn, "__globals__", {})
        objs.extend(g[name] for name in code.co_names if name in g)
    return objs


def _discover(fn, args, kwargs):
    """Modules and optimizers the function touches: its ``self``, closure
    cells, referenced globals and arguments, through containers, nested
    functions and plain objects (the reference's discovery)."""
    modules: List[torch.nn.Module] = []
    optimizers: List[Optimizer] = []
    seen = set()

    def visit(o, depth=0):
        if id(o) in seen or depth > 6:
            return
        seen.add(id(o))
        if isinstance(o, torch.nn.Module):
            modules.append(o)
        elif isinstance(o, Optimizer):
            optimizers.append(o)
        elif isinstance(o, (list, tuple)):
            for x in o:
                visit(x, depth + 1)
        elif isinstance(o, dict):
            for x in o.values():
                visit(x, depth + 1)
        elif isinstance(o, types.FunctionType):
            for c in _closure_objects(o):
                visit(c, depth + 1)
        elif hasattr(o, "__dict__") and not isinstance(
                o, (torch.Tensor, type, types.ModuleType)):
            for x in vars(o).values():
                visit(x, depth + 1)

    for o in _closure_objects(fn):
        visit(o)
    for a in list(args) + list(kwargs.values()):
        visit(a)
    return modules, optimizers


def _state_tensors(modules, optimizers):
    """Parameters and buffers (deduplicated, in a fixed order)."""
    out: Dict[int, torch.Tensor] = {}
    for m in modules:
        for t in list(m.parameters()) + list(m.buffers()):
            out.setdefault(id(t), t)
    for o in optimizers:
        for p in o._parameter_list:
            out.setdefault(id(p), p)
    return list(out.values())


def _storage_key(tensors, optimizers):
    ptrs = [t.data_ptr() for t in tensors]
    ptrs += [0 if t.grad is None else t.grad.data_ptr() for t in tensors]
    for o in optimizers:
        for store in o._accumulators.values():
            ptrs += [a.data_ptr() for a in store.values()]
        ptrs += [w.data_ptr() for w in o._master_weights.values()]
    return tuple(ptrs)


# --------------------------------------------------------------------------
# argument and output structures
# --------------------------------------------------------------------------
def _flatten_args(obj, tensors: List[torch.Tensor], objs: Dict[int, Any]):
    """A hashable template; tensor leaves become ('T', index)."""
    if isinstance(obj, np.ndarray):
        obj = torch.from_numpy(obj)
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return ("T", len(tensors) - 1, obj.requires_grad)
    if isinstance(obj, (list, tuple)):
        return ("L" if isinstance(obj, list) else "t",
                tuple(_flatten_args(o, tensors, objs) for o in obj))
    if isinstance(obj, dict):
        return ("D", tuple(sorted((k, _flatten_args(v, tensors, objs))
                                  for k, v in obj.items())))
    if isinstance(obj, (int, float, str, bool, type(None), np.integer,
                        np.floating)):
        return ("C", obj)
    objs[id(obj)] = obj
    return ("O", id(obj))


def _unflatten_args(template, tensors, objs):
    kind = template[0]
    if kind == "T":
        return tensors[template[1]].detach().requires_grad_(template[2])
    if kind in ("L", "t"):
        seq = [_unflatten_args(t, tensors, objs) for t in template[1]]
        return seq if kind == "L" else tuple(seq)
    if kind == "D":
        return {k: _unflatten_args(v, tensors, objs) for k, v in template[1]}
    if kind == "C":
        return template[1]
    return objs[template[1]]


def _flatten_out(obj, tensors: List[torch.Tensor]):
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return ("T", len(tensors) - 1)
    if isinstance(obj, (list, tuple)):
        return ("L" if isinstance(obj, list) else "t",
                tuple(_flatten_out(o, tensors) for o in obj))
    if isinstance(obj, dict):
        return ("D", tuple((k, _flatten_out(v, tensors))
                           for k, v in obj.items()))
    return ("C", obj)


def _unflatten_out(template, tensors):
    kind = template[0]
    if kind == "T":
        return tensors[template[1]]
    if kind in ("L", "t"):
        seq = [_unflatten_out(t, tensors) for t in template[1]]
        return seq if kind == "L" else tuple(seq)
    if kind == "D":
        return {k: _unflatten_out(v, tensors) for k, v in template[1]}
    return template[1]


class _Snapshot:
    """Gradients and step counts before an entry's first call, put back
    when its warm-up fails (a gradient accumulated in place is copied
    back)."""

    def __init__(self, tensors, optimizers):
        self.grads = [(t, t.grad, None if t.grad is None else
                       t.grad.detach().clone()) for t in tensors]
        self.steps = [(o, o._step_count) for o in optimizers]

    def restore(self):
        with torch.no_grad():
            for t, g, copy in self.grads:
                if g is not None:
                    g.copy_(copy)
                t.grad = g
        for o, n in self.steps:
            o._step_count = n


class _Record:
    """What running the function told an entry: the output structure, and
    the capture's step-count increments and gradients. The captured
    function writes here, not to the entry, so that the entry, its graph
    and the function form no reference cycle (a cycle would hold the
    graph's memory until the garbage collector ran)."""
    __slots__ = ("out_template", "step_deltas", "grads_after")

    def __init__(self, n_optimizers):
        self.out_template = None
        self.step_deltas = [0] * n_optimizers
        self.grads_after = []


class _Entry:
    __slots__ = ("graphed", "optimizers", "tensors", "record", "fallback")

    def __init__(self, optimizers, tensors):
        self.graphed = None
        self.optimizers = optimizers
        self.tensors = tensors
        self.record = _Record(len(optimizers))
        self.fallback = False


class StaticFunction:
    """The captured-function cache: one entry (one graph) per key (see
    the module docstring)."""

    def __init__(self, fn, input_spec=None, build_strategy=None,
                 full_graph=False):
        functools.update_wrapper(self, fn)
        self._fn = fn
        self._cache: Dict[Any, _Entry] = {}
        self._input_spec = input_spec
        self._full_graph = full_graph

    def __get__(self, instance, owner):
        if instance is None:
            return self
        bound = StaticFunction(self._fn.__get__(instance, owner),
                               self._input_spec, full_graph=self._full_graph)
        try:
            object.__setattr__(instance, self._fn.__name__, bound)
        except Exception:
            pass
        return bound

    @property
    def code(self):
        import textwrap

        return textwrap.dedent(inspect.getsource(self._fn))

    def __call__(self, *args, **kwargs):
        if not _to_static_enabled:
            return self._fn(*args, **kwargs)
        modules, optimizers = _discover(self._fn, args, kwargs)
        for o in optimizers:
            o._ensure_accumulators()
        tensors = _state_tensors(modules, optimizers)
        inputs: List[torch.Tensor] = []
        objs: Dict[int, Any] = {}
        template = _flatten_args((args, kwargs), inputs, objs)
        key = (template,
               tuple((tuple(t.shape), t.dtype, t.device) for t in inputs),
               tuple(m.training for m in modules),
               tuple(id(o) for o in optimizers), torch.is_grad_enabled(),
               _storage_key(tensors, optimizers))
        label = getattr(self._fn, "__name__", "?")
        entry = self._cache.get(key)
        if entry is None:
            _M_JIT_COMPILES.inc(fn=label)
            entry = self._cache[key] = _Entry(optimizers, tensors)
            return self._first_call(entry, template, objs, inputs, args,
                                    kwargs, label)
        _M_JIT_HITS.inc(fn=label)
        if entry.fallback:
            return self._fn(*args, **kwargs)
        replays = entry.graphed.replays
        out = entry.graphed(*inputs, self._scalars(optimizers))
        rec = entry.record
        if entry.graphed.replays > replays:
            # the graph ran, not the Python: redo its host side effects
            for o, d in zip(optimizers, rec.step_deltas):
                o._step_count += d
            for t, g in rec.grads_after:
                t.grad = g
        return _unflatten_out(rec.out_template, out)

    @staticmethod
    def _scalars(optimizers):
        """The rate and the 1-based step count of every optimizer, one fp32
        host tensor (one copy to the device a call)."""
        return torch.tensor([o.get_lr() for o in optimizers]
                            + [o._step_count + 1 for o in optimizers],
                            dtype=torch.float32)

    def _first_call(self, entry, template, objs, inputs, args, kwargs,
                    label):
        fn, optimizers, tensors = self._fn, entry.optimizers, entry.tensors
        rec, n = entry.record, len(optimizers)

        def run(*static):
            *arg_tensors, scalars = static
            for i, o in enumerate(optimizers):
                o._lr_override, o._step_override = scalars[i], scalars[n + i]
            try:
                a, k = _unflatten_args(template, arg_tensors, objs)
                out = fn(*a, **k)
            finally:
                for o in optimizers:
                    o._lr_override = o._step_override = None
            flat: List[torch.Tensor] = []
            rec.out_template = _flatten_out(out, flat)
            return flat

        snapshot = _Snapshot(tensors, optimizers)

        def capture_scope():
            """The capture starts from the gradients the call found (the
            key's), and leaves the warm-up's gradients and step counts."""
            steps = [o._step_count for o in optimizers]
            warm_grads = [(t, t.grad) for t in tensors]
            for t, g, _ in snapshot.grads:
                t.grad = g
            try:
                yield
            finally:
                rec.step_deltas = [o._step_count - s
                                   for o, s in zip(optimizers, steps)]
                rec.grads_after = [(t, t.grad) for t in tensors]
                for o, s in zip(optimizers, steps):
                    o._step_count = s
                for t, g in warm_grads:
                    t.grad = g

        device = next((t.device for t in tensors + inputs), "cpu")
        entry.graphed = Graphed(
            run, device, name=f"to_static:{label}",
            capture_scope=contextlib.contextmanager(capture_scope))
        t0 = time.perf_counter()
        try:
            out = entry.graphed(*inputs, self._scalars(optimizers))
        except CaptureFailed as e:
            if self._full_graph:
                raise e.cause from e
            self._fall_back(entry, label, e.cause)
            return _unflatten_out(rec.out_template, e.outputs)
        except Exception as e:  # noqa: BLE001 — the reference's graph break
            snapshot.restore()
            if self._full_graph:
                raise
            self._fall_back(entry, label, e)
            return fn(*args, **kwargs)
        _M_JIT_COMPILE_SECONDS.observe(time.perf_counter() - t0, fn=label)
        return _unflatten_out(rec.out_template, out)

    def _fall_back(self, entry, label, error):
        warnings.warn(
            f"to_static: capturing '{label}' failed ({type(error).__name__}: "
            f"{error}); falling back to eager execution for this input "
            f"signature. Pass full_graph=True to make this an error.")
        entry.fallback = True
        _M_JIT_FALLBACKS.inc(fn=label)

    def concrete_program(self):
        return None


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=False, **kwargs):
    """``paddle.jit.to_static``: a function, or a module whose
    ``forward`` it wraps, captured per input signature (module
    docstring). ``full_graph=False`` (the reference's default) falls back
    to eager when a capture fails; ``full_graph=True`` raises."""

    def decorate(fn):
        if isinstance(fn, torch.nn.Module):
            fn.forward = StaticFunction(fn.forward, input_spec,
                                        full_graph=full_graph)
            return fn
        return StaticFunction(fn, input_spec, full_graph=full_graph)

    if function is not None:
        return decorate(function)
    return decorate
