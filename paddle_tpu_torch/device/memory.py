"""Device memory statistics over the CUDA caching allocator.

Counterpart of ``paddle_tpu/device/memory.py``. There the allocator is
PJRT's and ``Device.memory_stats()`` reports it; here it is torch's CUDA
caching allocator, and :func:`memory_stats` reads
``torch.cuda.memory_stats`` under the reference's key names, so the
telemetry above it (``observability/runtime.py``) reads one shape on
both:

=======================  ==============================================
``bytes_in_use``         ``allocated_bytes.all.current``
``peak_bytes_in_use``    ``allocated_bytes.all.peak``
``bytes_reserved``       ``reserved_bytes.all.current`` (the cache too)
``peak_bytes_reserved``  ``reserved_bytes.all.peak``
``num_allocs``           ``allocation.all.current``
``bytes_limit``          ``get_device_properties(d).total_memory``
=======================  ==============================================

A process that has not touched the card (and the CPU) reports ``{}``, as
the reference's CPU client does; the CPU fallback of the telemetry is
:func:`live_array_bytes`, a scan of live CPU tensors. Reading the stats
never synchronizes the card: they are the allocator's host-side books.
"""
from __future__ import annotations

import gc
from typing import Dict, Optional

import torch

__all__ = ["memory_stats", "live_array_bytes", "memory_allocated",
           "max_memory_allocated", "memory_reserved", "max_memory_reserved",
           "empty_cache", "get_device_properties", "compiled_memory_stats",
           "vjp_residual_bytes"]

#: the reference's key -> torch's ``memory_stats`` key
_KEYS = {"bytes_in_use": "allocated_bytes.all.current",
         "peak_bytes_in_use": "allocated_bytes.all.peak",
         "bytes_reserved": "reserved_bytes.all.current",
         "peak_bytes_reserved": "reserved_bytes.all.peak",
         "num_allocs": "allocation.all.current"}


def _card(device_id: Optional[int]) -> Optional[torch.device]:
    """The card to read, or None where there is none to read (no card, or
    CUDA not initialized in this process: nothing is allocated there)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    idx = torch.cuda.current_device() if device_id is None else int(device_id)
    if not 0 <= idx < torch.cuda.device_count():
        return None
    return torch.device("cuda", idx)


def memory_stats(device_id: Optional[int] = None) -> Dict[str, int]:
    """Live allocator stats of one card under the reference's keys; ``{}``
    (never an exception) where there is no card in use or ``device_id``
    names none, so telemetry samplers never crash."""
    try:
        dev = _card(device_id)
        if dev is None:
            return {}
        raw = torch.cuda.memory_stats(dev)
        out = {key: int(raw.get(src, 0)) for key, src in _KEYS.items()}
        out["bytes_limit"] = int(
            torch.cuda.get_device_properties(dev).total_memory)
        return out
    except Exception:
        return {}


def live_array_bytes() -> int:
    """Bytes held by live CPU tensors in this process (each storage once):
    the CPU fallback of the device gauges, where no allocator reports. An
    under-count of the process's memory (no allocator slack, no scratch)
    that moves with the workload, as the reference's scan of live jax
    arrays."""
    seen = set()
    total = 0
    try:
        for obj in gc.get_objects():
            # type(), not isinstance(): the latter reads __class__, which
            # some deprecated proxies among gc's objects warn on
            if not issubclass(type(obj), torch.Tensor) \
                    or obj.device.type != "cpu":
                continue
            try:
                st = obj.untyped_storage()
            except Exception:       # sparse, meta and other storage-less
                continue
            key = (st.data_ptr(), st.nbytes())
            if key not in seen:
                seen.add(key)
                total += key[1]
    except Exception:
        return 0
    return int(total)


def memory_allocated(device_id: Optional[int] = None) -> int:
    return memory_stats(device_id).get("bytes_in_use", 0)


def max_memory_allocated(device_id: Optional[int] = None) -> int:
    s = memory_stats(device_id)
    return s.get("peak_bytes_in_use", s.get("bytes_in_use", 0))


def memory_reserved(device_id: Optional[int] = None) -> int:
    s = memory_stats(device_id)
    return s.get("bytes_reserved", s.get("bytes_in_use", 0))


def max_memory_reserved(device_id: Optional[int] = None) -> int:
    s = memory_stats(device_id)
    return s.get("peak_bytes_reserved", max_memory_allocated(device_id))


def empty_cache() -> None:
    """Drop dead Python references, then hand the allocator's cached,
    unused blocks back to the card."""
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def get_device_properties(device_id: Optional[int] = None):
    """``{"name", "platform", "id", "total_memory"}`` of the card
    (``platform`` ``"gpu"``), or of the CPU where there is no card
    (``total_memory`` 0, as the reference's CPU)."""
    if not torch.cuda.is_available():
        return {"name": "cpu", "platform": "cpu", "id": 0, "total_memory": 0}
    idx = torch.cuda.current_device() if device_id is None else int(device_id)
    p = torch.cuda.get_device_properties(idx)
    return {"name": p.name, "platform": "gpu", "id": idx,
            "total_memory": int(p.total_memory)}


def _graph_pool_bytes(graph) -> int:
    """Bytes of the segments the caching allocator holds in ``graph``'s
    private pool (``torch.cuda.memory_snapshot``'s ``segment_pool_id``)."""
    pool = tuple(graph.pool())
    return sum(int(seg["total_size"])
               for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors or ()
               if isinstance(t, torch.Tensor))


def compiled_memory_stats(jitted_fn, *args) -> Dict[str, int]:
    """Memory of the CUDA graphs a ``jit.to_static`` function has
    captured: ``temp_size_in_bytes`` is the graphs' private pools (what
    the reference's buffer assignment calls temporaries: every
    intermediate a replay writes), ``argument_size_in_bytes`` and
    ``output_size_in_bytes`` the graphs' static input and output buffers;
    ``alias_size_in_bytes`` and ``generated_code_size_in_bytes`` are 0
    (no aliasing pass, no generated code). The reference lowers the
    function at ``args`` without running it; capturing here means running
    it, so the port reports the graphs its calls made and takes ``args``
    for the reference's signature only. ``{}`` (never an exception) for a
    function that captured nothing: not a ``to_static`` function, not yet
    called, on the CPU, or fallen back to eager."""
    try:
        graphs = [e.graphed for e in getattr(jitted_fn, "_cache", {}).values()
                  if e.graphed is not None and e.graphed.captured]
        if not graphs:
            return {}
        return {
            "temp_size_in_bytes": sum(_graph_pool_bytes(g._graph)
                                      for g in graphs),
            "argument_size_in_bytes": sum(_nbytes(g._inputs) for g in graphs),
            "output_size_in_bytes": sum(_nbytes(g._outputs) for g in graphs),
            "alias_size_in_bytes": 0,
            "generated_code_size_in_bytes": 0,
        }
    except Exception:
        return {}


def vjp_residual_bytes(fn, *args) -> int:
    """Bytes that autograd saves between ``fn(*args)``'s forward and its
    backward (``torch.autograd.graph.saved_tensors_hooks`` sees each
    saved tensor; one tensor saved twice counts once): the forward ->
    backward live set that recomputation shrinks. Every floating-point
    argument is differentiated, as ``jax.vjp`` differentiates every
    argument in the reference."""
    leaves = [a.detach().requires_grad_(True)
              if isinstance(a, torch.Tensor) and a.is_floating_point() else a
              for a in args]
    seen = set()
    total = 0

    def pack(t):
        nonlocal total
        key = (t.data_ptr(), tuple(t.shape), t.dtype, tuple(t.stride()))
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*leaves)
    return int(total)
