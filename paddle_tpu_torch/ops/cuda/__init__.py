"""The port's hand-written CUDA kernels, each with its plain PyTorch
version and a launch count. Sources live in ``paddle_tpu_torch/csrc/``.

Each wrapper adds one to its module's count where it launches its
kernel. A wrapper takes a rank's local tensors only: a
``torch.distributed`` ``DTensor`` argument raises ``TypeError``
(:func:`refuse_dtensors`), never its whole tensor nor the plain version. A captured graph (``jit/_capture.py``) replays launches without
running the wrappers, so it adds each count's change during its capture
once per replay (:func:`launch_counters`).
"""
from __future__ import annotations

import importlib

__all__ = ["launch_counters", "read_launch_counts", "add_launch_counts",
           "refuse_dtensors"]

#: (module under ``ops/cuda``, attribute) of every launch count
_COUNTERS = (("flash_attention", "launches"),
             ("flash_attention", "bwd_launches"),
             ("rms_norm", "launches"), ("rms_norm", "bwd_launches"),
             ("paged_attention", "launches"),
             ("flash_attention_varlen", "launches"),
             ("flash_attention_varlen", "dq_launches"),
             ("flash_attention_varlen", "dkv_launches"),
             ("tiled_mm", "launches"))


_counters = []
_dtensor_type = []


def refuse_dtensors(name, *tensors):
    """Raise ``TypeError`` when an argument of kernel wrapper ``name`` is a
    ``DTensor``: a kernel computes on a rank's local tensors (a
    tensor-parallel layer hands it its shard)."""
    if not _dtensor_type:
        from torch.distributed.tensor import DTensor

        _dtensor_type.append(DTensor)
    for t in tensors:
        if isinstance(t, _dtensor_type[0]):
            raise TypeError(
                f"{name}: a DTensor argument; the kernel takes this rank's "
                f"local tensor (DTensor.to_local())")


def launch_counters():
    """(module, attribute) of every kernel's launch count."""
    if not _counters:
        _counters.extend((importlib.import_module(f"{__name__}.{mod}"), attr)
                         for mod, attr in _COUNTERS)
    return _counters


def read_launch_counts():
    """The counts now, in :func:`launch_counters`' order."""
    return [getattr(mod, attr) for mod, attr in launch_counters()]


def add_launch_counts(deltas):
    """Add ``deltas`` (in :func:`launch_counters`' order) to the counts."""
    for (mod, attr), d in zip(launch_counters(), deltas):
        if d:
            setattr(mod, attr, getattr(mod, attr) + d)
