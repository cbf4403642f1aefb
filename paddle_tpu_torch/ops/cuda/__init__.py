"""The port's hand-written CUDA kernels, each with its plain PyTorch
version and a launch count. Sources live in ``paddle_tpu_torch/csrc/``.

Each wrapper adds one to its module's count where it launches its
kernel. A captured graph (``jit/_capture.py``) replays launches without
running the wrappers, so it adds each count's change during its capture
once per replay (:func:`launch_counters`).
"""
from __future__ import annotations

import importlib

__all__ = ["launch_counters", "read_launch_counts", "add_launch_counts"]

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
