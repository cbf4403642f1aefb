"""Runtime flags: the kernel routing switches and the distributed
timeout.

Counterpart of the ``use_pallas_flash_attention`` and
``use_pallas_rms_norm`` flags of ``paddle_tpu/core/flags.py``. They are
on by default and only the caller turns them off (to run a model on
its plain PyTorch compositions, for example as a reference); no
failure ever flips them. ``stop_check_timeout`` is the reference's
(``paddle_tpu/core/flags.py:158``): seconds before the communication
watchdog flags a wait as hung, and the process group's timeout. A flag
keeps the type of its default.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

__all__ = ["get_flag", "set_flags", "flags_scope"]

_FLAGS: Dict[str, Any] = {
    # scaled_dot_product_attention takes the flash kernels (forward
    # and backward) when their gate passes (nn/functional/attention.py)
    "use_cuda_flash_attention": True,
    # rms_norm takes the RMSNorm kernels (forward and backward) when
    # their gate passes
    # (nn/functional/norm.py)
    "use_cuda_rms_norm": True,
    # seconds: the communication watchdog's deadline and the process
    # group's timeout (distributed/communication/watchdog.py, env.py)
    "stop_check_timeout": 900,
}


def get_flag(name: str):
    return _FLAGS[name]


def set_flags(values: Dict[str, Any]) -> Dict[str, Any]:
    """Set flags; returns their previous values. Unknown names raise."""
    prev = {}
    for name, value in values.items():
        if name not in _FLAGS:
            raise KeyError(f"unknown flag {name!r}; known: {sorted(_FLAGS)}")
        prev[name] = _FLAGS[name]
        _FLAGS[name] = type(prev[name])(value)
    return prev


@contextlib.contextmanager
def flags_scope(**values):
    """``with flags_scope(use_cuda_flash_attention=False): ...``"""
    prev = set_flags(values)
    try:
        yield
    finally:
        set_flags(prev)
