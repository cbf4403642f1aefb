"""Device resolution for the port's entry points.

Counterpart of ``paddle_tpu/core/place.py``. There a Place names a jax
device and the accelerator is the TPU; here the accelerator is a CUDA
card and a place is a ``torch.device``.

The rule every entry point follows: ``device=None`` means the card. When
no card is visible the call raises instead of quietly running on the
CPU; the CPU is used only when the caller asks for it
(``device="cpu"``), as the CPU tests do.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "device_of"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0`` (raises without a card); a string or
    ``torch.device`` is taken as given, and a CUDA one is checked."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch: no CUDA device is visible. The port runs "
                "on the card by default; pass device='cpu' to run the plain "
                "PyTorch path on the CPU.")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(
            f"paddle_tpu_torch: unsupported device {device!r} (use 'cuda' "
            f"or 'cpu')")
    return dev


def device_of(module: torch.nn.Module) -> torch.device:
    """The device a module's parameters live on."""
    return next(module.parameters()).device
