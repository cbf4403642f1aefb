"""Device resolution for the port's entry points.

Counterpart of ``paddle_tpu/core/place.py``. There a Place names a jax
device and the accelerator is the TPU; here the accelerator is a CUDA
card and a place is a ``torch.device``.

The rule every entry point follows: ``device=None`` means the card. When
no card is visible the call raises instead of quietly running on the
CPU; the CPU is used only when the caller asks for it
(``device="cpu"``, as the CPU tests do, or ``set_device("cpu")`` for the
whole process, which is the same explicit request).

``set_device`` / ``get_device`` / ``device_count`` /
``is_compiled_with_cuda`` are the reference's ``paddle.device`` surface
(``paddle_tpu/core/place.py:97-129``). Paddle spells the card ``gpu``:
``get_device()`` returns ``"gpu:0"`` (or ``"cpu"``), and ``set_device``
takes ``"gpu"``, ``"gpu:1"``, ``"cuda:1"`` or ``"cpu"``.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["resolve_device", "device_of", "set_device", "get_device",
           "device_count", "is_compiled_with_cuda"]

#: the device ``set_device`` asked for (None: the card, the default)
_expected: Optional[torch.device] = None


def resolve_device(device=None) -> torch.device:
    """``None`` -> the device ``set_device`` chose, else ``cuda:0``
    (raises without a card); a string or ``torch.device`` is taken as
    given, and a CUDA one is checked."""
    if device is None:
        device = _expected if _expected is not None else "cuda"
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


def set_device(device: str) -> torch.device:
    """``paddle.device.set_device``: ``"cpu"``, or the card as ``"gpu"``,
    ``"gpu:N"``, ``"cuda"`` or ``"cuda:N"``. Later entry points called
    without ``device=`` run there. A card that is not visible raises
    here, as ``resolve_device`` would."""
    global _expected
    name, _, idx = str(device).partition(":")
    if name == "cpu":
        dev = torch.device("cpu")
    elif name in ("gpu", "cuda"):
        dev = resolve_device(f"cuda:{int(idx) if idx else 0}")
    else:
        raise ValueError(
            f"set_device: unsupported device {device!r} (use 'cpu', 'gpu' "
            f"or 'gpu:N')")
    _expected = dev
    return dev


def get_device() -> str:
    """``paddle.device.get_device``: ``"gpu:N"`` or ``"cpu"``. Without a
    ``set_device`` call it names the card when one is visible, else the
    CPU (a name, not a request: entry points still raise there)."""
    dev = _expected
    if dev is None:
        if not torch.cuda.is_available():
            return "cpu"
        dev = torch.device("cuda", torch.cuda.current_device())
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}"


def device_count() -> int:
    """Visible CUDA cards."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def is_compiled_with_cuda() -> bool:
    """Whether this torch build has CUDA (a build property, as in
    Paddle: True on a CUDA build without a card)."""
    return torch.backends.cuda.is_built()
