"""``paddle.save`` / ``paddle.load``.

Counterpart of ``paddle_tpu/framework/io_.py``: a pickle of the object
(nested dicts, lists and tuples) with every tensor replaced by a
payload of its dtype's name, its shape and its raw bytes, so bf16 keeps
its bits. The two packages read each other's files:

- the reference pickles its payload as the global
  ``paddle_tpu.framework.io_._TensorPayload``; ``load`` reads that name
  through an ``Unpickler`` whose ``find_class`` maps it to this
  module's ``_TensorPayload`` (the same slots), without importing the
  reference;
- ``save`` writes this module's payload under that same global name
  (``_Pickler.save_global``), so the reference's ``load`` reads the
  port's files.

``load`` returns torch tensors on ``device`` (None: the card; pass
``"cpu"`` for the CPU), or numpy arrays with ``return_numpy=True``
(numpy has no bfloat16: a bf16 tensor then raises ``TypeError``).
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

from ..core.place import resolve_device

__all__ = ["save", "load"]

#: where the reference defines the payload class its files name
_REFERENCE_MODULE = "paddle_tpu.framework.io_"

_DTYPES = {str(d).split(".")[1]: d for d in (
    torch.float64, torch.float32, torch.float16, torch.bfloat16,
    torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
    torch.bool, torch.complex64, torch.complex128)}


class _TensorPayload:
    """A tensor as its dtype's name, shape and raw bytes (the
    reference's slots)."""

    __slots__ = ("bytes", "dtype", "shape")

    def __init__(self, t: torch.Tensor):
        t = t.detach().to("cpu").contiguous()
        self.dtype = str(t.dtype).split(".")[1]
        self.shape = tuple(t.shape)
        self.bytes = t.reshape(-1).view(torch.uint8).numpy().tobytes()

    def to_tensor(self, device) -> torch.Tensor:
        dtype = _DTYPES.get(self.dtype)
        if dtype is None:
            raise TypeError(f"paddle.load: unsupported dtype {self.dtype!r}")
        raw = torch.frombuffer(bytearray(self.bytes), dtype=torch.uint8)
        return raw.view(dtype).reshape(self.shape).to(device)

    def to_numpy(self) -> np.ndarray:
        if self.dtype == "bfloat16":
            raise TypeError("paddle.load(return_numpy=True): numpy has no "
                            "bfloat16; load the tensor instead")
        return self.to_tensor("cpu").numpy()


class _Pickler(pickle._Pickler):
    """Writes ``_TensorPayload`` under the reference's global name."""

    def save_global(self, obj, name=None):
        if obj is not _TensorPayload:
            return super().save_global(obj, name)
        if self.proto >= 4:
            self.save(_REFERENCE_MODULE)
            self.save("_TensorPayload")
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{_REFERENCE_MODULE}\n"
                       f"_TensorPayload\n".encode("utf-8"))
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    """Reads the reference's payload name as this module's class."""

    def find_class(self, module, name):
        if (module, name) == (_REFERENCE_MODULE, "_TensorPayload"):
            return _TensorPayload
        return super().find_class(module, name)


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj, return_numpy, device):
    if isinstance(obj, _TensorPayload):
        return obj.to_numpy() if return_numpy else obj.to_tensor(device)
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy, device) for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4, **configs):
    """Pickle ``obj`` to ``path`` (its directory made), tensors as
    payloads (module docstring)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        _Pickler(f, protocol=protocol).dump(_pack(obj))


def load(path: str, return_numpy: bool = False, device=None,
         **configs) -> Any:
    """The object ``save`` (of either package) wrote to ``path``."""
    dev = None if return_numpy else resolve_device(device)
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, return_numpy, dev)
