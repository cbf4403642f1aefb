"""RMSNorm forward: the hand-written CUDA kernel and its plain version.

Counterpart of ``paddle_tpu/ops/pallas/rms_norm.py::_rms_fwd``
(kernel source ``csrc/rms_norm.cu``). The backward (``_rms_bwd``) waits
for the training slice.

Routing: a CPU tensor takes :func:`rms_norm_reference`; a CUDA tensor
launches the kernel or raises. There is no fallback between the two.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rms_norm_fwd", "rms_norm_reference", "launches"]

#: kernel launches since the count was last reset (the main path's proof
#: that it ran the kernel); bumped only where the kernel is launched
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("rms_norm").rms_norm_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def rms_norm_reference(x: torch.Tensor, w: torch.Tensor, *,
                       eps: float) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * w per row in fp32, cast to x's
    dtype — the kernel's arithmetic in plain PyTorch."""
    xf = x.float()
    invr = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * invr * w.float()).to(x.dtype)


def _check(x, w):
    if x.ndim < 1 or w.ndim != 1 or w.shape[0] != x.shape[-1]:
        raise ValueError(
            f"rms_norm: w must be [hidden]={x.shape[-1:]} for x "
            f"{tuple(x.shape)}, got {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(
            f"rms_norm: x on {x.device} but w on {w.device}")


def rms_norm_fwd(x: torch.Tensor, w: torch.Tensor, *,
                 eps: float) -> torch.Tensor:
    """RMSNorm over the last dim. CPU tensors: the plain version; CUDA
    tensors: the kernel (fp32/bf16/fp16, contiguous)."""
    global launches
    _check(x, w)
    if x.device.type == "cpu":
        return rms_norm_reference(x, w, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in _build.DTYPE_CODES:
            raise TypeError(f"rms_norm kernel: unsupported {name} dtype "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rms_norm kernel: {name} must be contiguous")
    hidden = x.shape[-1]
    rows = x.numel() // hidden if hidden else 0
    y = torch.empty_like(x)
    if rows == 0:
        return y
    status = _kernel()(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows,
                       hidden, float(eps), _build.DTYPE_CODES[x.dtype],
                       _build.DTYPE_CODES[w.dtype],
                       _build.stream_ptr(x.device))
    _build.check_status(status, "rms_norm_fwd")
    launches += 1
    return y
