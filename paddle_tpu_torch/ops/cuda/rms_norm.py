"""RMSNorm forward and backward: the hand-written CUDA kernels and their
plain versions.

Counterpart of ``paddle_tpu/ops/pallas/rms_norm.py::_rms_fwd`` and
``_rms_bwd`` (kernel source ``csrc/rms_norm.cu``).

Routing: a CPU tensor takes :func:`rms_norm_reference`; a CUDA tensor
launches the kernel or raises. There is no fallback between the two.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rms_norm_fwd", "rms_norm_reference", "rms_norm_bwd",
           "rms_norm_bwd_reference", "launches", "bwd_launches"]

#: kernel launches since the count was last reset (the main path's proof
#: that it ran the kernel); bumped only where the kernel is launched
launches = 0
#: backward launches (the row kernel and its dw reduction) since the reset
bwd_launches = 0

#: dw partial sums: about this many row blocks, each a run of whole rows
_BWD_BLOCKS = 1056

_fn = None
_bwd_fn = None


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


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load("rms_norm").rms_norm_bwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def rms_norm_reference(x: torch.Tensor, w: torch.Tensor, *,
                       eps: float) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * w per row in fp32, cast to x's
    dtype — the kernel's arithmetic in plain PyTorch."""
    xf = x.float()
    invr = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * invr * w.float()).to(x.dtype)


def rms_norm_bwd_reference(x, w, g, *, eps):
    """(dx, dw) of :func:`rms_norm_reference` for the output grad ``g`` in
    fp32, r recomputed from x: dx = g*w*r - x*mean(g*w*x)*r^3 in x's
    dtype, dw = sum over rows of g*x*r in w's dtype."""
    xf, wf, gf = x.float(), w.float(), g.float()
    invr = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    gw = gf * wf
    c = torch.mean(gw * xf, dim=-1, keepdim=True) * invr * invr * invr
    dx = gw * invr - xf * c
    dw = (gf * xf * invr).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


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


def rms_norm_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, *,
                 eps: float):
    """(dx, dw) of RMSNorm over the last dim for the output grad ``g``.
    CPU tensors: the plain version; CUDA tensors: the kernels
    (fp32/bf16/fp16, contiguous, g in x's dtype)."""
    global bwd_launches
    _check(x, w)
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"rms_norm_bwd: g {tuple(g.shape)} on {g.device} "
                         f"does not match x {tuple(x.shape)} on {x.device}")
    if x.device.type == "cpu":
        return rms_norm_bwd_reference(x, w, g, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    for name, t in (("x", x), ("w", w), ("g", g)):
        if t.dtype not in _build.DTYPE_CODES:
            raise TypeError(f"rms_norm_bwd kernel: unsupported {name} dtype "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rms_norm_bwd kernel: {name} must be "
                             f"contiguous")
    if g.dtype != x.dtype:
        raise TypeError(f"rms_norm_bwd kernel: g is {g.dtype}, x {x.dtype}")
    hidden = x.shape[-1]
    if 4 * hidden > _build.smem_limit(x.device):
        raise ValueError(f"rms_norm_bwd kernel: hidden {hidden} does not fit "
                         f"its fp32 dw partial in shared memory")
    rows = x.numel() // hidden if hidden else 0
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(w)
    rows_per_block = -(-rows // _BWD_BLOCKS)
    blocks = -(-rows // rows_per_block)
    dw = torch.empty_like(w)
    dw_part = torch.empty((blocks, hidden), dtype=torch.float32,
                          device=x.device)
    status = _bwd_kernel()(x.data_ptr(), w.data_ptr(), g.data_ptr(),
                           dx.data_ptr(), dw.data_ptr(), dw_part.data_ptr(),
                           rows, hidden, rows_per_block, float(eps),
                           _build.DTYPE_CODES[x.dtype],
                           _build.DTYPE_CODES[w.dtype],
                           _build.stream_ptr(x.device))
    _build.check_status(status, "rms_norm_bwd")
    bwd_launches += 1
    return dx, dw
