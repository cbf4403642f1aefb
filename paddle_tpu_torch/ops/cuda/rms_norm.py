"""RMSNorm forward and backward: the hand-written CUDA kernels and their
plain versions.

Counterpart of ``paddle_tpu/ops/pallas/rms_norm.py::_rms_fwd`` and
``_rms_bwd`` (kernel source ``csrc/rms_norm.cu``).

Routing: a CPU tensor takes :func:`rms_norm_reference`; a CUDA tensor
launches the kernel or raises. There is no fallback between the two.
Which of the kernel's variants runs, and on what grid, is
:func:`_launch_config`'s rule: "vector" where hidden is a multiple of the
16-byte access and every pointer is aligned to one, up to what registers
hold; "chunked" for wider rows; "scalar" for any other hidden or
alignment. Every variant computes in fp32 and rounds once, and any
hidden runs, forward and backward.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import _build, refuse_dtensors

__all__ = ["rms_norm_fwd", "rms_norm_reference", "rms_norm_bwd",
           "rms_norm_bwd_reference", "launches", "bwd_launches"]

#: kernel launches since the count was last reset (the main path's proof
#: that it ran the kernel); bumped only where the kernel is launched
launches = 0
#: backward launches (one per call: its kernels and the dw reduction)
bwd_launches = 0

#: threads of every block (csrc/rms_norm.cu kRmsThreads): 8 warps
_WARPS = 8
#: the vector variant: 16-byte accesses a lane holds of each row (at most
#: 4; 2 where the row allows), and warps per row (1, 2, 4 or 8)
_MAX_NV = 4
_TARGET_NV = 2
_MAX_WPR = 8
#: the chunked and scalar backward: accesses per thread in each row of its
#: column chunk (csrc/rms_norm.cu kRmsColVecs)
_COL_VECS = 2
#: blocks per SM of each grid (the best measured on an H100 at [8192, 2048]
#: and [2048, 2048] bf16; chip_smoke.py times the neighbouring choices)
_BLOCKS_PER_SM = {"vector": 4, "vector_bwd": 2, "rows": 4, "cols": 2}
#: variant codes of the C entry points (csrc/rms_norm.cu enum RmsVariant)
VARIANTS = {"vector": 0, "chunked": 1, "scalar": 2}
#: streaming multiprocessors of an H100 SXM: the default of _launch_config
H100_SMS = 132

_fn = None
_bwd_fn = None


class LaunchConfig(NamedTuple):
    """One call's variant and grid (see :func:`_launch_config`)."""
    variant: str            #: "vector", "chunked" or "scalar"
    vec: int                #: elements per access: 16 bytes of x, or 1
    nv: int                 #: accesses per thread in each row
    wpr: int                #: warps per row (vector variant), else 0
    grid: Tuple[int, int]   #: blocks (x, y)
    partials: int           #: rows of the backward's dw workspace (0 fwd)


def _pow2_at_least(n):
    return 1 << max(0, int(n) - 1).bit_length()


def _launch_config(rows, hidden, dtype, *, backward=False, aligned=True,
                   sms=H100_SMS):
    """The variant and grid of one call on ``rows`` x ``hidden`` in x's
    ``dtype`` (``aligned``: every pointer on a 16-byte boundary).

    - "vector": hidden a multiple of vec = 16 / itemsize and aligned. A
      row takes wpr warps, the fewest (a power of two up to 8) whose
      lanes hold at most 2 accesses of it each, or 8 warps holding up to
      4; where the rows fill less than one block per SM, enough warps
      (up to 8) to give each lane one access. nv is the accesses a lane
      then holds, rounded up to a power of two. A block of
      8 warps takes 8 / wpr rows at a time over a grid of at most 4
      blocks per SM (forward) or 2 (backward: x, g, w and the dw partial
      in registers), so each thread reuses its w across rows; the
      backward's grid is also its number of dw partial rows.
    - "chunked": aligned and hidden a multiple of vec but wider than
      8 x 32 x 4 accesses; "scalar" (vec 1): anything else. The forward
      takes a block per row over at most 4 blocks per SM; the backward a
      grid of (column chunks of 256 x 2 accesses, row runs) with about 2
      blocks per SM, one dw partial row per row run.
    """
    vec = 16 // (torch.finfo(dtype).bits // 8)
    if aligned and hidden % vec == 0:
        nvec = hidden // vec
        wpr = min(_MAX_WPR, _pow2_at_least(-(-nvec // (32 * _TARGET_NV))))
        if -(-rows // (_WARPS // wpr)) < sms:       # few rows: spread them
            wpr = min(_MAX_WPR, _pow2_at_least(-(-nvec // 32)))
        nv = _pow2_at_least(-(-nvec // (32 * wpr)))
        if nv <= _MAX_NV:
            per_sm = _BLOCKS_PER_SM["vector_bwd" if backward else "vector"]
            blocks = min(-(-rows // (_WARPS // wpr)), per_sm * sms)
            return LaunchConfig("vector", vec, nv, wpr, (blocks, 1),
                                blocks if backward else 0)
        variant = "chunked"
    else:
        variant, vec = "scalar", 1
    if not backward:
        return LaunchConfig(variant, vec, 1, 0,
                            (min(rows, _BLOCKS_PER_SM["rows"] * sms), 1), 0)
    chunks = -(-(hidden // vec) // (256 * _COL_VECS))
    runs = min(rows, -(-_BLOCKS_PER_SM["cols"] * sms // chunks))
    return LaunchConfig(variant, vec, _COL_VECS, 0, (chunks, runs), runs)


def _workspace_floats(cfg, rows, hidden):
    """fp32 elements of the backward's workspace: the dw partial rows, and
    for the chunked and scalar variants each row's two statistics."""
    extra = 0 if cfg.variant == "vector" else 2 * rows
    return extra + cfg.partials * hidden


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("rms_norm").rms_norm_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load("rms_norm").rms_norm_bwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float] + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
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
    refuse_dtensors("rms_norm", x, w)
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
    cfg = _launch_config(rows, hidden, x.dtype, aligned=_aligned(x, w, y),
                         sms=_build.sm_count(x.device))
    status = _kernel()(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows,
                       hidden, float(eps), VARIANTS[cfg.variant], cfg.nv,
                       cfg.wpr, cfg.grid[0], _build.DTYPE_CODES[x.dtype],
                       _build.DTYPE_CODES[w.dtype],
                       _build.stream_ptr(x.device))
    _build.check_status(status, f"rms_norm_fwd ({cfg.variant})")
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
    rows = x.numel() // hidden if hidden else 0
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(w)
    dw = torch.empty_like(w)
    cfg = _launch_config(rows, hidden, x.dtype, backward=True,
                         aligned=_aligned(x, w, g, dx),
                         sms=_build.sm_count(x.device))
    work = torch.empty(_workspace_floats(cfg, rows, hidden),
                       dtype=torch.float32, device=x.device)
    status = _bwd_kernel()(x.data_ptr(), w.data_ptr(), g.data_ptr(),
                           dx.data_ptr(), dw.data_ptr(), work.data_ptr(),
                           rows, hidden, float(eps), VARIANTS[cfg.variant],
                           cfg.nv, cfg.wpr, cfg.grid[0], cfg.grid[1],
                           _build.DTYPE_CODES[x.dtype],
                           _build.DTYPE_CODES[w.dtype],
                           _build.stream_ptr(x.device))
    _build.check_status(status, f"rms_norm_bwd ({cfg.variant})")
    bwd_launches += 1
    return dx, dw
