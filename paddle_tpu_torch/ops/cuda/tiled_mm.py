"""The conv-calibration tool's matmul probe: a hand-written CUDA kernel
and its plain version.

Counterpart of ``pallas_mm`` and its body ``mk`` in
``tools/conv_calibration.py`` (kernel source ``csrc/tiled_mm.cu``): bf16
``a [m, k]`` times bf16 ``b [k, n]`` -> bf16 ``[m, n]``, accumulated in
fp32 and rounded once. Any m, k and n are taken. The kernel runs on the
tensor cores in 128 x 128 tiles of C; where those make fewer blocks than
the card has SMs, :func:`_tile_config` splits K into ranges summed in a
fixed order (deterministic).

Routing: a CPU tensor takes :func:`tiled_mm_reference`; a CUDA tensor
launches the kernel or raises. There is no fallback between the two.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ...utils.flops import kernel_work

__all__ = ["tiled_mm", "tiled_mm_reference", "launches"]

#: kernel launches since the count was last reset
launches = 0

#: the kernel's C tile (rows, cols) and K step (csrc/tiled_mm.cu)
TILE, K_STEP = (128, 128), 64
#: streaming multiprocessors of an H100 SXM
H100_SMS = 132
#: the fewest K steps one range of a split takes
MIN_SPLIT_STEPS = 4

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("tiled_mm").tiled_mm
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(a, b):
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tiled_mm wants a [m, k] and b [k, n], got "
                         f"{tuple(a.shape)} / {tuple(b.shape)}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"tiled_mm takes bfloat16, got {a.dtype} / {b.dtype}")
    if 0 in a.shape or b.shape[1] == 0:
        raise ValueError("tiled_mm: empty operand")


def _blocks(m, n):
    """C tiles of an [m, n] output."""
    return -(-m // TILE[0]) * -(-n // TILE[1])


def _tile_config(m, k, n, sms=H100_SMS):
    """How many K ranges the kernel splits an ``[m, k] x [k, n]`` product
    into, a rule of the shape: 1 where the C tiles alone make at least one
    block per SM; else the fewest ranges that do, each at least
    ``MIN_SPLIT_STEPS`` K steps. ResNet-50 shape 2 at batch 64
    ([200704, 640] x [640, 128], 1568 tiles) takes 1; shape 17
    ([3136, 4608] x [4608, 512], 100 tiles) takes 2 (200 blocks)."""
    tiles = _blocks(m, n)
    if tiles >= sms:
        return 1
    steps = -(-k // K_STEP)
    return max(1, min(-(-sms // tiles), steps // MIN_SPLIT_STEPS))


def tiled_mm_reference(a, b):
    """The kernel's arithmetic in plain PyTorch: an fp32 product of the
    bf16 operands, rounded once to bf16 (``mk``'s
    ``preferred_element_type=float32`` then ``astype``)."""
    _check(a, b)
    return torch.matmul(a.float(), b.float()).to(torch.bfloat16)


def _tiled_mm_kernel(a, b):
    global launches
    if b.device != a.device:
        raise ValueError(f"tiled_mm kernel: b on {b.device}, a on {a.device}")
    a, b = a.contiguous(), b.contiguous()
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    splits = _tile_config(m, k, n, _build.sm_count(a.device))
    # fp32 partial sums of the K ranges, added by the kernel's second pass
    part = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
            if splits > 1 else None)
    status = _kernel()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                       None if part is None else part.data_ptr(), m, k, n,
                       splits, _build.stream_ptr(a.device))
    _build.check_status(status, "tiled_mm")
    launches += 1
    return out


def tiled_mm(a, b):
    """bf16 ``a @ b`` with fp32 accumulation. CPU tensors run the plain
    version, CUDA tensors the kernel."""
    _check(a, b)
    with kernel_work(0):        # the reference's call declares no cost
        if a.device.type == "cpu":
            return tiled_mm_reference(a, b)
        if a.device.type != "cuda":
            raise ValueError(f"tiled_mm: unsupported device {a.device}")
        return _tiled_mm_kernel(a, b)
