"""Multi-tensor (``torch._foreach_*``) helpers for lists of mixed dtypes.

A foreach op runs as a few chunked launches only when every tensor of a
list shares a device and dtype; a mixed list falls back to one launch a
tensor. And ``torch._foreach_mul_`` by a 0-dim tensor reads the scalar
in the list's dtype on the card, so a bf16 list would round an fp32
scale to bf16 first (the CPU reads it in fp32).

New lists are views of one buffer per device and dtype (``_flat_like``):
a step that makes a hundred temporaries of a hundred sizes, some of which
outlive others, fragments the caching allocator's pool until it maps new
memory every step; one block of the same size is reused step after step.

Norms accumulate in fp64 on the CPU (``_norm_dtype``): torch's CPU
reductions add fp32 values in order, 0.5% off at 2 ** 26 elements; the
card's are trees, within an fp32 rounding of the fp64 norm.
"""
from __future__ import annotations

import torch

__all__ = ["fp32_copies", "scale_in_fp32_", "scaled_in_fp32",
           "norm_fp32", "global_norm_fp32"]

_ALIGN = 16         # elements: every view starts on a 16-byte boundary


def _flat_like(tensors, dtype=None):
    """Contiguous tensors shaped as ``tensors`` (in ``dtype``, else each
    one's own), views of one new buffer per (device, dtype)."""
    out = [None] * len(tensors)
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, dtype or t.dtype), []).append(i)
    for (device, dt), idx in groups.items():
        sizes = [-(-tensors[i].numel() // _ALIGN) * _ALIGN for i in idx]
        flat = torch.empty(sum(sizes), dtype=dt, device=device)
        for i, v in zip(idx, flat.split(sizes)):
            out[i] = v[:tensors[i].numel()].view(tensors[i].shape)
    return out


def fp32_copies(tensors):
    """fp32 copies of ``tensors`` in one multi-tensor copy."""
    out = _flat_like(tensors, torch.float32)
    torch._foreach_copy_(out, tensors)
    return out


def scale_in_fp32_(tensors, scale):
    """Multiply ``tensors`` in place by ``scale``, an fp32 scalar tensor on
    their device: each product in fp32, rounded once to its tensor's
    dtype, with no host read. fp32 tensors are scaled directly, the
    others through fp32 copies."""
    scale = scale.float()
    fp32 = [t for t in tensors if t.dtype == torch.float32]
    low = [t for t in tensors if t.dtype != torch.float32]
    if fp32:
        torch._foreach_mul_(fp32, scale)
    if low:
        wide = fp32_copies(low)
        torch._foreach_mul_(wide, scale)
        torch._foreach_copy_(low, wide)


def scaled_in_fp32(tensors, scale):
    """``scale_in_fp32_`` into new tensors: ``tensors`` are left alone."""
    scale = scale.float()
    out = list(tensors)
    fp32 = [i for i, t in enumerate(tensors) if t.dtype == torch.float32]
    low = [i for i, t in enumerate(tensors) if t.dtype != torch.float32]
    if fp32:
        for i, t in zip(fp32, torch._foreach_mul(
                [tensors[i] for i in fp32], scale)):
            out[i] = t
    if low:
        wide = fp32_copies([tensors[i] for i in low])
        torch._foreach_mul_(wide, scale)
        narrow = _flat_like([tensors[i] for i in low])
        torch._foreach_copy_(narrow, wide)
        for i, t in zip(low, narrow):
            out[i] = t
    return out


def _norm_dtype(t):
    return torch.float64 if t.device.type == "cpu" else torch.float32


def norm_fp32(t, ord=2.0):
    """``t``'s ``ord``-norm as an fp32 tensor (see the module docstring)."""
    return torch.linalg.vector_norm(t, ord, dtype=_norm_dtype(t)).float()


def global_norm_fp32(tensors, ord=2.0):
    """The ``ord``-norm of all ``tensors`` together, as an fp32 tensor on
    their device, with no host read: each tensor's norm in one
    ``torch._foreach_norm``, then the norm of those."""
    norms = torch._foreach_norm(tensors, ord, dtype=_norm_dtype(tensors[0]))
    return torch.linalg.vector_norm(torch.stack(norms), ord).float()
