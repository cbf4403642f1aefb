"""Pooling functional ops: max and average pooling in 1, 2 and 3 dims,
the adaptive pools and ``return_mask``.

Counterpart of ``paddle_tpu/nn/functional/pooling.py``, which reduces
windows with ``lax.reduce_window``; here torch's pooling ops, with the
reference's semantics where they differ from torch's:

- A max pool pads with ``-inf`` (torch's implicit padding, or
  ``F.pad`` with ``-inf`` where the padding is asymmetric or wider than
  half the window).
- An average pool pads with zeros. ``exclusive=True`` divides each
  window's sum by its count of unpadded elements, ``exclusive=False``
  by the window's size.
- ``ceil_mode`` and ``divisor_override`` are accepted and, as in the
  reference, ignored: outputs are floor-mode.
- ``padding`` is an int, one int per spatial dim, ``[lo0, hi0, ...]``,
  ``"SAME"`` or ``"VALID"``.
- ``return_mask`` returns int32 indices of each window's maximum,
  flat over the input's spatial dims (the first maximum of a window).
- The adaptive pools split each spatial dim into windows ``[floor(i *
  in / out), ceil((i + 1) * in / out))``, one dim after the other, each
  reduced in the input's dtype: equal windows as strided windows (with
  the stride of the first two, as the reference), others piece by piece.
  Equal windows that would repeat (an output a multiple of a smaller
  input, such as 1 to 6) raise ``ValueError``, where the reference's
  ``reduce_window`` refuses a stride of 0. ``adaptive_max_pool*``'s
  ``return_mask`` is ignored and ``adaptive_max_pool2d`` is NCHW, as in
  the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from .conv import _ntuple, _torch_pad

__all__ = [
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d",
    "max_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d",
]

_MAX = {1: tF.max_pool1d, 2: tF.max_pool2d, 3: tF.max_pool3d}
_AVG = {1: tF.avg_pool1d, 2: tF.avg_pool2d, 3: tF.avg_pool3d}


def _pairs(padding, sizes, kernel, stride):
    """The reference's padding -> (lo, hi) per spatial dim."""
    n = len(kernel)
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return ((0, 0),) * n
        pairs = []
        for size, k, s in zip(sizes, kernel, stride):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pairs.append((total // 2, total - total // 2))
        return tuple(pairs)
    if isinstance(padding, (list, tuple)) and len(padding) == 2 * n:
        return tuple((int(padding[2 * i]), int(padding[2 * i + 1]))
                     for i in range(n))
    return tuple((p, p) for p in _ntuple(padding, n))


def _setup(x, kernel_size, stride, padding, n, data_format):
    cf = data_format.startswith("NC")
    x = x if cf else x.movedim(-1, 1)
    kernel = _ntuple(kernel_size, n)
    stride = _ntuple(stride if stride is not None else kernel_size, n)
    pairs = _pairs(padding, x.shape[2:], kernel, stride)
    return x, cf, kernel, stride, pairs


def _symmetric(pairs, kernel):
    """torch's own padding where it can take the pairs: equal ends, at
    most half the window."""
    return all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pairs, kernel))


def _max(x, kernel_size, stride, padding, n, data_format, return_mask):
    x, cf, kernel, stride, pairs = _setup(x, kernel_size, stride, padding, n,
                                          data_format)
    if _symmetric(pairs, kernel):
        y = _MAX[n](x, kernel, stride, [lo for lo, _ in pairs],
                    return_indices=return_mask)
    else:
        xp = tF.pad(x, _torch_pad(pairs), value=float("-inf"))
        y = _MAX[n](xp, kernel, stride, 0, return_indices=return_mask)
        if return_mask:
            y = (y[0], _unpadded_index(y[1], xp.shape[2:], x.shape[2:],
                                       pairs))
    if not return_mask:
        return y if cf else y.movedim(1, -1)
    out, idx = y
    idx = idx.to(torch.int32)
    if not cf:
        out, idx = out.movedim(1, -1), idx.movedim(1, -1)
    return out, idx


def _unpadded_index(idx, padded, sizes, pairs):
    """Flat indices over the padded spatial dims -> over the input's."""
    flat = torch.zeros_like(idx)
    coords, rest = [], idx
    for size_p in reversed(padded):
        coords.append(rest % size_p)
        rest = rest // size_p
    coords.reverse()
    for c, size, (lo, _) in zip(coords, sizes, pairs):
        flat = flat * size + (c - lo)
    return flat


def _window_sums(x, kernel, stride):
    """Each window's sum (``divisor_override=1``; 1-d through 2-d)."""
    if len(kernel) == 1:
        return tF.avg_pool2d(x[..., None], (kernel[0], 1), (stride[0], 1),
                             divisor_override=1)[..., 0]
    pool = tF.avg_pool2d if len(kernel) == 2 else tF.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


def _avg(x, kernel_size, stride, padding, n, data_format, exclusive):
    x, cf, kernel, stride, pairs = _setup(x, kernel_size, stride, padding, n,
                                          data_format)
    if _symmetric(pairs, kernel):
        y = _AVG[n](x, kernel, stride, [lo for lo, _ in pairs],
                    count_include_pad=not exclusive)
    else:
        pad = _torch_pad(pairs)
        sums = _window_sums(tF.pad(x, pad), kernel, stride)
        if exclusive:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            y = sums / _window_sums(tF.pad(ones, pad), kernel, stride)
        else:
            y = sums / math.prod(kernel)
    return y if cf else y.movedim(1, -1)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _max(x, kernel_size, stride, padding, 1,
                "NCW" if data_format == "NCL" else "NWC", return_mask)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max(x, kernel_size, stride, padding, 2, data_format, return_mask)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max(x, kernel_size, stride, padding, 3, data_format, return_mask)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _avg(x, kernel_size, stride, padding, 1,
                "NCW" if data_format == "NCL" else "NWC", exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg(x, kernel_size, stride, padding, 2, data_format, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg(x, kernel_size, stride, padding, 3, data_format, exclusive)


def _adaptive(x, kind, output_size, n, data_format):
    cf = data_format.startswith("NC")
    off = 2 if cf else 1
    if isinstance(output_size, int):
        sizes = (int(output_size),) * n
    else:
        sizes = tuple(int(o) if o is not None else x.shape[off + i]
                      for i, o in enumerate(output_size))
    out = x
    for i, os in enumerate(sizes):
        ax = off + i
        size = out.shape[ax]
        starts = [(j * size) // os for j in range(os)]
        ends = [-(-((j + 1) * size) // os) for j in range(os)]
        widths = {e - s for s, e in zip(starts, ends)}
        if len(widths) == 1 and os > 1 and starts[1] == starts[0]:
            raise ValueError(
                f"adaptive pool: {os} equal windows over {size} entries "
                f"would repeat each window (stride 0); the reference "
                f"refuses this too")
        if widths == {size}:
            out = (out.amax(ax, keepdim=True) if kind == "max"
                   else out.sum(ax, keepdim=True) / size)
        elif len(widths) == 1:
            w = widths.pop()
            win = out.unfold(ax, w, starts[1] - starts[0])
            out = win.amax(-1) if kind == "max" else win.sum(-1) / w
        else:
            red = (lambda t: t.amax(ax, keepdim=True)) if kind == "max" \
                else (lambda t: t.mean(ax, keepdim=True))
            out = torch.cat([red(out.narrow(ax, s, e - s))
                             for s, e in zip(starts, ends)], dim=ax)
    return out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, "avg", output_size, 1, "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, "avg", output_size, 2, data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, "avg", output_size, 3, data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, "max", output_size, 1, "NCL")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, "max", output_size, 2, "NCHW")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, "max", output_size, 3, "NCDHW")
