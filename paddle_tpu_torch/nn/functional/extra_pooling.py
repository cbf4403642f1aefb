"""The rest of the pools: ``max_unpool1d/2d/3d``, ``lp_pool1d/2d`` and
``fractional_max_pool2d/3d``.

Counterpart of ``paddle_tpu/nn/functional/extra_pooling.py``; plain
torch, as the reference leaves them to XLA:

- ``max_unpool*`` writes each value at its flat index over the output's
  spatial dims (the int32 indices ``max_pool*d(return_mask=True)``
  returns), zeros elsewhere; the output size defaults to ``(in - 1) *
  stride - 2 * padding + kernel``. Where overlapping windows repeat an
  index, the row's last entry writes it and takes its gradient, as the
  reference's ``.at[idx].set``; the writes are then unique, and the
  gradient a gather.
- ``lp_pool*`` is ``(sum |x|^p)^(1/p)`` over windows of the
  zero-padded input in fp32 (``p = inf``: the window's maximum, the
  zero padding included), cast back. ``ceil_mode`` adds the padding at
  the high end that one more window needs, as the reference.
- ``fractional_max_pool*`` takes its window starts from ``u``
  (``ceil(alpha * (i + u)) - ceil(alpha * u)``, ``alpha = in / out``;
  the last window ends at the input's end), and with ``kernel_size``
  each window is ``kernel`` wide from its start, clipped to the input.
  ``u`` is ``random_u``, or a draw in ``[1e-4, 1 - 1e-4)`` from
  ``generator=`` read on the host (the window bounds are host
  integers, as in the reference). The windows are gathered through
  ``_Embedding`` (deterministic gradient), padded with ``-inf`` to the
  widest, and reduced over all spatial dims at once; ``return_mask``
  gives each maximum's flat index over the input's spatial dims (the
  first maximum in row-major window order).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ...core.generator import use_generator
from .common import _Embedding
from .conv import _ntuple, _torch_pad
from .pooling import _window_sums

__all__ = [
    "max_unpool1d", "max_unpool2d", "max_unpool3d", "lp_pool1d", "lp_pool2d",
    "fractional_max_pool2d", "fractional_max_pool3d",
]


def _unpool(x, indices, kernel_size, stride, padding, output_size, nd,
            data_format):
    if data_format not in ("NCL", "NCHW", "NCDHW"):
        raise ValueError(f"unsupported data_format {data_format!r}")
    k = _ntuple(kernel_size, nd)
    s = _ntuple(stride if stride is not None else kernel_size, nd)
    p = _ntuple(padding, nd)
    if output_size is None:
        out_sp = tuple((x.shape[2 + i] - 1) * s[i] - 2 * p[i] + k[i]
                       for i in range(nd))
    else:
        out_sp = tuple(int(o) for o in list(output_size)[-nd:])
    n, c = x.shape[:2]
    size = math.prod(out_sp)
    idx = indices.reshape(n, c, -1).long()
    # where an index repeats, the last entry of the row writes it (and
    # takes the gradient), as ``.at[idx].set`` does; the others go to a
    # spare slot, so every write is unique
    pos = torch.arange(idx.shape[2], device=idx.device).expand_as(idx)
    last = torch.full((n, c, size), -1, dtype=torch.long, device=idx.device)
    last = last.scatter_reduce(2, idx, pos, reduce="amax")
    idx = torch.where(last.gather(2, idx) == pos, idx, size)
    flat = torch.zeros(n, c, size + 1, dtype=x.dtype, device=x.device)
    flat = flat.scatter(2, idx, x.reshape(n, c, -1))
    return flat[..., :size].reshape(n, c, *out_sp)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _unpool(x, indices, kernel_size, stride, padding, output_size, 1,
                   data_format)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _unpool(x, indices, kernel_size, stride, padding, output_size, 2,
                   data_format)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _unpool(x, indices, kernel_size, stride, padding, output_size, 3,
                   data_format)


def _lp_pool(x, p, kernel, stride, padding, ceil_mode):
    pairs = []
    for size, k, s, lo in zip(x.shape[2:], kernel, stride, padding):
        hi = lo
        if ceil_mode:
            total = size + 2 * lo
            out = -(-(total - k) // s) + 1
            hi += max(0, (out - 1) * s + k - total)
        pairs.append((lo, hi))
    xp = tF.pad(x.float(), _torch_pad(pairs))
    if p == float("inf"):
        pool = {1: tF.max_pool1d, 2: tF.max_pool2d}[len(kernel)]
        return pool(xp, kernel, stride).to(x.dtype)
    summed = _window_sums(xp.abs() ** p, kernel, stride)
    return (summed ** (1.0 / p)).to(x.dtype)


def _lp_pool_call(x, norm_type, kernel_size, stride, padding, ceil_mode,
                  data_format, nd, channels_last):
    k = _ntuple(kernel_size, nd)
    s = _ntuple(stride if stride is not None else kernel_size, nd)
    pad = _ntuple(padding, nd)
    if data_format == channels_last:
        return _lp_pool(x.movedim(-1, 1), float(norm_type), k, s, pad,
                        bool(ceil_mode)).movedim(1, -1)
    return _lp_pool(x, float(norm_type), k, s, pad, bool(ceil_mode))


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    return _lp_pool_call(x, norm_type, kernel_size, stride, padding,
                         ceil_mode, data_format, 1, "NLC")


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    return _lp_pool_call(x, norm_type, kernel_size, stride, padding,
                         ceil_mode, data_format, 2, "NHWC")


def _frac_windows(size, out, u, k):
    """(start, end) of each of ``out`` windows over ``size`` entries."""
    alpha = size / out
    base = math.ceil(alpha * u)
    bounds = [math.ceil(alpha * (i + u)) - base for i in range(out + 1)]
    bounds[-1] = size
    wins = []
    for i in range(out):
        lo = bounds[i]
        hi = bounds[i + 1] if k is None else min(lo + k, size)
        wins.append((lo, max(hi, lo + 1)))
    return wins


def _window_take(x, ax, wins):
    """``x`` with axis ``ax`` replaced by (window, position) axes: each
    window's entries, ``-inf`` past its end; and the source index of each
    (window, position), ``-1`` past the end."""
    width = max(hi - lo for lo, hi in wins)
    src = torch.tensor([[lo + j if lo + j < hi else -1 for j in range(width)]
                        for lo, hi in wins], device=x.device)
    moved = x.movedim(ax, 0)
    rest = moved.shape[1:]
    rows = _Embedding.apply(moved.reshape(moved.shape[0], -1),
                            src.clamp_min(0).reshape(-1), None)
    rows = rows.reshape(len(wins), width, *rest)
    pad = (src < 0).reshape(len(wins), width, *([1] * len(rest)))
    rows = rows.masked_fill(pad, float("-inf"))
    return rows.movedim((0, 1), (ax, ax + 1)), src


def _fractional(x, output_size, kernel_size, random_u, return_mask, nd,
                generator):
    if random_u is None:
        if generator is None:
            raise ValueError("fractional_max_pool draws u: pass random_u= or "
                             "generator= (a torch.Generator)")
        u = float(torch.rand((), generator=use_generator(generator),
                             device=generator.device)
                  * (1.0 - 2e-4) + 1e-4)
    else:
        u = float(random_u)
    spatial = x.shape[2:]
    out_sp = _ntuple(output_size, nd)
    ks = _ntuple(kernel_size, nd) if kernel_size is not None else [None] * nd
    vals, srcs = x, []
    for i in range(nd):
        wins = _frac_windows(spatial[i], out_sp[i], u, ks[i])
        vals, src = _window_take(vals, 2 + 2 * i, wins)
        srcs.append(src)
    # [N, C, o0, w0, o1, w1, ...] -> [N, C, o0, o1, ..., w0 * w1 * ...]
    n, c = x.shape[:2]
    order = ([0, 1] + [2 + 2 * i for i in range(nd)]
             + [3 + 2 * i for i in range(nd)])
    win = vals.permute(order).reshape(n, c, *out_sp, -1)
    out, arg = win.max(dim=-1)
    if not return_mask:
        return out
    coords, rest = [], arg
    for src in reversed(srcs):
        coords.append(rest % src.shape[1])
        rest = torch.div(rest, src.shape[1], rounding_mode="floor")
    flat = torch.zeros_like(arg)
    for i, (src, pos) in enumerate(zip(srcs, reversed(coords))):
        shape = [1] * (nd + 2)
        shape[2 + i] = out_sp[i]
        o = torch.arange(out_sp[i], device=x.device).reshape(shape)
        flat = flat * spatial[i] + src.reshape(-1)[o * src.shape[1] + pos]
    return out, flat.to(torch.int32)


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None, generator=None):
    return _fractional(x, output_size, kernel_size, random_u, return_mask, 2,
                       generator)


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None, generator=None):
    return _fractional(x, output_size, kernel_size, random_u, return_mask, 3,
                       generator)
