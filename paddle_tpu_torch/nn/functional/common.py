"""Common functional ops: ``linear``, ``bilinear``, the dropouts,
``embedding``, ``one_hot``, ``label_smooth``, ``cosine_similarity``,
``interpolate`` / ``upsample``, ``pixel_shuffle``, ``pixel_unshuffle``,
``channel_shuffle``, ``unfold`` / ``fold``, ``pad`` and ``zeropad2d``.

Counterpart of ``paddle_tpu/nn/functional/common.py`` and of ``pad``
(``paddle_tpu/ops/manipulation.py``, which the reference's
``nn.functional`` re-exports). The reference composes them in XLA, so
here they are plain torch.

- ``linear`` takes paddle's ``[in, out]`` weight: ``x @ weight + bias``.
- ``dropout`` has paddle's ``axis`` (one mask shared along the other
  axes), both ``mode``s and the ``p == 1`` case. Its keep mask is drawn
  from an explicit ``generator=`` announced through
  ``core.generator.use_generator``, so a recompute region replays the
  same mask. Masks are the port's own stream, not ``jax.random``'s.
- ``embedding`` zeroes the rows of ``padding_idx`` in the output and
  gives that row of the weight no gradient; the gradient is summed in
  fp32 or wider and rounded once to the weight's dtype, as the
  reference's ``_embedding_vjp``. Ids out of range raise the reference's
  ``ValueError`` (one read of their extrema, skipped while a CUDA graph
  is being captured). The gradient's row sums are deterministic
  (``_row_sums``: no atomics), so a step gives the same bits every run
  and a captured step equals an eager one; ``torch.nn.Embedding``'s CUDA
  backward does not, where an id repeats thousands of times (BERT's
  token types). ``Embedding`` is ``torch.nn.Embedding`` on this
  function, without the host read of the bounds, for the models.
- ``dropout2d`` / ``dropout3d`` are ``dropout`` with one draw per
  (sample, channel); ``alpha_dropout`` sets dropped entries to SELU's
  negative saturation and rescales so that a standard-normal input keeps
  mean 0 and variance 1. Each draws from ``generator=``.
- ``one_hot`` returns float32, as the reference's ``one_hot_p``.
- ``cosine_similarity`` divides by ``max(|x1| * |x2|, eps)``: the product
  of the norms clamped once, as the reference (torch's own function
  clamps each norm).
- ``pad`` has paddle's two forms: ``2 * ndim`` entries are pairs in
  dimension order over every dim; fewer pad the trailing spatial dims
  (after the channel for ``NC*`` formats, before it for ``N*C``), last
  dim first. ``reflect`` (no edge repeat), ``replicate`` and
  ``circular`` on any dim, widths past the dim's size included (the
  pattern repeats, as ``jnp.pad``'s ``reflect`` / ``edge`` / ``wrap``):
  each padded dim is a concatenation of slices of the input, flipped or
  broadcast, so the backward is slicing and fixed-order sums (no
  scatter).
- ``interpolate`` is ``jax.image.resize`` as the reference calls it:
  ``nearest`` takes input ``floor((j + 0.5) * in / out)`` (align_corners
  ignored); ``bilinear`` / ``linear`` / ``trilinear`` / ``area`` take the
  triangle kernel and ``bicubic`` Keys' cubic (a = -0.5), as weight
  matrices built as ``jax.image.scale_and_translate`` builds them
  (antialiased when shrinking, the weights of taps inside the input
  renormalised at the edges); ``align_corners`` maps the corners onto
  each other through its scale and translation. Each resized dim is one
  product with its weight matrix in the input's dtype. A nearest resize
  by a whole factor repeats entries (its gradient a sum over the
  repeats, no scatter); any other factor gathers rows.
"""
from __future__ import annotations

import torch

from ...core.generator import use_generator

__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "one_hot", "label_smooth", "cosine_similarity",
           "bilinear", "Embedding", "interpolate", "upsample",
           "pixel_shuffle", "pixel_unshuffle", "channel_shuffle", "unfold",
           "fold", "pad", "zeropad2d"]


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]`` (paddle's
    layout)."""
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Zero each entry (or, with ``axis``, each slice along the other
    axes) with probability ``p``. ``mode="upscale_in_train"`` scales the
    kept entries by ``1 / (1 - p)`` in training and leaves inference
    alone; ``"downscale_in_infer"`` keeps them as they are in training
    and scales by ``1 - p`` in inference. ``p == 1`` gives zeros. A draw
    needs ``generator``."""
    p = float(p)
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return x * torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout draws a keep mask: pass generator= (a "
                         "torch.Generator on the input's device)")
    if axis is None:
        shape = x.shape
    else:
        axes = {int(a) % x.ndim for a in
                ((axis,) if isinstance(axis, int) else axis)}
        shape = tuple(n if i in axes else 1 for i, n in enumerate(x.shape))
    keep = torch.rand(shape, generator=use_generator(generator),
                      device=x.device) < (1.0 - p)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None,
              generator=None):
    """``dropout`` of whole feature maps: one draw per (sample,
    channel)."""
    axis = (0, 1) if data_format == "NCHW" else (0, 3)
    return dropout(x, p, axis=axis, training=training, generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None,
              generator=None):
    axis = (0, 1) if data_format == "NCDHW" else (0, 4)
    return dropout(x, p, axis=axis, training=training, generator=generator)


#: SELU's negative saturation, ``-scale * alpha``
_ALPHA_P = -1.0507009873554805 * 1.6732632423543772


def _alpha_mix(x, keep, p):
    a = ((1 - p) * (1 + p * _ALPHA_P ** 2)) ** -0.5
    b = -a * _ALPHA_P * p
    kept = torch.where(keep, x, torch.full((), _ALPHA_P, dtype=x.dtype,
                                           device=x.device))
    return a * kept + b


def alpha_dropout(x, p=0.5, training=True, name=None, generator=None):
    """Alpha dropout (for SELU networks): dropped entries become
    ``-scale * alpha``, then ``a * x + b`` restores a standard-normal
    input's mean and variance. A draw needs ``generator``."""
    p = float(p)
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("alpha_dropout draws a keep mask: pass generator= "
                         "(a torch.Generator on the input's device)")
    keep = torch.rand(x.shape, generator=use_generator(generator),
                      device=x.device) < (1.0 - p)
    return _alpha_mix(x, keep, p)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``label * (1 - epsilon)`` plus ``epsilon`` spread uniformly over
    the last axis, or ``epsilon * prior_dist``."""
    if prior_dist is not None:
        return label * (1 - epsilon) + prior_dist * epsilon
    return label * (1.0 - epsilon) + epsilon / label.shape[-1]


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    """``sum(x1 * x2) / max(|x1| * |x2|, eps)`` along ``axis`` (inputs
    broadcast)."""
    axis = int(axis)
    norms = (torch.linalg.vector_norm(x1, dim=axis)
             * torch.linalg.vector_norm(x2, dim=axis))
    return torch.sum(x1 * x2, dim=axis) / torch.clamp_min(norms, float(eps))


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] @ weight[o] @ x2[b] (+ bias)``; ``weight`` is
    ``[out, in1, in2]``."""
    y = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return y if bias is None else y + bias


def _row_sums(ids, rows, num, dtype):
    """``out[i] = sum of rows[t] where ids[t] == i`` ([num, D] in
    ``dtype``), deterministically: the rows in id order (a stable sort),
    their fp64 prefix sums along the tokens (a scan, on the transposed
    copy so it runs along the inner axis), and each id's sum the
    difference of the prefix sums at its run's ends, written once to its
    row (the other positions write a spare row, dropped). fp64 prefix
    sums of fp32 values err by about 1e-16 of the whole sum, far below
    one rounding to fp32."""
    t, d = rows.shape
    if t == 0:
        return torch.zeros(num, d, dtype=dtype, device=rows.device)
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    csum = rows[order].to(torch.float64).t().contiguous().cumsum(dim=1)
    csum = torch.cat([csum.new_zeros(d, 1), csum], dim=1)       # [D, T + 1]
    pos = torch.arange(t, device=ids.device)
    edge = sid[1:] != sid[:-1]
    true = torch.ones(1, dtype=torch.bool, device=ids.device)
    first = torch.cat([true, edge])
    last = torch.cat([edge, true])
    start = torch.where(first, pos, 0).cummax(dim=0).values
    sums = (csum[:, pos + 1] - csum[:, start]).t().to(dtype)
    out = torch.zeros(num + 1, d, dtype=dtype, device=rows.device)
    out.index_put_((torch.where(last, sid, num),), sums)
    return out[:num]


class _Embedding(torch.autograd.Function):
    """Row gather whose weight gradient is the deterministic row sum of
    the output gradient (``_row_sums``, fp64 prefix sums) rounded once to
    the weight's dtype; padding ids give zero rows and send no
    gradient."""

    @staticmethod
    def forward(ctx, weight, ids, padding_idx):
        out = weight[ids]
        if padding_idx is not None:
            out = out.masked_fill((ids == padding_idx)[..., None], 0)
        ctx.save_for_backward(ids)
        ctx.padding_idx = padding_idx
        ctx.weight_shape, ctx.weight_dtype = weight.shape, weight.dtype
        return out

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        if ctx.padding_idx is not None:
            grad = grad.masked_fill((ids == ctx.padding_idx)[..., None], 0)
        gw = _row_sums(ids.reshape(-1), grad.reshape(-1, grad.shape[-1]),
                       ctx.weight_shape[0], ctx.weight_dtype)
        return gw, None, None


def _check_bounds(ids, n):
    if (ids.numel() == 0 or (ids.is_cuda and
                             torch.cuda.is_current_stream_capturing())):
        return
    lo, hi = (int(e) for e in torch.stack([ids.min(), ids.max()]).tolist())
    if lo < 0 or hi >= n:
        raise ValueError(
            "Variable value (input) of OP(paddle.nn.functional.embedding) "
            f"expected >= 0 and < {n}, but got {lo if lo < 0 else hi}. "
            "Please check input value.")


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` [num, dim] at the integer ids ``x`` (ids first,
    as paddle). A negative ``padding_idx`` counts from the end."""
    ids = x.long()
    _check_bounds(ids, weight.shape[0])
    pi = None
    if padding_idx is not None:
        pi = int(padding_idx)
        if pi < 0:
            pi += weight.shape[0]
    return _Embedding.apply(weight, ids, pi)


def one_hot(x, num_classes, name=None):
    """float32 ``[..., num_classes]`` with a one at each integer id of
    ``x``. Ids outside ``[0, num_classes)`` raise on the CPU; on the card
    they trip a device assert (no host read, so it runs under capture)."""
    return torch.nn.functional.one_hot(x.long(), int(num_classes)).float()


class Embedding(torch.nn.Embedding):
    """``torch.nn.Embedding`` whose forward is :class:`_Embedding` (the
    deterministic gradient); ids are not read on the host (an id out of
    range trips torch's device-side check)."""

    def forward(self, ids):
        return _Embedding.apply(self.weight, ids.long(), self.padding_idx)


def _triangle(x):
    return torch.clamp_min(1 - x.abs(), 0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


_RESIZE_KERNELS = {"bilinear": _triangle, "linear": _triangle,
                   "trilinear": _triangle, "area": _triangle,
                   "bicubic": _keys_cubic}


def _weight_mat(m, n, inv_scale, translation, kernel):
    """``jax.image``'s ``compute_weight_mat`` in fp32: [m, n] weights of
    input taps for each output sample, ``inv_scale`` (input pixels per
    output pixel) and ``translation`` fp32 scalars, antialiased."""
    f32, dev = torch.float32, inv_scale.device
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample = ((torch.arange(n, dtype=f32, device=dev) + 0.5) * inv_scale
              - translation * inv_scale - 0.5)
    w = kernel((sample[None, :] - torch.arange(m, dtype=f32, device=dev)[
        :, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _resize_nearest(x, sizes):
    for ax, n in enumerate(sizes, start=2):
        m = x.shape[ax]
        if n == m:
            continue
        if n % m == 0:
            f = n // m
            x = x.unsqueeze(ax + 1).expand(
                *x.shape[:ax + 1], f, *x.shape[ax + 1:]).flatten(ax, ax + 1)
        else:
            idx = torch.floor((torch.arange(n, dtype=torch.float32,
                                            device=x.device) + 0.5)
                              * m / n).long()
            x = x.index_select(ax, idx)
    return x


def _resize_weighted(x, sizes, kernel, align_corners):
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=x.device)

    for ax, n in enumerate(sizes, start=2):
        m = x.shape[ax]
        if align_corners:
            scale = f32((m - 1) / (n - 1) if n > 1 else 0.0)
            inv = torch.where(scale > 0, 1.0 / torch.clamp_min(scale, 1e-12),
                              f32(1.0))
            w = _weight_mat(m, n, 1.0 / inv, 0.5 * (inv - 1), kernel)
        elif n == m:
            continue
        else:
            w = _weight_mat(m, n, f32(1.0 / (n / m)), f32(0.0), kernel)
        x = torch.tensordot(x, w.to(x.dtype),
                            dims=([ax], [0])).movedim(-1, ax)
    return x


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format=None,
                name=None):
    """Resize the spatial dims of ``x`` to ``size`` (or ``int(in *
    scale_factor)``), channels first unless ``data_format`` ends in C.
    ``align_mode`` is accepted and ignored, as in the reference."""
    n_sp = x.ndim - 2
    if data_format is None:
        data_format = {1: "NCW", 2: "NCHW", 3: "NCDHW"}[n_sp]
    cf = data_format.startswith("NC")
    spatial = x.shape[2:] if cf else x.shape[1:-1]
    if size is None:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * n_sp
        if isinstance(scale_factor, torch.Tensor):
            scale_factor = scale_factor.tolist()
        size = [int(s * f) for s, f in zip(spatial, scale_factor)]
    else:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        size = [int(s) for s in size]
    xc = x if cf else x.movedim(-1, 1)
    if mode == "nearest":
        y = _resize_nearest(xc, size)
    else:
        y = _resize_weighted(xc, size, _RESIZE_KERNELS[mode],
                             bool(align_corners))
    return y if cf else y.movedim(1, -1)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format=None, name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """Sliding [C * kh * kw] patches of NCHW ``x`` as [N, C * kh * kw,
    L]."""
    from .conv import _ntuple

    return torch.nn.functional.unfold(
        x, _ntuple(kernel_sizes, 2), dilation=_ntuple(dilations, 2),
        padding=_ntuple(paddings, 2), stride=_ntuple(strides, 2))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """The sum of ``unfold``'s patches [N, C * kh * kw, L] back into NCHW
    ``output_sizes``."""
    from .conv import _ntuple

    return torch.nn.functional.fold(
        x, _ntuple(output_sizes, 2), _ntuple(kernel_sizes, 2),
        dilation=_ntuple(dilations, 2), padding=_ntuple(paddings, 2),
        stride=_ntuple(strides, 2))


def _in_nchw(fn, x, data_format):
    if data_format.startswith("NC"):
        return fn(x)
    return fn(x.movedim(-1, 1)).movedim(1, -1)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return _in_nchw(lambda t: torch.nn.functional.pixel_shuffle(
        t, int(upscale_factor)), x, data_format)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return _in_nchw(lambda t: torch.nn.functional.pixel_unshuffle(
        t, int(downscale_factor)), x, data_format)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    def shuffle(t):
        n, c, rest = t.shape[0], t.shape[1], t.shape[2:]
        return t.reshape(n, int(groups), c // int(groups), *rest
                         ).transpose(1, 2).reshape(n, c, *rest)
    return _in_nchw(shuffle, x, data_format)


def _pad_index(n, lo, hi, mode):
    """Source index of each of the ``lo + n + hi`` output entries along
    one dim (``jnp.pad``'s ``reflect`` / ``edge`` / ``wrap``)."""
    out = []
    for j in range(-lo, n + hi):
        if mode == "replicate":
            out.append(min(max(j, 0), n - 1))
        elif mode == "circular":
            out.append(j % n)
        elif n == 1:
            out.append(0)
        else:
            m = j % (2 * (n - 1))
            out.append(m if m < n else 2 * (n - 1) - m)
    return out


def _pad_dim(x, dim, lo, hi, mode):
    """``x`` padded along ``dim`` as a concatenation of its runs: each
    maximal run of consecutive source indices that rises, falls or stays
    is a slice (flipped where it falls, broadcast where it stays)."""
    idx = _pad_index(x.shape[dim], lo, hi, mode)
    pieces, start = [], 0
    while start < len(idx):
        step = idx[start + 1] - idx[start] if start + 1 < len(idx) else 1
        if step not in (-1, 0, 1):
            step = 1
        end = start + 1
        while end < len(idx) and idx[end] - idx[end - 1] == step:
            end += 1
        count = end - start
        if step == 1:
            pieces.append(x.narrow(dim, idx[start], count))
        elif step == -1:
            pieces.append(x.narrow(dim, idx[end - 1], count).flip(dim))
        else:
            one = x.narrow(dim, idx[start], 1)
            shape = list(x.shape)
            shape[dim] = count
            pieces.append(one.expand(shape))
        start = end
    return torch.cat(pieces, dim=dim)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """paddle's ``nn.functional.pad`` (see the module docstring for the
    two forms of ``pad``)."""
    if isinstance(pad, torch.Tensor):
        pad = pad.tolist()
    pad = [int(p) for p in pad]
    nd = x.ndim
    widths = [(0, 0)] * nd
    if len(pad) == 2 * nd:
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        n_sp = len(pad) // 2
        spatial = (list(range(1, 1 + n_sp)) if data_format.endswith("C")
                   else list(range(nd - n_sp, nd)))
        for i, d in enumerate(reversed(spatial)):
            widths[d] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = [w for lo_hi in reversed(widths) for w in lo_hi]
        return torch.nn.functional.pad(x, flat, value=float(value))
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"pad: unsupported mode {mode!r}")
    for d, (lo, hi) in enumerate(widths):
        if lo or hi:
            x = _pad_dim(x, d, lo, hi, mode)
    return x


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zeros around the spatial dims: ``padding`` is ``[left, right, top,
    bottom]``."""
    pad = [int(p) for p in padding]
    return _in_nchw(lambda t: torch.nn.functional.pad(t, pad), x,
                           data_format)
