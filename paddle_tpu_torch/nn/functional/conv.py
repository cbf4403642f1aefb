"""Convolution functional ops: ``conv1d`` / ``conv2d`` / ``conv3d`` and
their transposes, with paddle's signatures.

Counterpart of ``paddle_tpu/nn/functional/conv.py``. The reference
leaves convolution to XLA (``lax.conv_general_dilated``,
``lax.conv_transpose``), so here it is torch's convolution (cuDNN on the
card); no hand-written kernel stands behind it.

- Weights are ``[out, in / groups, *k]`` (the transposes' ``[in, out /
  groups, *k]``), as in torch and paddle.
- ``padding`` takes the reference's forms (``_pad_spec``): an int, one
  int per spatial dim, ``[lo0, hi0, lo1, hi1, ...]``, pairs (with or
  without the batch and channel pairs), ``"SAME"`` or ``"VALID"``.
  Asymmetric padding is applied with ``torch.nn.functional.pad``.
- ``data_format`` NCHW or NHWC (NCL / NLC, NCDHW / NDHWC); channels-last
  input is computed channels-first and permuted back.
- The transposes take the reference's padding rule (paddle's input
  padding, cropped from the full transposed convolution), and as the
  reference they append ``output_padding`` as zeros at the end of each
  spatial dim (before the bias) and ignore ``output_size``.

Every convolution runs through ``_Conv``, whose forward and backward
call ``aten.convolution`` / ``aten.convolution_backward`` with cuDNN's
deterministic algorithms (``_deterministic_cudnn``): cuDNN may pick
weight-gradient algorithms that sum in an order that changes from run
to run, and a captured training step must equal an eager one bit for
bit. The backward runs on autograd's thread after the forward has
returned, so the setting is made around each call, not once around the
forward.
"""
from __future__ import annotations

import contextlib
from numbers import Integral

import torch

from ...core.autocast import autocast_off, white_list_inputs

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose", "Conv2d"]


def _ntuple(v, n):
    if isinstance(v, Integral):
        return (int(v),) * n
    return tuple(int(x) for x in v)


def _pad_spec(padding, n, data_format):
    """The reference's padding forms -> ``"SAME"``, ``"VALID"`` or n
    (lo, hi) pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, Integral):
        return tuple((int(padding), int(padding)) for _ in range(n))
    padding = list(padding)
    if len(padding) == n and not isinstance(padding[0], (list, tuple)):
        return tuple((int(p), int(p)) for p in padding)
    if len(padding) == 2 * n:
        return tuple((int(padding[2 * i]), int(padding[2 * i + 1]))
                     for i in range(n))
    pairs = [tuple(int(x) for x in p) for p in padding]
    if len(pairs) == n + 2:
        pairs = pairs[2:] if data_format.startswith("NC") else pairs[1:-1]
    return tuple(pairs)


def _same_pairs(sizes, kernel, strides, dilations):
    """XLA's ``SAME`` padding: the output is ``ceil(in / stride)`` long,
    the padding split with the odd element at the end."""
    pairs = []
    for size, k, s, d in zip(sizes, kernel, strides, dilations):
        eff = (k - 1) * d + 1
        total = max((-(-size // s) - 1) * s + eff - size, 0)
        pairs.append((total // 2, total - total // 2))
    return tuple(pairs)


def _torch_pad(pairs):
    """(lo, hi) pairs in spatial order -> ``F.pad``'s last-dim-first
    list."""
    return [p for lo_hi in reversed(pairs) for p in lo_hi]


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block (the setting it
    had comes back after)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


class _Conv(torch.autograd.Function):
    """``aten.convolution`` with symmetric padding; the backward is
    ``aten.convolution_backward``. Both run under
    ``_deterministic_cudnn``."""

    @staticmethod
    @autocast_off
    def forward(ctx, x, w, b, stride, padding, dilation, transposed,
                output_padding, groups):
        ctx.args = (stride, padding, dilation, transposed, output_padding,
                    groups)
        ctx.bias_sizes = None if b is None else list(b.shape)
        ctx.save_for_backward(x, w)
        with _deterministic_cudnn():
            return torch.ops.aten.convolution(
                x, w, b, stride, padding, dilation, transposed,
                output_padding, groups)

    @staticmethod
    @autocast_off
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                ctx.bias_sizes is not None and ctx.needs_input_grad[2]]
        with _deterministic_cudnn():
            dx, dw, db = torch.ops.aten.convolution_backward(
                grad.contiguous(), x, w, ctx.bias_sizes, *ctx.args, mask)
        return dx, dw, db, None, None, None, None, None, None


def _to_nc(x, channels_first):
    return x if channels_first else x.movedim(-1, 1)


def _from_nc(y, channels_first):
    return y if channels_first else y.movedim(1, -1)


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format,
          n):
    x, weight = white_list_inputs(x, weight)
    if bias is not None:
        bias = bias.to(weight.dtype)
    cf = data_format.startswith("NC")
    x = _to_nc(x, cf)
    strides, dilations = _ntuple(stride, n), _ntuple(dilation, n)
    pad = _pad_spec(padding, n, data_format)
    if pad == "VALID":
        pad = ((0, 0),) * n
    elif pad == "SAME":
        pad = _same_pairs(x.shape[2:], weight.shape[2:], strides, dilations)
    if any(lo != hi for lo, hi in pad):
        x = torch.nn.functional.pad(x, _torch_pad(pad))
        sym = (0,) * n
    else:
        sym = tuple(lo for lo, _ in pad)
    y = _Conv.apply(x, weight, bias, strides, sym, dilations, False,
                    (0,) * n, int(groups))
    return _from_nc(y, cf)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 "NCW" if data_format == "NCL" else "NWC", 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 3)


def _transpose_pairs(pad, kernel, strides, dilations):
    """Paddle's input padding of a transposed convolution, as (lo, hi)
    crops of the full transposed output (a negative crop adds zeros):
    explicit pairs as given; ``SAME`` / ``VALID`` by ``lax.conv_transpose``'s
    rule on the dilated kernel."""
    if not isinstance(pad, str):
        return pad
    pairs = []
    for k, s, d in zip(kernel, strides, dilations):
        eff = (k - 1) * d + 1
        if pad == "SAME":
            total = eff + s - 2
            lo = eff - 1 if s > eff - 1 else -(-total // 2)
        else:
            total = eff + s - 2 + max(eff - s, 0)
            lo = eff - 1
        pairs.append((eff - 1 - lo, eff - 1 - (total - lo)))
    return tuple(pairs)


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, data_format, n):
    x, weight = white_list_inputs(x, weight)
    cf = data_format.startswith("NC")
    x = _to_nc(x, cf)
    strides, dilations = _ntuple(stride, n), _ntuple(dilation, n)
    out_pad = _ntuple(output_padding, n)
    pad = _transpose_pairs(_pad_spec(padding, n, data_format),
                           weight.shape[2:], strides, dilations)
    if all(lo == hi >= 0 for lo, hi in pad):
        y = _Conv.apply(x, weight, None, strides, tuple(lo for lo, _ in pad),
                        dilations, True, (0,) * n, int(groups))
    else:
        y = _Conv.apply(x, weight, None, strides, (0,) * n, dilations, True,
                        (0,) * n, int(groups))
        # a positive crop drops rows, a negative one appends zeros
        y = torch.nn.functional.pad(y, _torch_pad(
            [(-lo, -hi) for lo, hi in pad]))
    if any(out_pad):
        y = torch.nn.functional.pad(y, _torch_pad([(0, p) for p in out_pad]))
    if bias is not None:
        y = y + bias.to(y.dtype).reshape([1, -1] + [1] * n)
    return _from_nc(y, cf)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups,
                           "NCW" if data_format == "NCL" else "NWC", 1)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 2)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 3)


class Conv2d(torch.nn.Conv2d):
    """``torch.nn.Conv2d`` (``weight`` [out, in / groups, kh, kw], ``bias``)
    on :func:`conv2d`, for the models: the port's deterministic backward,
    NCHW."""

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.dilation, self.groups)
