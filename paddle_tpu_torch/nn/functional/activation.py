"""Activation functional ops.

Counterpart of ``paddle_tpu/ops/activation.py`` (the 29 names that
``paddle_tpu/nn/functional/__init__.py`` re-exports) and of ``tanh``.
The reference composes all of them in XLA, so here they are plain torch,
with paddle's signatures and defaults, not torch's: ``softplus`` takes
``beta`` and ``threshold``, ``thresholded_relu`` a ``value``, ``rrelu``
``lower``/``upper`` and ``training`` (off by default), ``prelu`` a
``data_format``, ``glu`` and ``maxout`` an ``axis``, and
``softmax``/``log_softmax`` a ``dtype`` that casts the input first.

Where the reference differs from paddle the port follows the
reference: ``hardsigmoid`` takes ``slope`` and ``offset`` and computes
``clip(x / 6 + 0.5, 0, 1)`` whatever they are, as the reference does.
``gelu(approximate=False)`` is the exact erf form.

``rrelu`` in training and ``gumbel_softmax`` draw from an explicit
``generator=`` (a ``torch.Generator`` on the input's device) announced
through ``core.generator.use_generator``, so a recompute region replays
the draw; their streams are the port's own, not ``jax.random``'s.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.generator import use_generator

__all__ = [
    "relu", "relu6", "relu_", "leaky_relu", "elu", "selu", "celu", "gelu",
    "silu", "swish", "mish", "sigmoid", "hardsigmoid", "hardswish",
    "hardtanh", "hardshrink", "softshrink", "tanhshrink", "softplus",
    "softsign", "log_sigmoid", "softmax", "log_softmax", "prelu", "glu",
    "maxout", "thresholded_relu", "rrelu", "gumbel_softmax", "tanh",
]


def _softplus(x):
    """``log(1 + exp(x))`` without a threshold (``jax.nn.softplus``)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _need_generator(generator, what):
    if generator is None:
        raise ValueError(f"{what} draws random numbers: pass generator= (a "
                         f"torch.Generator on the input's device)")
    return use_generator(generator)


def relu(x, name=None):
    return torch.relu(x)


def relu_(x, name=None):
    """In-place ``relu``; returns ``x``."""
    return torch.relu_(x)


def relu6(x, name=None):
    return torch.clamp(x, 0, 6)


def leaky_relu(x, negative_slope=0.01, name=None):
    return TF.leaky_relu(x, float(negative_slope))


def elu(x, alpha=1.0, name=None):
    return TF.elu(x, float(alpha))


def selu(x, scale=1.0507009873554804934193349852946,
         alpha=1.6732632423543772848170429916717, name=None):
    return float(scale) * torch.where(x > 0, x, float(alpha) * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return TF.celu(x, float(alpha))


def gelu(x, approximate=False, name=None):
    """GELU: the exact erf form, or the tanh approximation."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def silu(x, name=None):
    return TF.silu(x)


def swish(x, name=None):
    return TF.silu(x)


def mish(x, name=None):
    return x * torch.tanh(_softplus(x))


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    """``clip(x / 6 + 0.5, 0, 1)``; ``slope`` and ``offset`` are accepted
    and change nothing, as in the reference."""
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def hardswish(x, name=None):
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, float(min), float(max))


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > float(threshold), x, _zero(x))


def softshrink(x, threshold=0.5, name=None):
    t = float(threshold)
    return torch.where(x > t, x - t, torch.where(x < -t, x + t, _zero(x)))


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """``x`` where ``beta * x > threshold``, else ``log(1 + exp(beta *
    x)) / beta``."""
    beta, threshold = float(beta), float(threshold)
    return torch.where(x * beta > threshold, x, _softplus(x * beta) / beta)


def softsign(x, name=None):
    return x / (1 + x.abs())


def log_sigmoid(x, name=None):
    return -_softplus(-x)


def _cast(x, dtype):
    if dtype is None:
        return x
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return x.to(dtype)


def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax over ``axis``; ``dtype`` casts the input first."""
    return torch.softmax(_cast(x, dtype), dim=int(axis))


def log_softmax(x, axis=-1, dtype=None, name=None):
    return torch.log_softmax(_cast(x, dtype), dim=int(axis))


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > float(threshold), x,
                       torch.full((), float(value), dtype=x.dtype,
                                  device=x.device))


def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where positive, else ``x * weight``: one weight, or one per
    channel (axis 1 for ``NC*`` formats, the last axis otherwise)."""
    shape = [1] * x.ndim
    if weight.numel() > 1:
        shape[1 if data_format[1] == "C" else x.ndim - 1] = weight.numel()
    return torch.where(x > 0, x, x * weight.reshape(shape))


def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=int(axis))
    return a * torch.sigmoid(b)


def maxout(x, groups, axis=1, name=None):
    """The max over each run of ``groups`` consecutive channels of
    ``axis``: ``[..., C, ...] -> [..., C // groups, ...]``."""
    axis = int(axis) % x.ndim
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // int(groups), int(groups)]
    return x.reshape(shape).amax(dim=axis + 1)


def rrelu(x, lower=0.125, upper=0.3333333333333333, training=False,
          name=None, generator=None):
    """Leaky ReLU with slope ``(lower + upper) / 2``; in training each
    negative entry takes its own slope drawn uniformly from ``[lower,
    upper)`` out of ``generator``."""
    if not training:
        return leaky_relu(x, (lower + upper) / 2)
    u = torch.rand(x.shape, generator=_need_generator(generator, "rrelu"),
                   device=x.device)
    slope = (u * (float(upper) - float(lower)) + float(lower)).to(x.dtype)
    return torch.where(x >= 0, x, x * slope)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None,
                   generator=None):
    """``softmax((x + g) / temperature)`` with Gumbel noise ``g`` drawn
    from ``generator``; ``hard`` returns the one-hot of the argmax with
    the soft sample's gradient (straight through)."""
    noise = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    noise.exponential_(generator=_need_generator(generator,
                                                 "gumbel_softmax"))
    g = (-torch.log(noise)).to(x.dtype)
    y = torch.softmax((x + g) / float(temperature), dim=int(axis))
    if hard:
        idx = torch.argmax(y, dim=int(axis), keepdim=True)
        onehot = torch.zeros_like(y).scatter_(int(axis), idx, 1.0)
        y = (onehot - y).detach() + y
    return y


def tanh(x, name=None):
    return torch.tanh(x)
