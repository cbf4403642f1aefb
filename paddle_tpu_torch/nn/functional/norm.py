"""Normalization functional ops: ``rms_norm``, ``layer_norm``,
``batch_norm``, ``instance_norm``, ``group_norm``, ``normalize`` and
``local_response_norm``, and the ``BatchNorm`` and ``GroupNorm`` modules
the models use.

Counterpart of ``paddle_tpu/nn/functional/norm.py``. RMSNorm's routing
is the reference's: the fused kernel when its gate passes, the plain
composition otherwise. The others are XLA compositions in the reference
and torch ops here, with the reference's precision: statistics and the
affine in fp32 and one rounding to the input's dtype (LayerNorm and
InstanceNorm through an fp32 copy; BatchNorm and GroupNorm through
torch's kernels, which take their statistics and affine in fp32 for a
half input and round once). ``normalize`` and ``local_response_norm``
compute in the input's dtype, as the reference does.

Batch norm keeps paddle's conventions: ``momentum=0.9`` keeps 0.9 of the
running value (torch's ``momentum`` is the share of the new value, so
``1 - momentum`` is passed on), and the running variance takes the
unbiased ``n / (n - 1)`` of the batch variance. The running statistics
are updated in place in training mode unless ``use_global_stats``.

The port's gate states what ``csrc/rms_norm.cu`` accepts, not the TPU's
(8, 128) tile rule: the ``use_cuda_rms_norm`` flag is on, x and w are
float32, bfloat16 or float16, and w is ``[hidden]``. Any hidden size and
row count pass. The plain composition (``_rms_norm_fwd`` in the
reference: fp32 math, output in x's dtype) is the kernel's plain version
``ops/cuda/rms_norm.rms_norm_reference``; a CPU tensor that passes the
gate reaches it through the kernel's wrapper.
"""
from __future__ import annotations

import torch

from ...core.autocast import autocast_off
from ...core.flags import get_flag
from ...ops.cuda import rms_norm as _kernel

__all__ = ["rms_norm", "layer_norm", "batch_norm", "instance_norm",
           "group_norm", "normalize", "local_response_norm", "BatchNorm",
           "GroupNorm"]

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _use_kernel(x, w) -> bool:
    return (get_flag("use_cuda_rms_norm") and x.dtype in _DTYPES
            and w.dtype in _DTYPES and w.ndim == 1
            and w.shape[0] == x.shape[-1])


class _RmsNorm(torch.autograd.Function):
    """Forward and backward through the kernels; saves x and w (r is
    recomputed from x in the backward, as the reference does). Under
    autocast it runs in the dtypes it is given: RMSNorm is on the
    reference amp's black list."""

    @staticmethod
    @autocast_off
    def forward(ctx, x, w, eps):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _kernel.rms_norm_fwd(x, w, eps=eps)

    @staticmethod
    @autocast_off
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        dx, dw = _kernel.rms_norm_bwd(x, w, grad.contiguous(), eps=ctx.eps)
        return dx, dw, None


def rms_norm(x, weight, epsilon=1e-6, name=None):
    """RMSNorm over the last dim (reference
    ``paddle.incubate.nn.functional.fused_rms_norm``)."""
    if _use_kernel(x, weight):
        return _RmsNorm.apply(x, weight, float(epsilon))
    return _kernel.rms_norm_reference(x, weight, eps=float(epsilon))


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    """LayerNorm over the trailing ``normalized_shape`` dims of ``x``
    (``weight`` and ``bias`` of that shape, or None for ones and zeros):
    computed in fp32 and rounded once to x's dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    shape = tuple(int(n) for n in normalized_shape)
    w = None if weight is None else weight.float()
    b = None if bias is None else bias.float()
    return torch.nn.functional.layer_norm(x.float(), shape, w, b,
                                          float(epsilon)).to(x.dtype)


def _channel_axis(x, data_format):
    return 1 if x.ndim == 2 or data_format.startswith("NC") else x.ndim - 1


def batch_norm(x, running_mean, running_var, weight, bias, training=False,
               momentum=0.9, epsilon=1e-05, data_format="NCHW",
               use_global_stats=None, name=None):
    """Batch norm over every axis but the channel's; with batch statistics
    in training (the running ones updated in place, paddle's momentum),
    with the running statistics otherwise or under ``use_global_stats``."""
    ch = _channel_axis(x, data_format)
    use_stats = (use_global_stats if use_global_stats is not None
                 else not training)
    xc = x if ch == 1 else x.movedim(ch, 1)
    y = torch.nn.functional.batch_norm(
        xc, running_mean, running_var, weight, bias,
        training=not use_stats, momentum=1.0 - float(momentum),
        eps=float(epsilon))
    return y if ch == 1 else y.movedim(1, ch)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """Each instance and channel normalised over its spatial dims, in
    fp32; the running statistics, ``use_input_stats`` and ``momentum`` are
    ignored, as in the reference."""
    cf = data_format.startswith("NC")
    xc = x if cf else x.movedim(-1, 1)
    y = torch.nn.functional.instance_norm(
        xc.float(), weight=None if weight is None else weight.float(),
        bias=None if bias is None else bias.float(), eps=float(eps)
    ).to(x.dtype)
    return y if cf else y.movedim(1, -1)


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Each instance's channels in ``num_groups`` groups, each group
    normalised over its channels and spatial dims."""
    cf = data_format.startswith("NC")
    xc = x if cf else x.movedim(-1, 1)
    y = torch.nn.functional.group_norm(xc, int(num_groups), weight, bias,
                                       float(epsilon))
    return y if cf else y.movedim(1, -1)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    p = float(p)
    norm = torch.sum(x.abs() ** p, dim=int(axis), keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(norm, float(epsilon))


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * s) ** beta``, ``s`` the sum of squares over
    ``size`` channels around each (zero-padded; the reference does not
    divide ``alpha`` by ``size``)."""
    ch = 1 if data_format.startswith("NC") else x.ndim - 1
    half = int(size) // 2
    sq = torch.nn.functional.pad((x * x).movedim(ch, -1),
                                 (half, int(size) - half - 1))
    s = sq.unfold(-1, int(size), 1).sum(-1).movedim(-1, ch)
    return x / (k + alpha * s) ** beta


class BatchNorm(torch.nn.Module):
    """Batch norm with paddle's parameters and buffers: ``weight`` (ones),
    ``bias`` (zeros), and the running statistics ``_mean`` (zeros) and
    ``_variance`` (ones), named as the reference's; ``momentum`` keeps
    that share of the running value. ``model.to(dtype)`` casts the
    buffers too, as the reference's ``model.bfloat16()`` does."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 data_format="NCHW", device=None, dtype=torch.float32):
        super().__init__()
        factory = dict(device=device, dtype=dtype)
        self.momentum, self.epsilon = momentum, epsilon
        self.data_format = data_format
        self.weight = torch.nn.Parameter(torch.ones(num_features, **factory))
        self.bias = torch.nn.Parameter(torch.zeros(num_features, **factory))
        self.register_buffer("_mean", torch.zeros(num_features, **factory))
        self.register_buffer("_variance", torch.ones(num_features, **factory))

    def forward(self, x):
        return batch_norm(x, self._mean, self._variance, self.weight,
                          self.bias, training=self.training,
                          momentum=self.momentum, epsilon=self.epsilon,
                          data_format=self.data_format)


class GroupNorm(torch.nn.GroupNorm):
    """``torch.nn.GroupNorm`` (``weight``, ``bias``; eps 1e-5) on
    :func:`group_norm`."""

    def forward(self, x):
        return group_norm(x, self.num_groups, self.eps, self.weight,
                          self.bias)
