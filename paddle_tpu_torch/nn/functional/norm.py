"""Normalization functional ops: ``rms_norm`` and ``layer_norm``.

Counterpart of ``paddle_tpu/nn/functional/norm.py::rms_norm`` and
``::layer_norm``. RMSNorm's routing is the reference's: the fused kernel
when its gate passes, the plain composition otherwise. LayerNorm is XLA
composition in the reference (``_layer_norm_fwd``) and plain torch here,
with the reference's precision: fp32 statistics, the affine in fp32 and
one rounding to the input's dtype.

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

__all__ = ["rms_norm", "layer_norm"]

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
