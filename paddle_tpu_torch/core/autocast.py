"""How the port's own ops behave under ``torch.autocast``.

The reference's ``auto_cast`` casts the fp32 inputs of the ops on its
white list (matmuls, linear, attention) to the half dtype and leaves
every other op in the dtype it is given (``paddle_tpu/amp/__init__.py``).
``torch.autocast`` does that for torch's own ops, but the port's
autograd Functions (flash attention dense and varlen, RMSNorm) are
opaque to it, and the plain versions inside them would see their
einsums cast to half on the CPU. So:

- ``white_list_inputs`` casts fp32 inputs of a white-list entry point
  (``scaled_dot_product_attention``, ``flash_attn_unpadded``) to the
  autocast dtype when autocast is on for their device;
- ``autocast_off`` runs a Function's forward or backward with autocast
  off, so the kernel and its plain version compute in the dtypes they
  are given, inside an autocast region or out of it.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["white_list_inputs", "autocast_off"]


def white_list_inputs(*tensors):
    device = tensors[0].device.type
    if not torch.is_autocast_enabled(device):
        return tensors
    half = torch.get_autocast_dtype(device)
    return tuple(t.to(half) if t.dtype == torch.float32 else t
                 for t in tensors)


def autocast_off(method):
    """Decorate an autograd Function's ``forward(ctx, ...)`` or
    ``backward(ctx, ...)``: autocast is off on the device of its first
    tensor argument while it runs."""
    @functools.wraps(method)
    def run(ctx, *args):
        device = next(a.device.type for a in args
                      if isinstance(a, torch.Tensor))
        with torch.autocast(device, enabled=False):
            return method(ctx, *args)
    return run
