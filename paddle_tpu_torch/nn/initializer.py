"""The default initializers of the reference's layers, for the port's
``torch.nn`` models.

Counterpart of the defaults ``paddle_tpu/nn`` gives its layers
(``conv_layers.py``, ``common_layers.py``, ``norm_layers.py``):
convolution weights normal with std ``sqrt(2 / fan_in)`` (fan_in = in /
groups x the kernel's size), ``Linear`` weights Xavier-normal (std
``sqrt(2 / (in + out))``), biases zero, norm weights one and biases
zero. The draws come from an explicit ``torch.Generator``; jax and torch
give different numbers from one seed, so tests that compare the two
packages bridge the reference's weights (``convert.py``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["paddle_default_init_"]

_CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d)
_NORMS = (nn.GroupNorm, nn.LayerNorm)


@torch.no_grad()
def paddle_default_init_(model: nn.Module, generator: torch.Generator):
    """Re-draw every ``Conv*d`` and ``Linear`` weight of ``model`` from
    ``generator``, zero their biases, and set every norm's weight to one
    and bias to zero (``GroupNorm``, ``LayerNorm`` and the port's
    ``BatchNorm``, whose running statistics are left alone)."""
    from .functional.norm import BatchNorm

    for mod in model.modules():
        if isinstance(mod, _CONVS):
            w = mod.weight
            fan_in = w.shape[1] * math.prod(w.shape[2:])
            w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
        elif isinstance(mod, nn.Linear):
            fan_out, fan_in = mod.weight.shape
            mod.weight.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                               generator=generator)
        elif isinstance(mod, _NORMS + (BatchNorm,)):
            mod.weight.fill_(1.0)
        else:
            continue
        if mod.bias is not None:
            mod.bias.zero_()
