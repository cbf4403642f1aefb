"""Thin paddle-signature layers for the vision models, over the port's
functional ops, and the constructors' shared set-up.

``MaxPool2D``, ``AvgPool2D``, ``AdaptiveAvgPool2D`` and ``Dropout`` keep
the reference's layer semantics (``paddle_tpu/nn/pooling_layers.py``,
``common_layers.py``): the pools are ``nn.functional``'s (``exclusive``
averages, the reference's padding forms, ``ceil_mode`` accepted and
ignored), and ``Dropout`` draws from the explicit generator it is given
(one per model, so that a captured step registers it). The activations
are ``nn.functional``'s, as modules. Parameterless layers are modules so
that ``nn.Sequential`` indices, and with them the state names
(``features.3.weight``), line up with the reference's.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.generator import make_generator
from ...core.place import resolve_device
from ...nn import functional as F
from ...nn.initializer import paddle_default_init_


class ZooModel(nn.Module):
    """The zoo's model classes: ``torch.nn.Module`` with a parameter
    count."""

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())


def refuse_pretrained(arch):
    """``<arch>(pretrained=True)``: the weights are a download, which the
    port does not make."""
    raise NotImplementedError(
        f"{arch}(pretrained=True): the pretrained weights are a download, "
        f"and the port reads no network; bridge local weights with "
        f"convert.load_paddle_tpu_state")


def start(model, device, seed):
    """The device (the card unless ``device="cpu"``; raises without one)
    and the model's dropout generator, seeded with ``seed``."""
    dev = resolve_device(device)
    model.dropout_generator = make_generator(seed, dev)
    return dev


def finish(model, dev, dtype, seed):
    """Draw the weights with the reference's layer defaults from ``seed``
    (``paddle_default_init_``) in fp32, then cast to ``dtype`` (batch
    norm's running statistics too)."""
    paddle_default_init_(model, make_generator(seed, dev))
    if dtype != torch.float32:
        model.to(dtype)


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding)


class AvgPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.exclusive = exclusive

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            exclusive=self.exclusive)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size)


class Dropout(nn.Module):
    """``nn.functional.dropout`` in training, the identity in eval."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p, self.generator = p, generator

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training,
                         generator=self.generator)


class _Act(nn.Module):
    fn = None

    def forward(self, x):
        return type(self).fn(x)


class ReLU(_Act):
    fn = staticmethod(F.relu)


class ReLU6(_Act):
    fn = staticmethod(F.relu6)


class Hardswish(_Act):
    fn = staticmethod(F.hardswish)


class Hardsigmoid(_Act):
    fn = staticmethod(F.hardsigmoid)


class Swish(_Act):
    fn = staticmethod(F.swish)
