"""SqueezeNet 1.0 and 1.1.

Counterpart of ``paddle_tpu/vision/models/squeezenet.py`` (fire modules),
with its state names (``_conv.weight``, ``_fires.0._conv_path2.bias``,
``_conv2.weight``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn.functional.conv import Conv2d
from ._layers import (AdaptiveAvgPool2D, Dropout, MaxPool2D, ReLU, ZooModel,
                      finish, refuse_pretrained, start)

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class MakeFire(nn.Module):
    def __init__(self, in_channels, squeeze_channels, expand1x1_channels,
                 expand3x3_channels, device=None):
        super().__init__()
        self._conv = Conv2d(in_channels, squeeze_channels, 1, device=device)
        self._conv_path1 = Conv2d(squeeze_channels, expand1x1_channels, 1,
                                  device=device)
        self._conv_path2 = Conv2d(squeeze_channels, expand3x3_channels, 3,
                                  padding=1, device=device)
        self._relu = ReLU()

    def forward(self, x):
        x = self._relu(self._conv(x))
        return torch.cat([self._relu(self._conv_path1(x)),
                          self._relu(self._conv_path2(x))], dim=1)


class SqueezeNet(ZooModel):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True,
                 device=None, dtype=torch.float32, seed: int = 0):
        super().__init__()
        dev = start(self, device, seed)
        self.version = version
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self._conv = Conv2d(3, 96, 7, stride=2, device=dev)
            fires = [(96, 16, 64, 64), (128, 16, 64, 64), (128, 32, 128, 128),
                     (256, 32, 128, 128), (256, 48, 192, 192),
                     (384, 48, 192, 192), (384, 64, 256, 256),
                     (512, 64, 256, 256)]
            self._pool_after = {0: True, 3: True, 7: True}
        elif version == "1.1":
            self._conv = Conv2d(3, 64, 3, stride=2, padding=1, device=dev)
            fires = [(64, 16, 64, 64), (128, 16, 64, 64), (128, 32, 128, 128),
                     (256, 32, 128, 128), (256, 48, 192, 192),
                     (384, 48, 192, 192), (384, 64, 256, 256),
                     (512, 64, 256, 256)]
            self._pool_after = {1: True, 3: True}
        else:
            raise ValueError(f"unsupported SqueezeNet version {version}")
        self._fires = nn.ModuleList([MakeFire(*f, device=dev) for f in fires])
        self._relu = ReLU()
        self._max_pool = MaxPool2D(3, 2)
        if num_classes > 0:
            self._drop = Dropout(0.5, self.dropout_generator)
            self._conv2 = Conv2d(512, num_classes, 1, device=dev)
        if with_pool:
            self._avg_pool = AdaptiveAvgPool2D(1)
        finish(self, dev, dtype, seed)

    def forward(self, x):
        x = self._max_pool(self._relu(self._conv(x)))
        for i, fire in enumerate(self._fires):
            x = fire(x)
            if self._pool_after.get(i):
                x = self._max_pool(x)
        if self.num_classes > 0:
            x = self._relu(self._conv2(self._drop(x)))
        if self.with_pool:
            x = self._avg_pool(x).flatten(1)
        return x


def _squeezenet(arch, version, pretrained, **kwargs):
    if pretrained:
        refuse_pretrained(arch)
    return SqueezeNet(version, **kwargs)


def squeezenet1_0(pretrained=False, **kwargs):
    return _squeezenet("squeezenet1_0", "1.0", pretrained, **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    return _squeezenet("squeezenet1_1", "1.1", pretrained, **kwargs)
