"""MobileNetV1.

Counterpart of ``paddle_tpu/vision/models/mobilenetv1.py``: depthwise
separable convolution stacks with the width multiplier ``scale``, with
the reference's state names (``conv1._conv.weight``,
``dwsl.0._depthwise_conv._norm_layer._mean``, ``fc.weight``). The
depthwise convolutions are grouped ``Conv2d``s (groups = channels).
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn.functional.conv import Conv2d
from ...nn.functional.norm import BatchNorm
from ._layers import (AdaptiveAvgPool2D, ReLU, ZooModel, finish,
                      refuse_pretrained, start)

__all__ = ["MobileNetV1", "mobilenet_v1"]


class ConvBNLayer(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, num_groups=1, device=None):
        super().__init__()
        self._conv = Conv2d(in_channels, out_channels, kernel_size,
                            stride=stride, padding=padding, groups=num_groups,
                            bias=False, device=device)
        self._norm_layer = BatchNorm(out_channels, device=device)
        self._act = ReLU()

    def forward(self, x):
        return self._act(self._norm_layer(self._conv(x)))


class DepthwiseSeparable(nn.Module):
    def __init__(self, in_channels, out_channels1, out_channels2, num_groups,
                 stride, scale, device=None):
        super().__init__()
        self._depthwise_conv = ConvBNLayer(
            in_channels, int(out_channels1 * scale), 3, stride, 1,
            num_groups=int(num_groups * scale), device=device)
        self._pointwise_conv = ConvBNLayer(
            int(out_channels1 * scale), int(out_channels2 * scale), 1, 1, 0,
            device=device)

    def forward(self, x):
        return self._pointwise_conv(self._depthwise_conv(x))


class MobileNetV1(ZooModel):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, dtype=torch.float32, seed: int = 0):
        super().__init__()
        dev = start(self, device, seed)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = ConvBNLayer(3, int(32 * scale), 3, 2, 1, device=dev)
        # (in, out1, out2, groups, stride), the reference's topology
        cfg = [
            (32, 32, 64, 32, 1), (64, 64, 128, 64, 2),
            (128, 128, 128, 128, 1), (128, 128, 256, 128, 2),
            (256, 256, 256, 256, 1), (256, 256, 512, 256, 2),
            (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1), (512, 512, 1024, 512, 2),
            (1024, 1024, 1024, 1024, 1),
        ]
        self.dwsl = nn.ModuleList([
            DepthwiseSeparable(int(i * scale), o1, o2, g, s, scale,
                               device=dev)
            for i, o1, o2, g, s in cfg])
        if with_pool:
            self.pool2d_avg = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(int(1024 * scale), num_classes, device=dev)
        finish(self, dev, dtype, seed)

    def forward(self, x):
        x = self.conv1(x)
        for dws in self.dwsl:
            x = dws(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        refuse_pretrained("mobilenet_v1")
    return MobileNetV1(scale=scale, **kwargs)
