"""MobileNetV2.

Counterpart of ``paddle_tpu/vision/models/mobilenetv2.py``: inverted
residuals with linear bottlenecks, ``_make_divisible`` widths, with the
reference's state names (``features.0.0.weight``,
``features.1.conv.1.weight``, ``classifier.1.weight``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn.functional.conv import Conv2d
from ...nn.functional.norm import BatchNorm
from ._layers import (AdaptiveAvgPool2D, Dropout, ReLU6, ZooModel, finish,
                      refuse_pretrained, start)

__all__ = ["MobileNetV2", "mobilenet_v2"]


def _make_divisible(v, divisor=8, min_value=None):
    """``v`` rounded to the nearest multiple of ``divisor`` (at least
    ``min_value``), not more than 10% below ``v``."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(nn.Sequential):
    def __init__(self, in_planes, out_planes, kernel_size=3, stride=1,
                 groups=1, device=None):
        padding = (kernel_size - 1) // 2
        super().__init__(
            Conv2d(in_planes, out_planes, kernel_size, stride=stride,
                   padding=padding, groups=groups, bias=False,
                   device=device),
            BatchNorm(out_planes, device=device),
            ReLU6())


class InvertedResidual(nn.Module):
    def __init__(self, inp, oup, stride, expand_ratio, device=None):
        super().__init__()
        self.stride = stride
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res_connect = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden_dim, kernel_size=1,
                                     device=device))
        layers.extend([
            ConvBNReLU(hidden_dim, hidden_dim, stride=stride,
                       groups=hidden_dim, device=device),
            Conv2d(hidden_dim, oup, 1, bias=False, device=device),
            BatchNorm(oup, device=device)])
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        if self.use_res_connect:
            return x + self.conv(x)
        return self.conv(x)


class MobileNetV2(ZooModel):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, dtype=torch.float32, seed: int = 0):
        super().__init__()
        dev = start(self, device, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        # t (expansion), c (channels), n (repeats), s (stride)
        setting = [[1, 16, 1, 1], [6, 24, 2, 2], [6, 32, 3, 2],
                   [6, 64, 4, 2], [6, 96, 3, 1], [6, 160, 3, 2],
                   [6, 320, 1, 1]]
        input_channel = _make_divisible(32 * scale)
        self.last_channel = _make_divisible(1280 * max(1.0, scale))
        features = [ConvBNReLU(3, input_channel, stride=2, device=dev)]
        for t, c, n, s in setting:
            output_channel = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, output_channel, s if i == 0 else 1,
                    expand_ratio=t, device=dev))
                input_channel = output_channel
        features.append(ConvBNReLU(input_channel, self.last_channel,
                                   kernel_size=1, device=dev))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool2d_avg = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                Dropout(0.2, self.dropout_generator),
                nn.Linear(self.last_channel, num_classes, device=dev))
        finish(self, dev, dtype, seed)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        refuse_pretrained("mobilenet_v2")
    return MobileNetV2(scale=scale, **kwargs)
