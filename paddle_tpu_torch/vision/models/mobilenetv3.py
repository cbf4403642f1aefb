"""MobileNetV3, small and large.

Counterpart of ``paddle_tpu/vision/models/mobilenetv3.py``: inverted
residuals with squeeze-and-excitation blocks (Hardsigmoid gates) and
Hardswish, with the reference's state names (``features.0.weight``,
``features.4.block.6.fc1.weight``, ``classifier.3.weight``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn.functional.conv import Conv2d
from ...nn.functional.norm import BatchNorm
from ._layers import (AdaptiveAvgPool2D, Dropout, Hardsigmoid, Hardswish, ReLU,
                      ZooModel, finish, refuse_pretrained, start)
from .mobilenetv2 import _make_divisible

__all__ = ["MobileNetV3Small", "MobileNetV3Large",
           "mobilenet_v3_small", "mobilenet_v3_large"]


class SqueezeExcitation(nn.Module):
    def __init__(self, input_channels, squeeze_channels, device=None):
        super().__init__()
        self.avgpool = AdaptiveAvgPool2D(1)
        self.fc1 = Conv2d(input_channels, squeeze_channels, 1, device=device)
        self.relu = ReLU()
        self.fc2 = Conv2d(squeeze_channels, input_channels, 1, device=device)
        self.hardsigmoid = Hardsigmoid()

    def forward(self, x):
        return x * self.hardsigmoid(self.fc2(self.relu(self.fc1(
            self.avgpool(x)))))


class InvertedResidualV3(nn.Module):
    def __init__(self, inp, exp, out, kernel, stride, use_se, activation,
                 device=None):
        super().__init__()
        self.use_res = stride == 1 and inp == out
        act = Hardswish if activation == "HS" else ReLU
        layers = []
        if exp != inp:
            layers += [Conv2d(inp, exp, 1, bias=False, device=device),
                       BatchNorm(exp, device=device), act()]
        layers += [Conv2d(exp, exp, kernel, stride=stride,
                          padding=(kernel - 1) // 2, groups=exp, bias=False,
                          device=device),
                   BatchNorm(exp, device=device), act()]
        if use_se:
            layers.append(SqueezeExcitation(exp, _make_divisible(exp // 4),
                                            device=device))
        layers += [Conv2d(exp, out, 1, bias=False, device=device),
                   BatchNorm(out, device=device)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        y = self.block(x)
        return x + y if self.use_res else y


# (kernel, exp, out, SE, activation, stride), the reference's settings
_LARGE = [
    (3, 16, 16, False, "RE", 1), (3, 64, 24, False, "RE", 2),
    (3, 72, 24, False, "RE", 1), (5, 72, 40, True, "RE", 2),
    (5, 120, 40, True, "RE", 1), (5, 120, 40, True, "RE", 1),
    (3, 240, 80, False, "HS", 2), (3, 200, 80, False, "HS", 1),
    (3, 184, 80, False, "HS", 1), (3, 184, 80, False, "HS", 1),
    (3, 480, 112, True, "HS", 1), (3, 672, 112, True, "HS", 1),
    (5, 672, 160, True, "HS", 2), (5, 960, 160, True, "HS", 1),
    (5, 960, 160, True, "HS", 1),
]
_SMALL = [
    (3, 16, 16, True, "RE", 2), (3, 72, 24, False, "RE", 2),
    (3, 88, 24, False, "RE", 1), (5, 96, 40, True, "HS", 2),
    (5, 240, 40, True, "HS", 1), (5, 240, 40, True, "HS", 1),
    (5, 120, 48, True, "HS", 1), (5, 144, 48, True, "HS", 1),
    (5, 288, 96, True, "HS", 2), (5, 576, 96, True, "HS", 1),
    (5, 576, 96, True, "HS", 1),
]


class _MobileNetV3(ZooModel):
    def __init__(self, cfg, last_exp, scale=1.0, num_classes=1000,
                 with_pool=True, device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        dev = start(self, device, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        inp = _make_divisible(16 * scale)
        layers = [Conv2d(3, inp, 3, stride=2, padding=1, bias=False,
                         device=dev),
                  BatchNorm(inp, device=dev), Hardswish()]
        for k, exp, out, se, act, s in cfg:
            exp_c = _make_divisible(exp * scale)
            out_c = _make_divisible(out * scale)
            layers.append(InvertedResidualV3(inp, exp_c, out_c, k, s, se, act,
                                             device=dev))
            inp = out_c
        last_conv = _make_divisible(last_exp * scale)
        layers += [Conv2d(inp, last_conv, 1, bias=False, device=dev),
                   BatchNorm(last_conv, device=dev), Hardswish()]
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            hidden = _make_divisible(1280 * scale) if last_exp == 960 else 1024
            self.classifier = nn.Sequential(
                nn.Linear(last_conv, hidden, device=dev), Hardswish(),
                Dropout(0.2, self.dropout_generator),
                nn.Linear(hidden, num_classes, device=dev))
        finish(self, dev, dtype, seed)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_LARGE, 960, scale, num_classes, with_pool, **kw)


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_SMALL, 576, scale, num_classes, with_pool, **kw)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        refuse_pretrained("mobilenet_v3_large")
    return MobileNetV3Large(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        refuse_pretrained("mobilenet_v3_small")
    return MobileNetV3Small(scale=scale, **kwargs)
