"""Inception v3 (299 x 299 in).

Counterpart of ``paddle_tpu/vision/models/inceptionv3.py``: the five
Inception block families (A to E) with their factorised 1 x 7 / 7 x 1
and 1 x 3 / 3 x 1 convolutions, with the reference's state names
(``stem.0.conv.weight``, ``blocks.4.b7d.2.bn._variance``,
``fc.weight``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn.functional.conv import Conv2d
from ...nn.functional.norm import BatchNorm
from ._layers import (AdaptiveAvgPool2D, AvgPool2D, Dropout,
                      MaxPool2D, ReLU, ZooModel, finish, refuse_pretrained,
                      start)

__all__ = ["InceptionV3", "inception_v3"]


class _ConvBN(nn.Module):
    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=0,
                 device=None):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, stride=stride,
                           padding=padding, bias=False, device=device)
        self.bn = BatchNorm(out_ch, device=device)
        self.act = ReLU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class _InceptionA(nn.Module):
    def __init__(self, in_ch, pool_features, device=None):
        super().__init__()
        d = dict(device=device)
        self.b1 = _ConvBN(in_ch, 64, 1, **d)
        self.b5 = nn.Sequential(_ConvBN(in_ch, 48, 1, **d),
                                _ConvBN(48, 64, 5, padding=2, **d))
        self.b3 = nn.Sequential(_ConvBN(in_ch, 64, 1, **d),
                                _ConvBN(64, 96, 3, padding=1, **d),
                                _ConvBN(96, 96, 3, padding=1, **d))
        self.bp = nn.Sequential(AvgPool2D(3, 1, padding=1),
                                _ConvBN(in_ch, pool_features, 1, **d))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)], 1)


class _InceptionB(nn.Module):
    def __init__(self, in_ch, device=None):
        super().__init__()
        d = dict(device=device)
        self.b3 = _ConvBN(in_ch, 384, 3, stride=2, **d)
        self.b3d = nn.Sequential(_ConvBN(in_ch, 64, 1, **d),
                                 _ConvBN(64, 96, 3, padding=1, **d),
                                 _ConvBN(96, 96, 3, stride=2, **d))
        self.pool = MaxPool2D(3, 2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b3d(x), self.pool(x)], 1)


class _InceptionC(nn.Module):
    def __init__(self, in_ch, ch7, device=None):
        super().__init__()
        d = dict(device=device)
        self.b1 = _ConvBN(in_ch, 192, 1, **d)
        self.b7 = nn.Sequential(
            _ConvBN(in_ch, ch7, 1, **d),
            _ConvBN(ch7, ch7, (1, 7), padding=(0, 3), **d),
            _ConvBN(ch7, 192, (7, 1), padding=(3, 0), **d))
        self.b7d = nn.Sequential(
            _ConvBN(in_ch, ch7, 1, **d),
            _ConvBN(ch7, ch7, (7, 1), padding=(3, 0), **d),
            _ConvBN(ch7, ch7, (1, 7), padding=(0, 3), **d),
            _ConvBN(ch7, ch7, (7, 1), padding=(3, 0), **d),
            _ConvBN(ch7, 192, (1, 7), padding=(0, 3), **d))
        self.bp = nn.Sequential(AvgPool2D(3, 1, padding=1),
                                _ConvBN(in_ch, 192, 1, **d))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)], 1)


class _InceptionD(nn.Module):
    def __init__(self, in_ch, device=None):
        super().__init__()
        d = dict(device=device)
        self.b3 = nn.Sequential(_ConvBN(in_ch, 192, 1, **d),
                                _ConvBN(192, 320, 3, stride=2, **d))
        self.b7 = nn.Sequential(
            _ConvBN(in_ch, 192, 1, **d),
            _ConvBN(192, 192, (1, 7), padding=(0, 3), **d),
            _ConvBN(192, 192, (7, 1), padding=(3, 0), **d),
            _ConvBN(192, 192, 3, stride=2, **d))
        self.pool = MaxPool2D(3, 2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b7(x), self.pool(x)], 1)


class _InceptionE(nn.Module):
    def __init__(self, in_ch, device=None):
        super().__init__()
        d = dict(device=device)
        self.b1 = _ConvBN(in_ch, 320, 1, **d)
        self.b3_stem = _ConvBN(in_ch, 384, 1, **d)
        self.b3_a = _ConvBN(384, 384, (1, 3), padding=(0, 1), **d)
        self.b3_b = _ConvBN(384, 384, (3, 1), padding=(1, 0), **d)
        self.b3d_stem = nn.Sequential(_ConvBN(in_ch, 448, 1, **d),
                                      _ConvBN(448, 384, 3, padding=1, **d))
        self.b3d_a = _ConvBN(384, 384, (1, 3), padding=(0, 1), **d)
        self.b3d_b = _ConvBN(384, 384, (3, 1), padding=(1, 0), **d)
        self.bp = nn.Sequential(AvgPool2D(3, 1, padding=1),
                                _ConvBN(in_ch, 192, 1, **d))

    def forward(self, x):
        s = self.b3_stem(x)
        t = self.b3d_stem(x)
        return torch.cat([self.b1(x), self.b3_a(s), self.b3_b(s),
                          self.b3d_a(t), self.b3d_b(t), self.bp(x)], 1)


class InceptionV3(ZooModel):
    def __init__(self, num_classes=1000, with_pool=True, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        dev = start(self, device, seed)
        d = dict(device=dev)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _ConvBN(3, 32, 3, stride=2, **d), _ConvBN(32, 32, 3, **d),
            _ConvBN(32, 64, 3, padding=1, **d), MaxPool2D(3, 2),
            _ConvBN(64, 80, 1, **d), _ConvBN(80, 192, 3, **d),
            MaxPool2D(3, 2))
        self.blocks = nn.Sequential(
            _InceptionA(192, 32, **d), _InceptionA(256, 64, **d),
            _InceptionA(288, 64, **d), _InceptionB(288, **d),
            _InceptionC(768, 128, **d), _InceptionC(768, 160, **d),
            _InceptionC(768, 160, **d), _InceptionC(768, 192, **d),
            _InceptionD(768, **d),
            _InceptionE(1280, **d), _InceptionE(2048, **d))
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = Dropout(0.5, self.dropout_generator)
            self.flatten = nn.Flatten()
            self.fc = nn.Linear(2048, num_classes, **d)
        finish(self, dev, dtype, seed)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.flatten(self.dropout(x)))
        return x


def inception_v3(pretrained=False, **kwargs):
    if pretrained:
        refuse_pretrained("inception_v3")
    return InceptionV3(**kwargs)
