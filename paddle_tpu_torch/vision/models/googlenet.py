"""GoogLeNet (Inception v1).

Counterpart of ``paddle_tpu/vision/models/googlenet.py``: Inception
blocks and two auxiliary heads, with the reference's state names
(``stem.0.weight``, ``inc3a.b2.2.weight``, ``aux1.fc1.weight``,
``fc.weight``). In training mode (with classes) the forward returns
``(out, aux1, aux2)``, in eval mode ``out``.
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn.functional.conv import Conv2d
from ._layers import (AdaptiveAvgPool2D, Dropout, MaxPool2D, ReLU,
                      ZooModel, finish, refuse_pretrained, start)

__all__ = ["GoogLeNet", "googlenet"]


class _Inception(nn.Module):
    def __init__(self, in_ch, c1, c2_red, c2, c3_red, c3, c4, device=None):
        super().__init__()
        d = dict(device=device)
        self.b1 = nn.Sequential(Conv2d(in_ch, c1, 1, **d), ReLU())
        self.b2 = nn.Sequential(Conv2d(in_ch, c2_red, 1, **d), ReLU(),
                                Conv2d(c2_red, c2, 3, padding=1, **d), ReLU())
        self.b3 = nn.Sequential(Conv2d(in_ch, c3_red, 1, **d), ReLU(),
                                Conv2d(c3_red, c3, 5, padding=2, **d), ReLU())
        self.b4 = nn.Sequential(MaxPool2D(3, 1, padding=1),
                                Conv2d(in_ch, c4, 1, **d), ReLU())

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                         dim=1)


class _AuxHead(nn.Module):
    def __init__(self, in_ch, num_classes, generator, device=None):
        super().__init__()
        self.pool = AdaptiveAvgPool2D(4)
        self.conv = Conv2d(in_ch, 128, 1, device=device)
        self.fc1 = nn.Linear(128 * 16, 1024, device=device)
        self.fc2 = nn.Linear(1024, num_classes, device=device)
        self.relu = ReLU()
        self.dropout = Dropout(0.7, generator)
        self.flatten = nn.Flatten()

    def forward(self, x):
        x = self.relu(self.conv(self.pool(x)))
        x = self.relu(self.fc1(self.flatten(x)))
        return self.fc2(self.dropout(x))


class GoogLeNet(ZooModel):
    def __init__(self, num_classes=1000, with_pool=True, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        dev = start(self, device, seed)
        gen = self.dropout_generator
        d = dict(device=dev)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            Conv2d(3, 64, 7, stride=2, padding=3, **d), ReLU(),
            MaxPool2D(3, 2, padding=1),
            Conv2d(64, 64, 1, **d), ReLU(),
            Conv2d(64, 192, 3, padding=1, **d), ReLU(),
            MaxPool2D(3, 2, padding=1))
        self.inc3a = _Inception(192, 64, 96, 128, 16, 32, 32, **d)
        self.inc3b = _Inception(256, 128, 128, 192, 32, 96, 64, **d)
        self.pool3 = MaxPool2D(3, 2, padding=1)
        self.inc4a = _Inception(480, 192, 96, 208, 16, 48, 64, **d)
        self.inc4b = _Inception(512, 160, 112, 224, 24, 64, 64, **d)
        self.inc4c = _Inception(512, 128, 128, 256, 24, 64, 64, **d)
        self.inc4d = _Inception(512, 112, 144, 288, 32, 64, 64, **d)
        self.inc4e = _Inception(528, 256, 160, 320, 32, 128, 128, **d)
        self.pool4 = MaxPool2D(3, 2, padding=1)
        self.inc5a = _Inception(832, 256, 160, 320, 32, 128, 128, **d)
        self.inc5b = _Inception(832, 384, 192, 384, 48, 128, 128, **d)
        if num_classes > 0:
            self.aux1 = _AuxHead(512, num_classes, gen, **d)
            self.aux2 = _AuxHead(528, num_classes, gen, **d)
            self.avgpool = AdaptiveAvgPool2D(1)
            self.dropout = Dropout(0.4, gen)
            self.fc = nn.Linear(1024, num_classes, **d)
            self.flatten = nn.Flatten()
        finish(self, dev, dtype, seed)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.inc3b(self.inc3a(x)))
        x = self.inc4a(x)
        heads = self.num_classes > 0 and self.training
        aux1 = self.aux1(x) if heads else None
        x = self.inc4d(self.inc4c(self.inc4b(x)))
        aux2 = self.aux2(x) if heads else None
        x = self.pool4(self.inc4e(x))
        x = self.inc5b(self.inc5a(x))
        if self.num_classes > 0:
            out = self.fc(self.flatten(self.dropout(self.avgpool(x))))
            if self.training:
                return out, aux1, aux2
            return out
        return x


def googlenet(pretrained=False, **kwargs):
    if pretrained:
        refuse_pretrained("googlenet")
    return GoogLeNet(**kwargs)
