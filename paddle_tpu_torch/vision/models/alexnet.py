"""AlexNet.

Counterpart of ``paddle_tpu/vision/models/alexnet.py``, with its state
names: five convolutions with ReLU and three max pools, a 6 x 6
adaptive average pool, and a classifier of dropout and three
``nn.Linear`` layers (dropout drawn from the model's
``dropout_generator``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn.functional.conv import Conv2d
from ._layers import (AdaptiveAvgPool2D, Dropout, MaxPool2D, ReLU, ZooModel,
                      finish, refuse_pretrained, start)

__all__ = ["AlexNet", "alexnet"]


class AlexNet(ZooModel):
    def __init__(self, num_classes=1000, dropout=0.5, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        dev = start(self, device, seed)
        gen = self.dropout_generator
        self.num_classes = num_classes
        self.features = nn.Sequential(
            Conv2d(3, 64, 11, stride=4, padding=2, device=dev), ReLU(),
            MaxPool2D(3, 2),
            Conv2d(64, 192, 5, padding=2, device=dev), ReLU(),
            MaxPool2D(3, 2),
            Conv2d(192, 384, 3, padding=1, device=dev), ReLU(),
            Conv2d(384, 256, 3, padding=1, device=dev), ReLU(),
            Conv2d(256, 256, 3, padding=1, device=dev), ReLU(),
            MaxPool2D(3, 2))
        self.avgpool = AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                Dropout(dropout, gen), nn.Linear(256 * 6 * 6, 4096,
                                                 device=dev), ReLU(),
                Dropout(dropout, gen), nn.Linear(4096, 4096, device=dev),
                ReLU(), nn.Linear(4096, num_classes, device=dev))
        finish(self, dev, dtype, seed)

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def alexnet(pretrained=False, **kwargs):
    if pretrained:
        refuse_pretrained("alexnet")
    return AlexNet(**kwargs)
