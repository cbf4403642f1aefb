"""LeNet (MNIST-scale: 1 x 28 x 28 in).

Counterpart of ``paddle_tpu/vision/models/lenet.py``, with its state
names (``features.0.weight``, ``fc.2.bias``): two convolutions with ReLU
and max pooling, then three ``nn.Linear`` layers with no activation
between them, as the reference.
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn.functional.conv import Conv2d
from ._layers import MaxPool2D, ReLU, ZooModel, finish, start

__all__ = ["LeNet"]


class LeNet(ZooModel):
    """``LeNet(num_classes=10)``; ``device`` (the card unless ``"cpu"``),
    ``dtype`` and ``seed`` as the port's other vision models."""

    def __init__(self, num_classes=10, device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        dev = start(self, device, seed)
        self.num_classes = num_classes
        self.features = nn.Sequential(
            Conv2d(1, 6, 3, stride=1, padding=1, device=dev), ReLU(),
            MaxPool2D(2, 2),
            Conv2d(6, 16, 5, stride=1, padding=0, device=dev), ReLU(),
            MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120, device=dev),
                nn.Linear(120, 84, device=dev),
                nn.Linear(84, num_classes, device=dev))
        finish(self, dev, dtype, seed)

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x
