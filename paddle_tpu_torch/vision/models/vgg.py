"""VGG 11 / 13 / 16 / 19, with and without batch norm.

Counterpart of ``paddle_tpu/vision/models/vgg.py`` (``make_layers`` and
``VGG``), with its state names (``features.0.weight``,
``features.1._mean`` with batch norm, ``classifier.3.weight``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn.functional.conv import Conv2d
from ...nn.functional.norm import BatchNorm
from ._layers import (AdaptiveAvgPool2D, Dropout, MaxPool2D, ReLU, ZooModel,
                      finish, refuse_pretrained, start)

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False):
    """The feature stack of ``cfg``: 3 x 3 convolutions (batch norm after
    each with ``batch_norm``), ReLU, 2 x 2 max pools at ``"M"``; built on
    the CPU, ``VGG`` moves it."""
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
        else:
            layers.append(Conv2d(in_channels, v, 3, padding=1))
            if batch_norm:
                layers.append(BatchNorm(v))
            layers.append(ReLU())
            in_channels = v
    return nn.Sequential(*layers)


class VGG(ZooModel):
    """``VGG(features, num_classes=1000, with_pool=True)``; ``features``
    (``make_layers(...)``) is moved to the model's device, and every
    weight, the features' included, is drawn from ``seed`` here."""

    def __init__(self, features, num_classes=1000, with_pool=True,
                 device=None, dtype=torch.float32, seed: int = 0):
        super().__init__()
        dev = start(self, device, seed)
        gen = self.dropout_generator
        self.features = features.to(dev)
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096, device=dev), ReLU(),
                Dropout(0.5, gen), nn.Linear(4096, 4096, device=dev), ReLU(),
                Dropout(0.5, gen), nn.Linear(4096, num_classes, device=dev))
        finish(self, dev, dtype, seed)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _vgg(arch, cfg, batch_norm, pretrained, **kwargs):
    if pretrained:
        refuse_pretrained(arch)
    return VGG(make_layers(_cfgs[cfg], batch_norm), **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg11", "A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg13", "B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg16", "D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg19", "E", batch_norm, pretrained, **kwargs)
