"""DenseNet 121 / 161 / 169 / 201 / 264.

Counterpart of ``paddle_tpu/vision/models/densenet.py``: dense blocks of
BN-ReLU-1x1-BN-ReLU-3x3 layers whose outputs are concatenated, and
transitions that halve the channels and the resolution, with the
reference's state names (``stem.0.weight``, ``blocks.0.norm1._mean``,
``blocks.6.2.weight``, ``final_norm.weight``, ``classifier.weight``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn.functional.conv import Conv2d
from ...nn.functional.norm import BatchNorm
from ._layers import (AdaptiveAvgPool2D, AvgPool2D, Dropout, MaxPool2D, ReLU,
                      ZooModel, finish, refuse_pretrained, start)

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_cfgs = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
    264: (64, 32, [6, 12, 64, 48]),
}


class _DenseLayer(nn.Module):
    def __init__(self, num_input_features, growth_rate, bn_size, dropout,
                 generator, device=None):
        super().__init__()
        mid = bn_size * growth_rate
        self.norm1 = BatchNorm(num_input_features, device=device)
        self.relu = ReLU()
        self.conv1 = Conv2d(num_input_features, mid, 1, bias=False,
                            device=device)
        self.norm2 = BatchNorm(mid, device=device)
        self.conv2 = Conv2d(mid, growth_rate, 3, padding=1, bias=False,
                            device=device)
        self.dropout = Dropout(dropout, generator) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.norm1(x)))
        out = self.conv2(self.relu(self.norm2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return torch.cat([x, out], dim=1)


class _Transition(nn.Sequential):
    def __init__(self, num_input_features, num_output_features, device=None):
        super().__init__(
            BatchNorm(num_input_features, device=device), ReLU(),
            Conv2d(num_input_features, num_output_features, 1, bias=False,
                   device=device),
            AvgPool2D(2, 2))


class DenseNet(ZooModel):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True, device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        dev = start(self, device, seed)
        num_init_features, growth_rate, block_config = _cfgs[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            Conv2d(3, num_init_features, 7, stride=2, padding=3, bias=False,
                   device=dev),
            BatchNorm(num_init_features, device=dev), ReLU(),
            MaxPool2D(3, 2, padding=1))
        blocks = []
        num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            for j in range(num_layers):
                blocks.append(_DenseLayer(
                    num_features + j * growth_rate, growth_rate, bn_size,
                    dropout, self.dropout_generator, device=dev))
            num_features += num_layers * growth_rate
            if i != len(block_config) - 1:
                blocks.append(_Transition(num_features, num_features // 2,
                                          device=dev))
                num_features //= 2
        self.blocks = nn.Sequential(*blocks)
        self.final_norm = BatchNorm(num_features, device=dev)
        self.relu = ReLU()
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Linear(num_features, num_classes, device=dev)
        finish(self, dev, dtype, seed)

    def forward(self, x):
        x = self.relu(self.final_norm(self.blocks(self.stem(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _densenet(arch, layers, pretrained, **kwargs):
    if pretrained:
        refuse_pretrained(arch)
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _densenet("densenet121", 121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet("densenet161", 161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet("densenet169", 169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet("densenet201", 201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _densenet("densenet264", 264, pretrained, **kwargs)
