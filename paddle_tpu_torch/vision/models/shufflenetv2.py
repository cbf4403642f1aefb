"""ShuffleNetV2, widths x0.25 to x2.0 and the swish variant.

Counterpart of ``paddle_tpu/vision/models/shufflenetv2.py``: channel
split and shuffle units with depthwise 3 x 3 convolutions, with the
reference's state names (``conv1.0.weight``,
``stages.0.branch1.0.1._mean``, ``conv_last.1.weight``, ``fc.weight``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn.functional.conv import Conv2d
from ...nn.functional.norm import BatchNorm
from ._layers import (AdaptiveAvgPool2D, MaxPool2D, ReLU, Swish, ZooModel,
                      finish, refuse_pretrained, start)

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]


def channel_shuffle(x, groups):
    """NCHW channels regrouped: ``groups`` blocks interleaved."""
    b, c, h, w = x.shape
    return x.reshape(b, groups, c // groups, h, w).transpose(1, 2).reshape(
        b, c, h, w)


def _conv_bn_act(inp, oup, k, s, p, groups=1, act="relu", device=None):
    layers = [Conv2d(inp, oup, k, stride=s, padding=p, groups=groups,
                     bias=False, device=device), BatchNorm(oup, device=device)]
    if act == "relu":
        layers.append(ReLU())
    elif act == "swish":
        layers.append(Swish())
    return nn.Sequential(*layers)


class InvertedResidual(nn.Module):
    def __init__(self, inp, oup, stride, act="relu", device=None):
        super().__init__()
        self.stride = stride
        bf = oup // 2
        dev = dict(device=device)
        if stride == 1:
            self.branch2 = nn.Sequential(
                _conv_bn_act(inp // 2, bf, 1, 1, 0, act=act, **dev),
                _conv_bn_act(bf, bf, 3, 1, 1, groups=bf, act="none", **dev),
                _conv_bn_act(bf, bf, 1, 1, 0, act=act, **dev))
            self.branch1 = None
        else:
            self.branch1 = nn.Sequential(
                _conv_bn_act(inp, inp, 3, stride, 1, groups=inp, act="none",
                             **dev),
                _conv_bn_act(inp, bf, 1, 1, 0, act=act, **dev))
            self.branch2 = nn.Sequential(
                _conv_bn_act(inp, bf, 1, 1, 0, act=act, **dev),
                _conv_bn_act(bf, bf, 3, stride, 1, groups=bf, act="none",
                             **dev),
                _conv_bn_act(bf, bf, 1, 1, 0, act=act, **dev))

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = torch.chunk(x, 2, dim=1)
            out = torch.cat([x1, self.branch2(x2)], dim=1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(ZooModel):
    _stage_repeats = [4, 8, 4]
    _out_channels = {
        0.25: [24, 24, 48, 96, 512], 0.33: [24, 32, 64, 128, 512],
        0.5: [24, 48, 96, 192, 1024], 1.0: [24, 116, 232, 464, 1024],
        1.5: [24, 176, 352, 704, 1024], 2.0: [24, 244, 488, 976, 2048],
    }

    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        dev = start(self, device, seed)
        self.num_classes = num_classes
        self.with_pool = with_pool
        channels = self._out_channels[scale]
        self.conv1 = _conv_bn_act(3, channels[0], 3, 2, 1, act=act,
                                  device=dev)
        self.max_pool = MaxPool2D(3, 2, padding=1)
        stages = []
        inp = channels[0]
        for repeats, oup in zip(self._stage_repeats, channels[1:4]):
            stages.append(InvertedResidual(inp, oup, 2, act, device=dev))
            for _ in range(repeats - 1):
                stages.append(InvertedResidual(oup, oup, 1, act, device=dev))
            inp = oup
        self.stages = nn.Sequential(*stages)
        self.conv_last = _conv_bn_act(inp, channels[4], 1, 1, 0, act=act,
                                      device=dev)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(channels[4], num_classes, device=dev)
        finish(self, dev, dtype, seed)

    def forward(self, x):
        x = self.max_pool(self.conv1(x))
        x = self.conv_last(self.stages(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def _shufflenet(arch, scale, act, pretrained, **kwargs):
    if pretrained:
        refuse_pretrained(arch)
    return ShuffleNetV2(scale=scale, act=act, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _shufflenet("shufflenet_v2_x0_25", 0.25, "relu", pretrained,
                       **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _shufflenet("shufflenet_v2_x0_33", 0.33, "relu", pretrained,
                       **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _shufflenet("shufflenet_v2_x0_5", 0.5, "relu", pretrained,
                       **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _shufflenet("shufflenet_v2_x1_0", 1.0, "relu", pretrained,
                       **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _shufflenet("shufflenet_v2_x1_5", 1.5, "relu", pretrained,
                       **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _shufflenet("shufflenet_v2_x2_0", 2.0, "relu", pretrained,
                       **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return _shufflenet("shufflenet_v2_swish", 1.0, "swish", pretrained,
                       **kwargs)
