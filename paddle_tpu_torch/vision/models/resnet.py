"""ResNet family (ResNet, ResNeXt and Wide-ResNet).

Counterpart of ``paddle_tpu/vision/models/resnet.py``: ``BasicBlock``,
``BottleneckBlock`` and ``ResNet`` with every constructor there, with
the reference's parameter and buffer names (``layer1.0.conv1.weight``,
``layer1.0.bn1._mean``, ``layer1.0.downsample.0.weight``, ``fc.weight``).
NCHW at the API, as the reference. Modules are ``torch.nn``; the
convolutions run ``nn.functional.conv2d`` (torch's convolution, with
cuDNN's deterministic algorithms on the card), batch norm the port's
``BatchNorm`` (paddle's momentum, the ``_mean`` / ``_variance``
buffers), the pools ``nn.functional``'s. The reference leaves all of
them to XLA, so no kernel of the port is on this path. ``fc`` is an
``nn.Linear`` (``[out, in]``; ``convert.load_paddle_tpu_state``
transposes the reference's ``[in, out]``).

``pretrained=True`` raises ``NotImplementedError``: the weights are a
download. ``dtype`` casts the model after its fp32 initialisation, the
running statistics too, as ``model.to(torch.bfloat16)`` (the reference's
``model.bfloat16()``) does.
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn import functional as F
from ...nn.functional.conv import Conv2d
from ...nn.functional.norm import BatchNorm
from ._layers import finish, refuse_pretrained, start

__all__ = [
    "ResNet", "BasicBlock", "BottleneckBlock",
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
    "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
    "wide_resnet50_2", "wide_resnet101_2",
]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, **factory):
        super().__init__()
        norm_layer = norm_layer or BatchNorm
        if dilation > 1:
            raise NotImplementedError(
                "Dilation > 1 not supported in BasicBlock")
        self.conv1 = Conv2d(inplanes, planes, 3, padding=1, stride=stride,
                            bias=False, **factory)
        self.bn1 = norm_layer(planes, **factory)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False,
                            **factory)
        self.bn2 = norm_layer(planes, **factory)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, **factory):
        super().__init__()
        norm_layer = norm_layer or BatchNorm
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2d(inplanes, width, 1, bias=False, **factory)
        self.bn1 = norm_layer(width, **factory)
        self.conv2 = Conv2d(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation, bias=False,
                            **factory)
        self.bn2 = norm_layer(width, **factory)
        self.conv3 = Conv2d(width, planes * self.expansion, 1, bias=False,
                            **factory)
        self.bn3 = norm_layer(planes * self.expansion, **factory)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + identity)


class ResNet(nn.Module):
    """``ResNet(block, depth=50, width=64, num_classes=1000,
    with_pool=True, groups=1)`` as the reference's. ``device=None`` builds
    on the card (and raises without one); parameters are fp32, drawn
    from ``seed`` with the reference's layer defaults
    (``nn.initializer.paddle_default_init_``), then cast to ``dtype``."""

    _cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
            101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        dev = start(self, device, seed)
        factory = dict(device=dev)
        layers = self._cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = Conv2d(3, self.inplanes, 7, stride=2, padding=3,
                            bias=False, **factory)
        self.bn1 = BatchNorm(self.inplanes, **factory)
        self.layer1 = self._make_layer(block, 64, layers[0], 1, factory)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, factory)
        self.layer3 = self._make_layer(block, 256, layers[2], 2, factory)
        self.layer4 = self._make_layer(block, 512, layers[3], 2, factory)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes, **factory)
        finish(self, dev, dtype, seed)

    def _make_layer(self, block, planes, blocks, stride, factory):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                Conv2d(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias=False, **factory),
                BatchNorm(planes * block.expansion, **factory))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, self.dilation,
                        **factory)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, **factory))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = F.adaptive_avg_pool2d(x, (1, 1))
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())


def _resnet(arch, block, depth, pretrained, **kwargs):
    if pretrained:
        refuse_pretrained(arch)
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet("resnet18", BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet("resnet34", BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet("resnet50", BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet("resnet101", BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet("resnet152", BottleneckBlock, 152, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet("resnext50_32x4d", BottleneckBlock, 50, pretrained,
                   groups=32, width=4, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnet("resnext50_64x4d", BottleneckBlock, 50, pretrained,
                   groups=64, width=4, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnet("resnext101_32x4d", BottleneckBlock, 101, pretrained,
                   groups=32, width=4, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnet("resnext101_64x4d", BottleneckBlock, 101, pretrained,
                   groups=64, width=4, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnet("resnext152_32x4d", BottleneckBlock, 152, pretrained,
                   groups=32, width=4, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnet("resnext152_64x4d", BottleneckBlock, 152, pretrained,
                   groups=64, width=4, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet("wide_resnet50_2", BottleneckBlock, 50, pretrained,
                   width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet("wide_resnet101_2", BottleneckBlock, 101, pretrained,
                   width=128, **kwargs)
