"""ResNet: the port of paddle_tpu/vision/models/resnet.py (``BasicBlock``,
``BottleneckBlock``, ``ResNet`` and every constructor, resnet18 to 152,
the wide ResNets and the ResNeXts).

Parameter and buffer names are the reference's ``state_dict()`` keys
(``conv1.weight``, ``layer1.0.downsample.1._mean``, ``fc.weight``), and
the layers are made in the reference's order (a block's ``downsample``
before the block). Each block registers its ``downsample`` first, so
``named_parameters()`` order is the reference's creation order, which
is the order of its ``param_<counter>`` names: `convert` carries a
reference checkpoint or optimizer file across. ``fc`` is a
``torch.nn.Linear`` (weight ``[out, in]``; `convert` transposes it).

``ResNet(..., device=None, dtype=torch.float32, seed=0)`` follows the
port's entry-point convention: on the CUDA card unless ``device="cpu"``,
its weights drawn there from a ``torch.Generator`` seeded with ``seed``,
with the reference's initialisers (`nn.layer`). Convolution, batch norm
and pooling run as cuDNN and aten ops under the port's numerics
contract (TF32 off): the reference runs them as XLA ops, with no Pallas
kernel.
"""
from __future__ import annotations

import torch
from torch import nn

from ...framework.device import resolve_device
from ...nn.layer import AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear, \
    MaxPool2D

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
           "resnext50_64x4d", "resnext101_32x4d", "resnext101_64x4d",
           "resnext152_32x4d", "resnext152_64x4d"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 **factory):
        super().__init__()
        self.downsample = downsample
        norm_layer = norm_layer or BatchNorm2D
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, **factory)
        self.bn1 = norm_layer(planes, **factory)
        self.relu = nn.ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            **factory)
        self.bn2 = norm_layer(planes, **factory)
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 **factory):
        super().__init__()
        self.downsample = downsample
        norm_layer = norm_layer or BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False, **factory)
        self.bn1 = norm_layer(width, **factory)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=dilation,
                            groups=groups, dilation=dilation,
                            bias_attr=False, **factory)
        self.bn2 = norm_layer(width, **factory)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, **factory)
        self.bn3 = norm_layer(planes * self.expansion, **factory)
        self.relu = nn.ReLU()

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, *, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        dev = resolve_device(device)
        self._factory = dict(device=dev, dtype=dtype,
                             generator=torch.Generator(device=dev)
                             .manual_seed(seed))
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = BatchNorm2D
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, **self._factory)
        self.bn1 = self._norm_layer(self.inplanes, **self._factory)
        self.relu = nn.ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes,
                             **self._factory)
        del self._factory

    def _make_layer(self, block, planes, blocks, stride=1):
        norm_layer, factory = self._norm_layer, self._factory
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, **factory),
                norm_layer(planes * block.expansion, **factory),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, 1, norm_layer,
                        **factory)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes,
                                groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer, **factory))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


def _resnet(block, depth, width=64, **kwargs):
    return ResNet(block, depth, width=width, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, width=128, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, width=4, groups=32, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, width=4, groups=64, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, width=4, groups=32, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, width=4, groups=64, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, width=4, groups=32, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, width=4, groups=64, **kwargs)
