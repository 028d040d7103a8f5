"""ResNet-50/50d feature backbones (NCHW, dilated output stride 8).

Counterpart of ``dmf_tpu/models/backbones/resnet.py``; the port's
``registry.py::build_backbone`` builds it.  Returns ``[C2, C3, C4, C5]`` at
strides (4, 8, 8, 8) with (256, 512, 1024, 2048) channels: layers 3 and 4
trade stride for dilation, and the first block of a newly dilated stage keeps
the previous stage's dilation (``first_dilation``, resnet.py:69-80).

Parameter names are timm's (``conv1``, ``bn1``,
``layer{1..4}.{i}.conv{1,2,3}``/``bn{1,2,3}``/``downsample.{0,1}``; the
resnet50d layout puts its deep stem under ``conv1.{0,1,3,4,6}`` and its
shortcut under ``downsample.{1,2}`` behind an average pool), so timm and
RadImageNet checkpoints map onto it by name (``importers.py``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm2d, run

OUTPUT_DIMS = (256, 512, 1024, 2048)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride/dilation) -> 1x1 x4 bottleneck, projection shortcut."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, first_dilation: int = 0,
                 avg_down: bool = False, **kw):
        super().__init__()
        out_ch = planes * 4
        d = first_dilation or dilation
        self.conv1 = nn.Conv2d(in_ch, planes, 1, bias=False, **kw)
        self.bn1 = BatchNorm2d(planes, **kw)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=d,
                               dilation=d, bias=False, **kw)
        self.bn2 = BatchNorm2d(planes, **kw)
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False, **kw)
        self.bn3 = BatchNorm2d(out_ch, **kw)
        if in_ch != out_ch or stride != 1:
            if avg_down:  # timm keeps the pool slot (Identity at stride 1)
                self.downsample = nn.Sequential(
                    nn.AvgPool2d(stride, stride) if stride != 1 else nn.Identity(),
                    nn.Conv2d(in_ch, out_ch, 1, bias=False, **kw),
                    BatchNorm2d(out_ch, **kw))
            else:
                self.downsample = nn.Sequential(
                    nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False, **kw),
                    BatchNorm2d(out_ch, **kw))
        else:
            self.downsample = None

    def forward(self, x, train: bool = False):
        identity = x if self.downsample is None else run(self.downsample, x, train)
        out = F.relu(self.bn1(self.conv1(x), train))
        out = F.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        return F.relu(out + identity)


class ResNetFeatures(nn.Module):
    """Feature-pyramid ResNet: ``forward(x, train) -> [C2, C3, C4, C5]``;
    ``train=True`` runs its BatchNorm on batch statistics (the JAX encoder
    applies the whole tree in train mode, the frozen backbone included)."""

    def __init__(self, in_channels: int = 3,
                 layers: Sequence[int] = (3, 4, 6, 3),
                 deep_stem: bool = False, avg_down: bool = False,
                 output_stride: int = 8, **kw):
        super().__init__()
        if deep_stem:
            self.conv1 = nn.Sequential(
                nn.Conv2d(in_channels, 32, 3, 2, 1, bias=False, **kw),
                BatchNorm2d(32, **kw), nn.ReLU(),
                nn.Conv2d(32, 32, 3, 1, 1, bias=False, **kw),
                BatchNorm2d(32, **kw), nn.ReLU(),
                nn.Conv2d(32, 64, 3, 1, 1, bias=False, **kw))
        else:
            self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False, **kw)
        self.bn1 = BatchNorm2d(64, **kw)
        planes = (64, 128, 256, 512)
        strides = [1, 2, 2, 2]
        dilations = [1, 1, 1, 1]
        current = 4
        for i in range(1, 4):
            if current * strides[i] > output_stride and i >= 2:
                dilations[i] = dilations[i - 1] * strides[i]
                strides[i] = 1
            else:
                current *= strides[i]
        in_ch = 64
        for stage in range(4):
            prev_dilation = dilations[stage - 1] if stage > 0 else 1
            blocks = []
            for b in range(layers[stage]):
                blocks.append(Bottleneck(
                    in_ch, planes[stage],
                    stride=strides[stage] if b == 0 else 1,
                    dilation=dilations[stage],
                    first_dilation=prev_dilation if b == 0 else dilations[stage],
                    avg_down=avg_down, **kw))
                in_ch = planes[stage] * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.output_dims = OUTPUT_DIMS
        self.reductions = (4, 8, 8, 8) if output_stride == 8 else (4, 8, 16, 32)

    def forward(self, x, train: bool = False) -> List[torch.Tensor]:
        stem = self.conv1 if isinstance(self.conv1, nn.Sequential) else (self.conv1,)
        x = F.relu(self.bn1(run(stem, x, train), train))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                x = block(x, train)
            feats.append(x)
        return feats

