"""Feature Pyramid Network (gaussianformer_tpu/models/neck/fpn.py; mmdet
FPN names): start_level=1, extra convs on the last output with ReLU
before all but the first, nearest top-down upsampling."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..backbone.resnet import Conv2d


class ConvModule(nn.Module):
    """mmcv ConvModule without norm or activation: only ``.conv``."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.conv = Conv2d(*args, **kwargs)

    def forward(self, x):
        return self.conv(x)


def upsample_nearest(x, size):
    h, w = x.shape[2:]
    th, tw = size
    iy = (torch.arange(th, device=x.device) * h) // th
    ix = (torch.arange(tw, device=x.device) * w) // tw
    return x[:, :, iy][:, :, :, ix]


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 128,
                 num_outs: int = 4, start_level: int = 1):
        super().__init__()
        used = list(in_channels[start_level:])
        self.start_level = start_level
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1) for c in used)
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3, padding=1)
             for _ in used]
            + [ConvModule(out_channels, out_channels, 3, stride=2, padding=1)
               for _ in range(num_outs - len(used))])

    def forward(self, inputs):
        used = list(inputs[self.start_level:])
        n = len(used)
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(n - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample_nearest(
                laterals[i], laterals[i - 1].shape[2:])
        outs = [self.fpn_convs[i](laterals[i]) for i in range(n)]
        for i in range(n, self.num_outs):
            src = outs[-1] if i == n else torch.relu(outs[-1])
            outs.append(self.fpn_convs[i](src))
        return tuple(outs)
