"""SECOND-style FPN (gaussianformer_tpu/models/neck/second_fpn.py; mmdet3d
SECONDFPN names): a fractional upsample stride becomes a strided conv, an
integer one a transposed conv; each branch is conv -> BN -> ReLU (with
gradients off, BN and ReLU in one pass: ``kernels/bn_epilogue.py``); the
branches are concatenated on channels."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...kernels import bn_epilogue as epi
from ..backbone.resnet import Conv2d, FrozenBatchNorm2d


class ConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d computing in the input's dtype."""

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype), None,
                                  self.stride)


class SECONDFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int],
                 out_channels: Sequence[int] = (128, 128, 128, 128),
                 upsample_strides: Sequence[float] = (0.5, 1, 2, 4)):
        super().__init__()
        blocks = []
        for cin, cout, stride in zip(in_channels, out_channels,
                                     upsample_strides):
            if stride >= 1:
                s = int(stride)
                up = ConvTranspose2d(cin, cout, s, stride=s, bias=False)
            else:
                s = int(round(1.0 / stride))
                up = Conv2d(cin, cout, s, stride=s, bias=False)
            blocks.append(nn.Sequential(up, FrozenBatchNorm2d(cout, 1e-3),
                                        nn.ReLU()))
        self.deblocks = nn.ModuleList(blocks)

    def forward(self, inputs):
        outs = [epi.bn_epilogue(blk[0](x), blk[1].stats())
                if epi.applies(x) else blk(x)
                for blk, x in zip(self.deblocks, inputs)]
        mh = min(o.shape[2] for o in outs)
        mw = min(o.shape[3] for o in outs)
        return torch.cat([o[:, :, :mh, :mw] for o in outs], dim=1)
