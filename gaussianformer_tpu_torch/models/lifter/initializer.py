"""Pixel-aligned initializer tower: ResNet + SECONDFPN
(gaussianformer_tpu/models/lifter/initializer.py)."""
from __future__ import annotations

from torch import nn

from ..backbone.resnet import ResNet
from ..neck.second_fpn import SECONDFPN


class ResNetSecondFPN(nn.Module):
    def __init__(self, depth=101, stage_with_dcn=(False, False, True, True),
                 base_channels=64, out_channels=(128, 128, 128, 128),
                 upsample_strides=(0.5, 1, 2, 4), dtype=None):
        super().__init__()
        self.img_backbone = ResNet(depth=depth, base_channels=base_channels,
                                   stage_with_dcn=stage_with_dcn,
                                   dtype=dtype)
        self.img_neck = SECONDFPN(self.img_backbone.out_channels,
                                  out_channels, upsample_strides)

    def forward(self, imgs):
        """imgs [B*N, 3, H, W] -> [B*N, sum(out_channels), H/8, W/8] fp32."""
        return self.img_neck(self.img_backbone(imgs)).float()
