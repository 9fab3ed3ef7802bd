"""Caffe-style ResNet with DCNv2 stages and frozen BN, NCHW
(gaussianformer_tpu/models/backbone/resnet.py; mmseg ResNet names).

With gradients off (inference) each DCN block's bn2 + ReLU is fused into
the DCN kernel's epilogue, and every other frozen BN, with the residual add
and the ReLU that follow it, runs as one pass over its conv's output
(``kernels/bn_epilogue.py``: on the CPU, or in bf16 on the card); with
gradients on (training, ``fuse_dcn_epilogue = not training`` in the
JAX package) the DCN runs as the differentiable K1/K5 pair and the BNs,
the residual and the ReLUs run as PyTorch's passes. The frozen BNs keep their
statistics but train their scale and bias, as the JAX ``FrozenBatchNorm``
params do. The stem is a plain 7x7/2 conv. Parameters stay fp32; convs run
in the input's dtype (bf16 on the card), so the casts match the JAX
package's ``dtype=bfloat16`` modules.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...kernels import bn_epilogue as epi
from ...kernels.dcn import DeformConv2dFunction, deform_conv2d
from ...utils.profiling import count, span

ARCH_SETTINGS = {
    26: (1, 1, 1, 1),     # tiny bottleneck (tests)
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
}


class Conv2d(nn.Conv2d):
    """Conv2d computing in the input's dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride,
                        self.padding, self.dilation, self.groups)


class FrozenBatchNorm2d(nn.Module):
    """BN with stored statistics (mmseg BN under norm_eval)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def stats(self):
        """(weight, bias, running_mean, running_var, eps): the BN as the
        epilogue takes it."""
        return (self.weight, self.bias, self.running_mean, self.running_var,
                self.eps)

    def coeffs(self):
        """(inv, shift) with bn(x) = x * inv + shift, in fp32."""
        return epi.coefficients(*self.stats())

    def forward(self, x):
        count("bn_eager", 1)
        inv, shift = self.coeffs()
        return (x * inv.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])


class DeformConv2d(nn.Module):
    """Modulated DCNv2 3x3 (mmcv ModulatedDeformConv2dPack names): the
    offset conv yields 18 offsets ((dy, dx) per tap) and 9 mask logits."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               3, 3))
        self.conv_offset = Conv2d(in_channels, 27, 3, padding=1)

    def forward(self, x, epilogue=None):
        """``epilogue=(inv, shift)`` fuses a following BN + ReLU; it is
        forward-only, so it is refused with gradients on."""
        with span("dcn"):
            om = self.conv_offset(x).float().permute(0, 2, 3, 1)
            offset = om[..., :18]
            mask = torch.sigmoid(om[..., 18:])
            x_nhwc = x.contiguous(memory_format=torch.channels_last).permute(
                0, 2, 3, 1)
            w_hwio = self.weight.permute(2, 3, 1, 0).to(x.dtype).contiguous()
            if torch.is_grad_enabled():
                if epilogue is not None:
                    raise ValueError("the fused DCN epilogue has no backward")
                out = DeformConv2dFunction.apply(x_nhwc, offset, mask,
                                                 w_hwio)
            else:
                out = deform_conv2d(x_nhwc, offset, mask, w_hwio, epilogue)
            return out.permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    """Caffe bottleneck: the stride sits on conv1, so the 3x3 (and the
    DCN) always runs at stride 1."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 with_dcn: bool = False, downsample: bool = False):
        super().__init__()
        self.with_dcn = with_dcn
        self.conv1 = Conv2d(inplanes, planes, 1, stride=stride, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = (DeformConv2d(planes, planes) if with_dcn else
                      Conv2d(planes, planes, 3, padding=1, bias=False))
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(
            Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            FrozenBatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x):
        if epi.applies(x):
            return self._fused(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        idn = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + idn)

    def _fused(self, x):
        """The forward with each BN in the epilogue: one pass a conv, the
        block's end (bn3, the downsample's BN, the residual, the ReLU) in
        one."""
        out = epi.bn_epilogue(self.conv1(x), self.bn1.stats())
        if self.with_dcn:
            out = self.conv2(out, epilogue=self.bn2.coeffs())
        else:
            out = epi.bn_epilogue(self.conv2(out), self.bn2.stats())
        out = self.conv3(out)
        if self.downsample is None:
            return epi.bn_epilogue(out, self.bn3.stats(), x)
        conv, bn = self.downsample
        return epi.bn_epilogue(out, self.bn3.stats(), conv(x), bn.stats())


class ResNet(nn.Module):
    def __init__(self, depth: int = 101, base_channels: int = 64,
                 stage_with_dcn: Sequence[bool] = (False, False, True, True),
                 out_indices: Tuple[int, ...] = (0, 1, 2, 3),
                 strides: Tuple[int, ...] = (1, 2, 2, 2),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.dtype = dtype
        self.conv1 = Conv2d(3, base_channels, 7, stride=2, padding=3,
                            bias=False)
        self.bn1 = FrozenBatchNorm2d(base_channels)
        inplanes = base_channels
        planes = base_channels
        self.out_channels = []
        for i, num_blocks in enumerate(ARCH_SETTINGS[depth]):
            blocks = []
            for j in range(num_blocks):
                stride = strides[i] if j == 0 else 1
                need_ds = j == 0 and (stride != 1 or inplanes != planes * 4)
                blocks.append(Bottleneck(inplanes, planes, stride,
                                         stage_with_dcn[i], need_ds))
                inplanes = planes * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            self.out_channels.append(inplanes)
            planes *= 2

    def forward(self, x):
        """x: [B, 3, H, W] -> tuple of stage outputs (NCHW)."""
        x = x.to(self.dtype)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        if epi.applies(x):
            x = epi.bn_epilogue(self.conv1(x), self.bn1.stats())
        else:
            x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for i in range(len(self.out_channels)):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
