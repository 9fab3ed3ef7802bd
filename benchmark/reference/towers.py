"""The image towers in plain PyTorch: Caffe-style ResNet with modulated
DCNv2 3x3 convs and frozen BN (mmseg names), the FPN (mmdet names), and
the lifter's ResNet + SECONDFPN (mmdet3d names). NCHW, float32; the
deformable conv is its gather form (bilinear corners, each sample weighted
by its mask, then one product with the weights). Module and parameter
names are those of the program, so one state dict loads into both.

``checkpoint`` recomputes each bottleneck in the backward instead of
keeping its activations, so that a full-width float32 train step fits."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint as _checkpoint

from .precision import REFERENCE, Precision

BLOCKS = {26: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class Conv2d(nn.Conv2d):
    def __init__(self, *args, prec: Precision = REFERENCE, **kwargs):
        super().__init__(*args, **kwargs)
        self.prec = prec

    def forward(self, x):
        with self.prec.matmul():
            return F.conv2d(self.prec.tower(x), self.prec.tower(self.weight),
                            self.bias, self.stride, self.padding,
                            self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, *args, prec: Precision = REFERENCE, **kwargs):
        super().__init__(*args, **kwargs)
        self.prec = prec

    def forward(self, x):
        with self.prec.matmul():
            return F.conv_transpose2d(self.prec.tower(x),
                                      self.prec.tower(self.weight), None,
                                      self.stride)


class FrozenBatchNorm2d(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


def deform_conv2d(x, offset, mask, weight, prec: Precision = REFERENCE):
    """Modulated DCNv2, 3x3, stride 1, padding 1. x [B, C_in, H, W];
    offset [B, 18, H, W] as (dy, dx) per tap, tap = ky * 3 + kx; mask
    [B, 9, H, W] in [0, 1]; weight [C_out, C_in, 3, 3]. A corner outside
    the image adds nothing."""
    b, cin, h, w = x.shape
    dev = x.device
    off = offset.reshape(b, 9, 2, h, w)
    ky = torch.arange(3, device=dev).repeat_interleave(3).float()
    kx = torch.arange(3, device=dev).repeat(3).float()
    base_y = torch.arange(h, device=dev).float()[None, :, None] - 1.0
    base_x = torch.arange(w, device=dev).float()[None, None, :] - 1.0
    sy = base_y + ky[:, None, None] + off[:, :, 0]          # [B, 9, H, W]
    sx = base_x + kx[:, None, None] + off[:, :, 1]
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    fy = sy - y0
    fx = sx - x0
    flat = x.reshape(b, cin, h * w)
    cols = torch.zeros(b, cin, 9, h * w, dtype=x.dtype, device=dev)
    for dy, dx, cw in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                       (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yy = y0 + dy
        xx = x0 + dx
        ok = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
        coef = (cw * ok * mask).reshape(b, 1, 9, h * w)
        got = torch.gather(flat, 2, idx.reshape(b, 1, 9 * h * w).expand(
            b, cin, 9 * h * w)).reshape(b, cin, 9, h * w)
        cols = cols + got * coef
    cols = prec.tower(cols.reshape(b, cin * 9, h * w))
    wmat = prec.tower(weight).reshape(weight.shape[0], cin * 9)
    with prec.matmul():
        out = cols.transpose(1, 2).reshape(b * h * w, cin * 9) @ wmat.T
    return out.reshape(b, h, w, -1).permute(0, 3, 1, 2)


class DeformConv2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 prec: Precision = REFERENCE):
        super().__init__()
        self.prec = prec
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               3, 3))
        self.conv_offset = Conv2d(in_channels, 27, 3, padding=1, prec=prec)

    def forward(self, x):
        om = self.conv_offset(x)
        return deform_conv2d(x, om[:, :18], torch.sigmoid(om[:, 18:]),
                             self.weight, self.prec)


class Bottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride, with_dcn, downsample,
                 prec: Precision):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, stride=stride, bias=False,
                            prec=prec)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = (DeformConv2d(planes, planes, prec) if with_dcn else
                      Conv2d(planes, planes, 3, padding=1, bias=False,
                             prec=prec))
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False, prec=prec)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(
            Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False,
                   prec=prec),
            FrozenBatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        idn = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + idn)


class ResNet(nn.Module):
    def __init__(self, depth=101, base_channels=64,
                 stage_with_dcn=(False, False, True, True),
                 prec: Precision = REFERENCE, checkpoint: bool = False):
        super().__init__()
        self.checkpoint = checkpoint
        self.conv1 = Conv2d(3, base_channels, 7, stride=2, padding=3,
                            bias=False, prec=prec)
        self.bn1 = FrozenBatchNorm2d(base_channels)
        inplanes = planes = base_channels
        self.out_channels = []
        for i, n in enumerate(BLOCKS[depth]):
            stride = 1 if i == 0 else 2
            blocks = []
            for j in range(n):
                s = stride if j == 0 else 1
                ds = j == 0 and (s != 1 or inplanes != planes * 4)
                blocks.append(Bottleneck(inplanes, planes, s,
                                         stage_with_dcn[i], ds, prec))
                inplanes = planes * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            self.out_channels.append(inplanes)
            planes *= 2

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for i in range(len(self.out_channels)):
            for block in getattr(self, f"layer{i + 1}"):
                if self.checkpoint and torch.is_grad_enabled():
                    x = _checkpoint(block, x, use_reentrant=False)
                else:
                    x = block(x)
            outs.append(x)
        return tuple(outs)


class ConvModule(nn.Module):
    def __init__(self, *args, prec: Precision = REFERENCE, **kwargs):
        super().__init__()
        self.conv = Conv2d(*args, prec=prec, **kwargs)

    def forward(self, x):
        return self.conv(x)


def upsample_nearest(x, size):
    h, w = x.shape[2:]
    iy = (torch.arange(size[0], device=x.device) * h) // size[0]
    ix = (torch.arange(size[1], device=x.device) * w) // size[1]
    return x[:, :, iy][:, :, :, ix]


class FPN(nn.Module):
    """start_level 1, four outputs: the three used levels and one extra
    stride-2 conv on the last of them."""

    def __init__(self, in_channels, out_channels=128, num_outs=4,
                 prec: Precision = REFERENCE):
        super().__init__()
        used = list(in_channels[1:])
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, prec=prec) for c in used)
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3, padding=1, prec=prec)
             for _ in used]
            + [ConvModule(out_channels, out_channels, 3, stride=2, padding=1,
                          prec=prec) for _ in range(num_outs - len(used))])

    def forward(self, inputs):
        used = list(inputs[1:])
        n = len(used)
        lat = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(n - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + upsample_nearest(lat[i],
                                                       lat[i - 1].shape[2:])
        outs = [self.fpn_convs[i](lat[i]) for i in range(n)]
        for i in range(n, self.num_outs):
            outs.append(self.fpn_convs[i](outs[-1] if i == n
                                          else torch.relu(outs[-1])))
        return tuple(outs)


class SECONDFPN(nn.Module):
    def __init__(self, in_channels, out_channels=(128, 128, 128, 128),
                 upsample_strides=(0.5, 1, 2, 4),
                 prec: Precision = REFERENCE):
        super().__init__()
        blocks = []
        for cin, cout, s in zip(in_channels, out_channels, upsample_strides):
            if s >= 1:
                up = ConvTranspose2d(cin, cout, int(s), stride=int(s),
                                     bias=False, prec=prec)
            else:
                k = int(round(1.0 / s))
                up = Conv2d(cin, cout, k, stride=k, bias=False, prec=prec)
            blocks.append(nn.Sequential(up, FrozenBatchNorm2d(cout, 1e-3),
                                        nn.ReLU()))
        self.deblocks = nn.ModuleList(blocks)

    def forward(self, inputs):
        outs = [blk(x) for blk, x in zip(self.deblocks, inputs)]
        mh = min(o.shape[2] for o in outs)
        mw = min(o.shape[3] for o in outs)
        return torch.cat([o[:, :, :mh, :mw] for o in outs], dim=1)


class ResNetSecondFPN(nn.Module):
    def __init__(self, depth, stage_with_dcn, base_channels, out_channels,
                 prec: Precision = REFERENCE, checkpoint: bool = False):
        super().__init__()
        self.img_backbone = ResNet(depth, base_channels, stage_with_dcn,
                                   prec, checkpoint)
        self.img_neck = SECONDFPN(self.img_backbone.out_channels,
                                  out_channels, prec=prec)

    def forward(self, imgs):
        return self.img_neck(self.img_backbone(imgs))
