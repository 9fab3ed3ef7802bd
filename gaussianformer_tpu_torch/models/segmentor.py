"""Top-level segmentor, inference path (gaussianformer_tpu/models/
segmentor.py): images -> ResNet+DCN -> FPN -> GaussianLifterV2 ->
GaussianOccEncoder -> GaussianHead."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.nuscenes import GaussianFormerConfig
from ..device import resolve_device
from .backbone.resnet import ResNet
from .encoder.gaussian_encoder import GaussianOccEncoder
from .head.gaussian_head import GaussianHead
from .lifter.gaussian_lifter_v2 import GaussianLifterV2
from .neck.fpn import FPN


class BEVSegmentor(nn.Module):
    def __init__(self, cfg: GaussianFormerConfig):
        super().__init__()
        dt = getattr(torch, cfg.compute_dtype)
        self.img_backbone = ResNet(depth=cfg.depth,
                                   base_channels=cfg.base_channels,
                                   stage_with_dcn=cfg.stage_with_dcn,
                                   dtype=dt)
        self.img_neck = FPN(self.img_backbone.out_channels, cfg.embed_dims)
        self.lifter = GaussianLifterV2(
            num_anchor=cfg.num_anchor, embed_dims=cfg.embed_dims,
            semantic_dim=cfg.semantic_dim,
            num_samples=cfg.num_depth_samples, pc_range=cfg.pc_range,
            random_samples=cfg.random_samples,
            initializer_depth=cfg.depth,
            initializer_dcn=cfg.stage_with_dcn,
            initializer_base_channels=cfg.base_channels,
            initializer_out_channels=cfg.initializer_out_channels,
            dtype=dt)
        kps = dict(num_learnable_pts=cfg.num_learnable_pts,
                   learnable_fixed_scale=cfg.learnable_fixed_scale,
                   fix_scale=cfg.fix_scale, pc_range=cfg.pc_range,
                   scale_range=cfg.scale_range)
        self.encoder = GaussianOccEncoder(
            cfg.operation_order, cfg.embed_dims, cfg.semantic_dim,
            ffn_cfg=dict(embed_dims=cfg.embed_dims,
                         feedforward_channels=cfg.embed_dims * 4),
            deformable_cfg=dict(embed_dims=cfg.embed_dims,
                                num_cams=cfg.num_cams, **kps),
            refine_cfg=dict(embed_dims=cfg.embed_dims,
                            pc_range=cfg.pc_range,
                            scale_range=cfg.scale_range,
                            unit_xyz=cfg.unit_xyz,
                            semantic_dim=cfg.semantic_dim),
            spconv_cfg=dict(in_channels=cfg.embed_dims,
                            embed_channels=cfg.embed_dims,
                            pc_range=cfg.pc_range,
                            grid_size=cfg.spconv_grid_size, dtype=dt))
        self.head = GaussianHead(cfg.grid)

    @torch.no_grad()
    def forward(self, imgs, projection_mat, image_wh, occ_xyz=None, *,
                generator: Optional[torch.Generator] = None,
                rep_only: bool = False, occ_only: bool = False,
                lifter_draws=None):
        """imgs [B, N, H, W, 3] normalised images; projection_mat
        [B, N, 4, 4] lidar -> image; image_wh [B, N, 2]; occ_xyz
        [B, X, Y, Z, 3] voxel centres (needed unless ``rep_only``).
        ``generator`` drives the lifter's depth sampling and padding."""
        b, n = imgs.shape[:2]
        flat = imgs.reshape((b * n,) + imgs.shape[2:]).permute(0, 3, 1, 2)
        feats = self.img_neck(self.img_backbone(flat))
        ms_feats = [f.permute(0, 2, 3, 1).reshape(
            b, n, f.shape[2], f.shape[3], f.shape[1]).contiguous()
            for f in feats]
        lifter_out = self.lifter(imgs, projection_mat, image_wh,
                                 generator=generator, draws=lifter_draws)
        enc_out = self.encoder(lifter_out["representation"],
                               lifter_out["rep_features"], ms_feats,
                               projection_mat, image_wh)
        if rep_only:
            return {"representation": enc_out["representation"]}
        head_out = self.head(enc_out["representation"], occ_xyz)
        if occ_only:
            return {"final_occ": head_out["final_occ"]}
        head_out["pixel_logits"] = lifter_out["pixel_logits"]
        return head_out


def init_random_(model: nn.Module, generator: torch.Generator):
    """Seeded random weights: fan-in scaled normals for conv / linear
    weights (small ones for the DCN offset convs, so offsets are fractional
    and the bilinear paths run), zero biases, unit LayerNorm / BN scales,
    random BN statistics, N(0, 1) anchors."""
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_mean":
            t.copy_(torch.randn(t.shape, generator=generator) * 0.1)
        elif leaf == "running_var":
            t.copy_(torch.rand(t.shape, generator=generator) + 0.5)
        elif t.ndim == 1:
            fill = 1.0 if (leaf in ("weight", "scale")) else 0.0
            t.fill_(fill)
        elif name.startswith("lifter.") and leaf in (
                "anchor", "random_anchors", "instance_feature"):
            t.copy_(torch.randn(t.shape, generator=generator))
        else:
            fan_in = t[0].numel()
            std = (0.01 if "conv_offset" in name else 1.0) / fan_in ** 0.5
            t.copy_(torch.randn(t.shape, generator=generator) * std)
    return model


def build_segmentor(cfg: GaussianFormerConfig, device="cuda",
                    seed: Optional[int] = 0) -> BEVSegmentor:
    """Build the segmentor on ``device`` (CUDA unless the caller asks for
    the CPU), with seeded random weights unless ``seed`` is None."""
    dev = resolve_device(device)
    model = BEVSegmentor(cfg)
    if seed is not None:
        with torch.no_grad():
            init_random_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
