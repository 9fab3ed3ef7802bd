"""GaussianLifterV2: distribution-based pixel-aligned anchor initialisation
(gaussianformer_tpu/models/lifter/gaussian_lifter_v2.py).

Per pixel of the initializer tower's stride-8 map, a depth distribution
over ``num_samples`` bins (+1 "no occupancy" bin) picks one depth, by
inverse-CDF sampling or top-1; the unprojected points that are disabled or
outside pc_range are replaced by jittered copies of random valid ones;
farthest-point sampling (kernel K2) keeps ``num_anchor`` of them. The
learned anchor bank supplies scale/rotation/opacity/semantics, and
``random_samples`` fully learned anchors are appended. In training
(``compute_gt``) the ground-truth occupancy along each pixel's ray,
``pixel_gt``, supervises the depth distribution.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ...device import constant
from ...kernels.fps import farthest_point_sampling
from ...ops.compaction import valid_first_order
from ...ops.safe_ops import safe_inverse_sigmoid
from .initializer import ResNetSecondFPN

EPS = torch.finfo(torch.float32).eps


def sample_discrete_distribution(pdf, num_samples: int, generator=None,
                                 u=None):
    """Inverse-CDF sampling: pdf [..., bins] -> index [..., num_samples],
    on the uniforms ``u`` [..., num_samples] (drawn here when None)."""
    norm = pdf / (EPS + pdf.sum(-1, keepdim=True))
    cdf = torch.cumsum(norm, dim=-1)
    if u is None:
        u = torch.rand(pdf.shape[:-1] + (num_samples,), generator=generator,
                       device=pdf.device)
    elif u.shape != pdf.shape[:-1] + (num_samples,):
        raise ValueError(f"the depth draws have shape {tuple(u.shape)}, "
                         f"not {tuple(pdf.shape[:-1]) + (num_samples,)}")
    idx = (cdf[..., None, :] <= u[..., :, None]).sum(-1)
    return idx.clamp(0, pdf.shape[-1] - 1)


def pad_draws(b: int, num_cand: int, generator=None, device=None):
    """The random draws of the pad-invalid step: a candidate pick per slot
    and N(0, 0.1) jitter."""
    pick = torch.randint(0, num_cand, (b, num_cand), generator=generator,
                         device=device)
    noise = torch.randn(b, num_cand, 3, generator=generator,
                        device=device) * 0.1
    return pick, noise


class GaussianLifterV2(nn.Module):
    def __init__(self, num_anchor: int = 4000, embed_dims: int = 128,
                 semantic_dim: int = 17, num_samples: int = 128,
                 depth_min: float = 1.0, depth_max: float = 72.0,
                 pc_range: Tuple[float, ...] = (-50.0, -50.0, -5.0,
                                                50.0, 50.0, 3.0),
                 random_samples: int = 2400, anchors_per_pixel: int = 1,
                 voxel_size: float = 0.5,
                 occ_resolution: Tuple[int, int, int] = (200, 200, 16),
                 empty_label: int = 17,
                 deterministic_sampling: bool = False,
                 initializer_depth: int = 101,
                 initializer_dcn=(False, False, True, True),
                 initializer_base_channels: int = 64,
                 initializer_out_channels=(128, 128, 128, 128),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_anchor = num_anchor
        self.num_samples = num_samples
        self.depth_min = depth_min
        self.depth_max = depth_max
        self.pc_range = tuple(pc_range)
        self.random_samples = random_samples
        self.anchors_per_pixel = anchors_per_pixel
        self.voxel_size = voxel_size
        self.occ_resolution = tuple(occ_resolution)
        self.empty_label = empty_label
        self.deterministic_sampling = deterministic_sampling
        self.initialize_backbone = ResNetSecondFPN(
            depth=initializer_depth, stage_with_dcn=initializer_dcn,
            base_channels=initializer_base_channels,
            out_channels=initializer_out_channels, dtype=dtype)
        self.projection = nn.Sequential(
            nn.ReLU(), nn.Linear(sum(initializer_out_channels),
                                 num_samples + 1))
        rest = 3 + 4 + 1 + semantic_dim    # scale, rot, opacity, semantics
        self.anchor = nn.Parameter(torch.zeros(num_anchor, rest))
        self.random_anchors = nn.Parameter(
            torch.zeros(random_samples, 3 + rest))
        self.instance_feature = nn.Parameter(
            torch.zeros(num_anchor + random_samples, embed_dims))

    def pixel_gt(self, origin, ray_dir, depth_bins, occ_label, occ_cam_mask):
        """Ground-truth occupancy along each ray: [B, N, h, w, S + 1] bool,
        the S depth bins that hit an occupied, camera-visible voxel inside
        pc_range, then the no-hit bin (gaussian_lifter_v2.py:139-166)."""
        b = occ_label.shape[0]
        gt_flat = ((occ_label != self.empty_label)
                   & occ_cam_mask.bool()).to(torch.uint8).reshape(b, -1)
        res = self.occ_resolution
        ix, oob = [], None
        for ax in range(3):
            coord = origin[..., ax:ax + 1] + ray_dir[..., ax:ax + 1] \
                * depth_bins                               # [B,N,h,w,S]
            lo, hi = self.pc_range[ax], self.pc_range[ax + 3]
            axi = ((coord - lo) / self.voxel_size).to(torch.int32)
            bad = (coord < lo) | (coord >= hi)
            oob = bad if oob is None else oob | bad
            ix.append(axi.clamp(0, res[ax] - 1).long())
        lin = ((ix[0] * res[1] + ix[1]) * res[2] + ix[2]).reshape(b, -1)
        gt = torch.gather(gt_flat, 1, lin).reshape(oob.shape)
        gt = (gt > 0) & ~oob
        return torch.cat([gt, ~gt.any(-1, keepdim=True)], dim=-1)

    def draw(self, imgs, generator: Optional[torch.Generator] = None):
        """A forward's random draws on ``imgs`` [B, N, H, W, 3] (H and W
        multiples of 32: the depth map is H/8 x W/8), in the order the
        forward draws them from ``generator``: (pick, noise) of
        :func:`pad_draws` and the depth sampling's uniforms (None with
        ``deterministic_sampling``). Passed as the forward's ``draws`` they
        give the bits of drawing there; drawn ahead, they let a CUDA graph
        replay a frame."""
        b, n, hh, ww = imgs.shape[:4]
        dev = imgs.device
        u = None
        if not self.deterministic_sampling:
            u = torch.rand((b, n, hh // 8, ww // 8, self.anchors_per_pixel),
                           generator=generator, device=dev)
        num_cand = n * (hh // 8) * (ww // 8) * self.anchors_per_pixel
        return (*pad_draws(b, num_cand, generator, dev), u)

    def forward(self, imgs, projection_mat, image_wh, occ_label=None,
                occ_cam_mask=None, *,
                generator: Optional[torch.Generator] = None, draws=None,
                compute_gt: bool = False):
        """imgs [B, N, H, W, 3]; projection_mat [B, N, 4, 4] (lidar ->
        image); image_wh [B, N, 2]; occ_label [B, X, Y, Z] and
        occ_cam_mask [B, X, Y, Z] for ``pixel_gt`` (with ``compute_gt``).
        ``draws`` replaces the random draws of :func:`pad_draws` (tests
        feed both packages the same numbers): (pick, noise), or with a third
        element the depth sampling's uniforms too (:meth:`draw`)."""
        b, n = imgs.shape[:2]
        dev = imgs.device
        flat = imgs.reshape((b * n,) + imgs.shape[2:]).permute(0, 3, 1, 2)
        feat = self.initialize_backbone(flat)
        feat = feat.permute(0, 2, 3, 1).reshape(b, n, *feat.shape[2:4], -1)
        h, w = feat.shape[2:4]
        logits = self.projection(feat)                 # [B, N, h, w, S+1]

        # ray geometry: x(d) = origin + d * dir   (image -> lidar)
        # inv_ex: no host read of the factorisation's status
        inv_proj = torch.linalg.inv_ex(projection_mat).inverse
        u = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w
        v = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h
        uv = torch.stack([u[None, :].expand(h, w), v[:, None].expand(h, w)],
                         dim=-1)
        uv = uv[None, None] * image_wh[:, :, None, None]
        uv1 = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
        ray_dir = torch.einsum("bnij,bnhwj->bnhwi", inv_proj[..., :3, :3],
                               uv1)
        origin = inv_proj[..., :3, 3][:, :, None, None]
        depth_bins = torch.linspace(self.depth_min, self.depth_max,
                                    self.num_samples, device=dev)
        lo = constant(self.pc_range[:3], torch.float32, dev)
        hi = constant(self.pc_range[3:6], torch.float32, dev)
        gt = None
        if compute_gt and occ_label is not None:
            gt = self.pixel_gt(origin, ray_dir, depth_bins, occ_label,
                               occ_cam_mask)

        pdfs = torch.softmax(logits.detach(), dim=-1)
        if self.deterministic_sampling:
            index = torch.topk(pdfs, self.anchors_per_pixel, dim=-1).indices
        else:
            index = sample_discrete_distribution(
                pdfs, self.anchors_per_pixel, generator,
                draws[2] if draws is not None and len(draws) > 2 else None)
        disable = (pdfs.argmax(-1, keepdim=True) == self.num_samples)
        disable = disable.expand(index.shape)
        d_sel = depth_bins[index.clamp(0, self.num_samples - 1)]
        sampled = origin[..., None, :] + ray_dir[..., None, :] * \
            d_sel[..., None]
        cand = sampled.reshape(b, -1, 3)
        num_cand = cand.shape[1]
        oob = ((cand < lo) | (cand >= hi)).any(-1)
        valid = ~disable.reshape(b, -1) & ~oob

        # each invalid slot takes a random valid candidate + N(0, 0.1)
        pick, noise = (pad_draws(b, num_cand, generator, dev)
                       if draws is None else draws[:2])
        padded = []
        for i in range(b):
            order = valid_first_order(valid[i])
            count = valid[i].sum().clamp_min(1)
            repl = cand[i][order[pick[i] % count]]
            repl = torch.minimum(torch.maximum(repl + noise[i], lo), hi)
            padded.append(torch.where(valid[i][:, None], cand[i], repl))
        cand = torch.stack(padded)

        sel = torch.stack([
            farthest_point_sampling(cand[i].contiguous(), self.num_anchor)
            for i in range(b)]).long()
        anchor_xyz = torch.gather(cand, 1, sel[..., None].expand(-1, -1, 3))
        xyz = safe_inverse_sigmoid((anchor_xyz - lo) / (hi - lo))

        anchor = torch.cat([xyz, self.anchor[None].expand(b, -1, -1)], -1)
        if self.random_samples > 0:
            anchor = torch.cat(
                [anchor, self.random_anchors[None].expand(b, -1, -1)], 1)
        return {
            "representation": anchor,
            "rep_features": self.instance_feature[None].expand(b, -1, -1),
            "pixel_logits": logits,
            "pixel_gt": gt,
        }
