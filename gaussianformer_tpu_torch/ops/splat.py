"""Gaussian -> voxel probabilistic splat (the prob variant of
gaussianformer_tpu/ops/splat.py, forward only).

Per point x and Gaussian g whose integer AABB holds x's voxel
(getRect semantics of the reference's localagg_prob):
    e_g(x)  = exp(-1/2 (mu_g - x)^T A_g (mu_g - x))
    w_g     = (2 pi)^-3/2 sqrt(det A_g) opa_g
    logits  = sum_g sem_g w_g e_g / sum_g w_g e_g   (uniform fallback)
    bin     = 1 - prod_g (1 - e_g);  density = sum_g e_g
The per-point loop is kernel K4 (kernels/splat.py); this module packs the
Gaussian tables and post-processes the accumulators.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..kernels.splat import postprocess_prob, splat_accumulate

NORM_3D = math.pow(2.0 * math.pi, -1.5)


@dataclasses.dataclass(frozen=True)
class SplatGridSpec:
    """Static voxel-grid geometry (reference ``cuda_kwargs``)."""
    H: int = 200
    W: int = 200
    D: int = 16
    pc_min: Tuple[float, float, float] = (-50.0, -50.0, -5.0)
    grid_size: float = 0.5
    scale_multiplier: float = 4.0
    radii_min: int = 1

    @property
    def num_voxels(self) -> int:
        return self.H * self.W * self.D

    def voxelize(self, xyz):
        """World coords -> int64 voxel coords (floor, clipped in-grid)."""
        pc_min = torch.tensor(self.pc_min, dtype=xyz.dtype,
                              device=xyz.device)
        hi = torch.tensor([self.H - 1, self.W - 1, self.D - 1],
                          device=xyz.device)
        idx = torch.floor((xyz - pc_min) / self.grid_size).long()
        return torch.minimum(idx.clamp_min(0), hi)

    def radii(self, scales):
        """Isotropic voxel-space AABB radii (localagg_prob) from the
        Gaussians' largest scale."""
        r = torch.ceil(scales.detach().amax(-1, keepdim=True)
                       * self.scale_multiplier / self.grid_size)
        return r.expand(scales.shape).long().clamp_min(self.radii_min)


def det_compact(cov6):
    """Determinant of a symmetric 3x3 given as [xx, yy, zz, xy, yz, xz]."""
    xx, yy, zz, xy, yz, xz = cov6.unbind(-1)
    return (xx * yy * zz + 2.0 * xy * yz * xz
            - xx * yz * yz - yy * xz * xz - zz * xy * xy)


def pack_gaussians(means, opacities, semantics, scales, cov_inv6,
                   grid: SplatGridSpec):
    """One batch element's Gaussian tables for kernel K4 (the packing math
    of the JAX package's ``_pack_gaussians``): gdata [P, 9], box [P, 6]
    int32 (AABB lo, hi in voxels), sem_aug [P, C + 2] = [sem w, w, 1]."""
    mu_int = grid.voxelize(means.detach())
    rad = grid.radii(scales)
    box = torch.cat([mu_int - rad, mu_int + rad], dim=-1).to(torch.int32)
    gdata = torch.cat([means, cov_inv6], dim=-1).float().contiguous()
    w = NORM_3D * torch.sqrt(det_compact(cov_inv6).clamp_min(1e-30)) \
        * opacities
    sem_aug = torch.cat([semantics * w[:, None], w[:, None],
                         torch.ones_like(w[:, None])], dim=-1)
    return gdata, box.contiguous(), sem_aug.float().contiguous()


def splat_prob(points, means, opacities, semantics, scales, cov_inv6,
               grid: SplatGridSpec):
    """Batched prob splat with final-occ labels.

    points [B, N, 3]; means [B, P, 3]; opacities [B, P]; semantics
    [B, P, C]; scales [B, P, 3]; cov_inv6 [B, P, 6]. Returns (logits
    [B, N, C], bin_logits [B, N], density [B, N], labels [B, N] int32)."""
    outs = []
    for bi in range(points.shape[0]):
        gdata, box, sem_aug = pack_gaussians(
            means[bi], opacities[bi], semantics[bi], scales[bi],
            cov_inv6[bi], grid)
        acc, one_minus, labels = splat_accumulate(
            points[bi].float().contiguous(), gdata, box, sem_aug, grid)
        outs.append(postprocess_prob(acc, one_minus) + (labels,))
    return tuple(torch.stack([o[k] for o in outs]) for k in range(4))
