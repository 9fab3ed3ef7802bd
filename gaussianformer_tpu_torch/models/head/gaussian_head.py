"""Probabilistic Gaussian occupancy head, inference path
(gaussianformer_tpu/models/head/gaussian_head.py): the last refine layer's
Gaussians are splatted to the voxel grid (kernel K4) and composed with
combine_geosem; ``final_occ`` comes from the kernel's label epilogue."""
from __future__ import annotations

import torch
from torch import nn

from ...kernels.splat import combine_geosem
from ...ops.covariance import build_covariance_inverse6
from ...ops.splat import SplatGridSpec, splat_prob


def prepare_gaussian_args(gaussians):
    """(means, opacities [B, P], semantics softmax + empty channel,
    scales, cov_inv6)."""
    sem = torch.softmax(gaussians.semantics, dim=-1)
    sem = torch.cat([sem, torch.zeros_like(sem[..., :1])], dim=-1)
    cov_inv6 = build_covariance_inverse6(gaussians.scales,
                                         gaussians.rotations)
    return (gaussians.means, gaussians.opacities[..., 0], sem,
            gaussians.scales, cov_inv6)


class GaussianHead(nn.Module):
    def __init__(self, grid: SplatGridSpec = SplatGridSpec()):
        super().__init__()
        self.grid = grid

    def forward(self, representation, occ_xyz):
        """occ_xyz [B, X, Y, Z, 3] voxel centres."""
        b = occ_xyz.shape[0]
        points = occ_xyz.reshape(b, -1, 3)
        means, opa, sem, scales, cov_inv6 = prepare_gaussian_args(
            representation[-1])
        logits, bins, density, labels = splat_prob(
            points, means, opa, sem, scales, cov_inv6, self.grid)
        return {
            "pred_occ": [combine_geosem(logits, bins)],
            "bin_logits": [bins],
            "density": [density],
            "final_occ": labels,
            "gaussian": representation[-1],
        }
