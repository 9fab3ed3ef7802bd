"""Probabilistic Gaussian occupancy head
(gaussianformer_tpu/models/head/gaussian_head.py): the supervised refine
layers' Gaussians are splatted to the voxel grid (kernels K4 / K7) and
composed with combine_geosem; ``final_occ`` comes from the kernel's label
epilogue of the last splatted layer."""
from __future__ import annotations

from typing import Optional, Sequence

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


def loss_layers(apply_loss_type: str, num_decoder: int, training: bool,
                apply_loss_layers: Optional[Sequence[int]] = None):
    """The refine layers to splat (gaussian_head.py:120-147): the last at
    inference; in training ``all``, ``random_1`` (the last), ``fixed_i_j``
    or, for ``random_k`` with k > 1, the layers the caller drew."""
    if apply_loss_layers is not None:
        return list(apply_loss_layers)
    if not training:
        return [num_decoder - 1]
    if apply_loss_type == "all":
        return list(range(num_decoder))
    if apply_loss_type.startswith("random"):
        if int(apply_loss_type.split("_")[1]) > 1:
            raise ValueError(
                f"apply_loss_type={apply_loss_type!r} with k>1 needs the "
                "supervised layers drawn on the host: pass "
                "apply_loss_layers")
        return [num_decoder - 1]
    if apply_loss_type.startswith("fixed"):
        return [int(s) for s in apply_loss_type.split("_")[1:]]
    raise NotImplementedError(apply_loss_type)


class GaussianHead(nn.Module):
    def __init__(self, grid: SplatGridSpec = SplatGridSpec(),
                 apply_loss_type: str = "random_1"):
        super().__init__()
        self.grid = grid
        self.apply_loss_type = apply_loss_type

    def forward(self, representation, occ_xyz, occ_label=None,
                occ_cam_mask=None, training: bool = False,
                apply_loss_layers: Optional[Sequence[int]] = None):
        """occ_xyz [B, X, Y, Z, 3] voxel centres; occ_label and
        occ_cam_mask [B, X, Y, Z] come back flattened as the losses'
        ``sampled_label`` and ``occ_mask``."""
        b = occ_xyz.shape[0]
        points = occ_xyz.reshape(b, -1, 3)
        layers = loss_layers(self.apply_loss_type, len(representation),
                             training, apply_loss_layers)
        pred, bin_logits, density = [], [], []
        for idx in layers:
            means, opa, sem, scales, cov_inv6 = prepare_gaussian_args(
                representation[idx])
            logits, bins, dens, labels = splat_prob(
                points, means, opa, sem, scales, cov_inv6, self.grid)
            pred.append(combine_geosem(logits, bins))
            bin_logits.append(bins)
            density.append(dens)
        out = {
            "pred_occ": pred,
            "bin_logits": bin_logits,
            "density": density,
            "final_occ": labels,
            "gaussian": representation[-1],
        }
        if occ_label is not None:
            out["sampled_label"] = occ_label.reshape(b, -1)
        if occ_cam_mask is not None:
            out["occ_mask"] = occ_cam_mask.reshape(b, -1)
        return out
