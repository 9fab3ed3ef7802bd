"""GaussianLifter (v1, gaussianformer_tpu/models/lifter/gaussian_lifter.py):
a learnable bank of anchor Gaussians and their instance features, the same
for every sample. Whether they train is the optimizer's partition
(``train/optim.py``). With ``pts_init`` each sample's anchor xyz come from
its lidar anchor points (``data/transforms.py::load_points`` /
``load_pseudo_points``, normalised to [0, 1]^3) through the inverse
sigmoid, and the rest of each anchor from the bank (reference
gaussian_lifter.py:76-82)."""
from __future__ import annotations

import torch
from torch import nn

from ...ops.safe_ops import safe_inverse_sigmoid


def init_anchor(num_anchor: int, semantic_dim: int, include_opa: bool,
                generator: torch.Generator) -> torch.Tensor:
    """[num_anchor, 10 + include_opa + semantic_dim]: xyz and scales
    uniform in the unit cube through the inverse sigmoid, the identity
    quaternion, opacity 0.5 (logit 0) where the anchor has one, normal
    semantics (reference gaussian_lifter.py:30-60)."""
    def uniform():
        return safe_inverse_sigmoid(torch.rand(num_anchor, 3,
                                               generator=generator))
    rots = torch.zeros(num_anchor, 4)
    rots[:, 0] = 1.0
    parts = [uniform(), uniform(), rots]
    if include_opa:
        parts.append(safe_inverse_sigmoid(torch.full((num_anchor, 1), 0.5)))
    if semantic_dim > 0:
        parts.append(torch.randn(num_anchor, semantic_dim,
                                 generator=generator))
    return torch.cat(parts, dim=-1)


class GaussianLifter(nn.Module):
    def __init__(self, num_anchor: int, embed_dims: int = 128,
                 semantic_dim: int = 17, include_opa: bool = True,
                 pts_init: bool = False):
        super().__init__()
        self.semantic_dim = semantic_dim
        self.include_opa = include_opa
        self.pts_init = pts_init
        self.anchor = nn.Parameter(torch.zeros(
            num_anchor, 10 + int(include_opa) + semantic_dim))
        self.instance_feature = nn.Parameter(torch.zeros(num_anchor,
                                                         embed_dims))

    def reset_parameters(self, generator: torch.Generator):
        """The reference's init, drawn from ``generator`` on the CPU."""
        with torch.no_grad():
            self.anchor.copy_(init_anchor(
                self.anchor.shape[0], self.semantic_dim, self.include_opa,
                generator))
            self.instance_feature.zero_()

    def forward(self, batch_size: int, anchor_points=None):
        """``anchor_points`` [B, num_anchor, 3]: required with
        ``pts_init``, ignored without."""
        rep = self.anchor[None].expand(batch_size, *self.anchor.shape)
        if self.pts_init:
            if anchor_points is None:
                raise ValueError("pts_init needs anchor_points")
            rep = torch.cat([safe_inverse_sigmoid(anchor_points),
                             rep[..., 3:]], dim=-1)
        return {
            "representation": rep,
            "rep_features": self.instance_feature[None].expand(
                batch_size, *self.instance_feature.shape),
        }
