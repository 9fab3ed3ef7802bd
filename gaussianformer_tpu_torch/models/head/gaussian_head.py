"""Gaussian occupancy head
(gaussianformer_tpu/models/head/gaussian_head.py): the supervised refine
layers' Gaussians are splatted to the voxel grid (kernels K4 / K7);
``final_occ`` comes from the kernel's label epilogue of the last splatted
layer.

- prob (``use_localaggprob``, GaussianFormer-2): softmax semantics with a
  zero empty channel, the GMM splat, ``pred_occ`` composed with
  combine_geosem, plus ``bin_logits`` and ``density``.
- additive (the v1 models): the semantics as the refinement left them, the
  additive splat, ``pred_occ`` its raw sums. ``with_empty`` appends one
  large fixed Gaussian that carries the learnable ``empty_scalar`` on the
  empty class; a prediction without opacities is splatted with ones.

The threshold label mode (``combine_geosem=False`` with the prob splat) is
not ported."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...kernels.splat import combine_geosem
from ...ops.covariance import build_covariance_inverse6
from ...ops.splat import SplatGridSpec, splat_additive, splat_prob


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
                 apply_loss_type: str = "random_1", num_classes: int = 18,
                 empty_label: int = 17, with_empty: bool = False,
                 empty_mean=(0.0, 0.0, -1.0),
                 empty_scale=(100.0, 100.0, 8.0),
                 use_localaggprob: bool = True,
                 combine_geosem: bool = True):
        super().__init__()
        if use_localaggprob and not combine_geosem:
            raise NotImplementedError("the threshold label mode of the "
                                      "prob head")
        self.grid = grid
        self.apply_loss_type = apply_loss_type
        self.with_empty = with_empty
        self.use_localaggprob = use_localaggprob
        if with_empty:
            self.empty_scalar = nn.Parameter(torch.full((1,), 10.0))
            f32 = dict(dtype=torch.float32)
            self.register_buffer("empty_mean", torch.tensor(
                empty_mean, **f32), persistent=False)
            self.register_buffer("empty_scale", torch.tensor(
                empty_scale, **f32), persistent=False)
            self.register_buffer("empty_rot", torch.tensor(
                [1.0, 0.0, 0.0, 0.0], **f32), persistent=False)
            onehot = torch.zeros(num_classes, **f32)
            onehot[empty_label] = 1.0
            self.register_buffer("empty_onehot", onehot, persistent=False)

    def prepare_gaussian_args(self, gaussians):
        """(means, opacities [B, P], semantics [B, P, C], scales,
        cov_inv6) as the splat takes them
        (gaussian_head.py::prepare_gaussian_args)."""
        means, scales = gaussians.means, gaussians.scales
        rotations, sem = gaussians.rotations, gaussians.semantics
        opa = gaussians.opacities
        if opa.shape[-1] == 0:
            opa = torch.ones_like(sem[..., :1])
        if self.with_empty:
            b = means.shape[0]
            # the learnt Gaussians get a zero on the empty channel; the
            # empty Gaussian carries empty_scalar there and zeros elsewhere
            sem = torch.cat([sem, torch.zeros_like(sem[..., :1])], dim=-1)
            e_sem = self.empty_onehot * self.empty_scalar

            def one(t):
                return t.expand(b, 1, -1)
            means = torch.cat([means, one(self.empty_mean)], dim=1)
            scales = torch.cat([scales, one(self.empty_scale)], dim=1)
            rotations = torch.cat([rotations, one(self.empty_rot)], dim=1)
            sem = torch.cat([sem, one(e_sem)], dim=1)
            opa = torch.cat([opa, torch.ones_like(opa[:, :1])], dim=1)
        elif self.use_localaggprob:
            sem = torch.softmax(sem, dim=-1)
            sem = torch.cat([sem, torch.zeros_like(sem[..., :1])], dim=-1)
        cov_inv6 = build_covariance_inverse6(scales, rotations)
        return means, opa[..., 0], sem, scales, cov_inv6

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
            args = self.prepare_gaussian_args(representation[idx])
            if self.use_localaggprob:
                logits, bins, dens, labels = splat_prob(points, *args,
                                                        self.grid)
                pred.append(combine_geosem(logits, bins))
                bin_logits.append(bins)
                density.append(dens)
            else:
                logits, labels = splat_additive(points, *args, self.grid)
                pred.append(logits)
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
