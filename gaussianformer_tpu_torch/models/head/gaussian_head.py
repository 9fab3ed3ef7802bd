"""Gaussian occupancy head
(gaussianformer_tpu/models/head/gaussian_head.py): the supervised refine
layers' Gaussians are splatted to the voxel grid (kernels K4 / K7);
``final_occ`` comes from the kernel's label epilogue of the last splatted
layer.

- prob (``use_localaggprob``, GaussianFormer-2): softmax semantics with a
  zero empty channel, the GMM splat, plus ``bin_logits`` and ``density``.
  With ``combine_geosem`` ``pred_occ`` is combine_geosem's composition and
  the labels its argmax; without (the threshold label mode) ``pred_occ`` is
  the normalised semantics and a voxel is labelled their argmax where its
  occupancy ``bin_logits`` exceeds ``sigmoid_thresh``, else empty.
- additive (the v1 models): the semantics as the refinement left them, the
  additive splat, ``pred_occ`` its raw sums. ``with_empty`` appends one
  large fixed Gaussian that carries the learnable ``empty_scalar`` on the
  empty class; a prediction without opacities is splatted with ones.

``per_axis_radii`` (the reference's localagg_prob_fast) sizes each box by
the Gaussian's scale on each axis rather than by its largest. ``max_scale``
(the refinement's largest scale) bounds the boxes, and so the entries of
the splat's tile bins on the card (the empty Gaussian's box is the whole
grid); without it the bins have room for every tile of every box. With
``"kitti"`` in ``dataset_type`` the learnt Gaussians' zero empty column
goes first rather than last, in both variants; the splat's uniform
fallback and ``combine_geosem`` still read the last column as empty, as
in the JAX package."""
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
                 combine_geosem: bool = True, sigmoid_thresh: float = 0.5,
                 per_axis_radii: bool = False, dataset_type: str = "nusc",
                 max_scale: Optional[float] = None):
        super().__init__()
        self.grid = grid
        self.bound = dict(
            max_radius=(None if max_scale is None
                        else grid.radius_bound(max_scale)),
            whole=int(with_empty))
        self.empty_first = "kitti" in dataset_type
        self.apply_loss_type = apply_loss_type
        self.with_empty = with_empty
        self.use_localaggprob = use_localaggprob
        self.combine_geosem = combine_geosem
        self.per_axis_radii = per_axis_radii
        self.labels = dict(
            label_mode="combine" if combine_geosem else "threshold",
            thresh=sigmoid_thresh, empty_label=empty_label)
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

        def with_empty_column(t):
            parts = [t, torch.zeros_like(t[..., :1])]
            return torch.cat(parts[::-1] if self.empty_first else parts, -1)

        if self.with_empty:
            b = means.shape[0]
            # the learnt Gaussians get a zero on the empty channel; the
            # empty Gaussian carries empty_scalar there and zeros elsewhere
            sem = with_empty_column(sem)
            e_sem = self.empty_onehot * self.empty_scalar

            def one(t):
                return t.expand(b, 1, -1)
            means = torch.cat([means, one(self.empty_mean)], dim=1)
            scales = torch.cat([scales, one(self.empty_scale)], dim=1)
            rotations = torch.cat([rotations, one(self.empty_rot)], dim=1)
            sem = torch.cat([sem, one(e_sem)], dim=1)
            opa = torch.cat([opa, torch.ones_like(opa[:, :1])], dim=1)
        elif self.use_localaggprob:
            sem = with_empty_column(torch.softmax(sem, dim=-1))
        cov_inv6 = build_covariance_inverse6(scales, rotations)
        return means, opa[..., 0], sem, scales, cov_inv6

    def forward(self, representation, occ_xyz, occ_label=None,
                occ_cam_mask=None, training: bool = False,
                apply_loss_layers: Optional[Sequence[int]] = None):
        """occ_xyz [B, X, Y, Z, 3] voxel centres, which come back
        flattened as ``sampled_xyz`` (the distance-weighted focal loss reads
        them); occ_label and occ_cam_mask [B, X, Y, Z] come back flattened
        as the losses' ``sampled_label`` and ``occ_mask``."""
        b = occ_xyz.shape[0]
        points = occ_xyz.reshape(b, -1, 3)
        layers = loss_layers(self.apply_loss_type, len(representation),
                             training, apply_loss_layers)
        pred, bin_logits, density = [], [], []
        for idx in layers:
            args = self.prepare_gaussian_args(representation[idx])
            if self.use_localaggprob:
                logits, bins, dens, labels = splat_prob(
                    points, *args, self.grid, self.per_axis_radii,
                    **self.labels, **self.bound)
                pred.append(combine_geosem(logits, bins)
                            if self.combine_geosem else logits)
                bin_logits.append(bins)
                density.append(dens)
            else:
                logits, labels = splat_additive(points, *args, self.grid,
                                                self.per_axis_radii,
                                                **self.bound)
                pred.append(logits)
        out = {
            "pred_occ": pred,
            "bin_logits": bin_logits,
            "density": density,
            "final_occ": labels,
            "gaussian": representation[-1],
            "sampled_xyz": points,
        }
        if occ_label is not None:
            out["sampled_label"] = occ_label.reshape(b, -1)
        if occ_cam_mask is not None:
            out["occ_mask"] = occ_cam_mask.reshape(b, -1)
        return out
