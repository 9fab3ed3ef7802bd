"""Encoder building blocks (gaussianformer_tpu/models/encoder/modules.py):
anchor embedding, FFN, deformable multi-camera aggregation, sparse-conv
self-encoding, v2 refinement. Module names follow the reference.

Anchor layout: [xyz(3), scale(3), rot quat(4), opacity(1), semantics(C)].
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ...kernels.deformable import deformable_aggregation
from ...ops.coords import cartesian, reverse_cartesian
from ...ops.rotation import quaternion_to_rotation_matrix
from ...ops.safe_ops import safe_sigmoid
from ...ops.sparse_conv import (neighbor_anchors, submanifold_conv3d,
                                voxel_indices)
from ..layers import Scale, linear_relu_ln


class GaussianPrediction(NamedTuple):
    """Per-refine-layer decoded Gaussians (world space)."""
    means: torch.Tensor       # [B, P, 3]
    scales: torch.Tensor      # [B, P, 3]
    rotations: torch.Tensor   # [B, P, 4]
    opacities: torch.Tensor   # [B, P, 1]
    semantics: torch.Tensor   # [B, P, C_sem]


class SparseGaussian3DEncoder(nn.Module):
    """Anchor -> embedding: per-component MLPs summed, then projected."""

    def __init__(self, embed_dims: int = 128, semantic_dim: int = 17):
        super().__init__()
        self.semantic_dim = semantic_dim
        self.xyz_fc = linear_relu_ln(embed_dims, 1, 2, 3)
        self.scale_fc = linear_relu_ln(embed_dims, 1, 2, 3)
        self.rot_fc = linear_relu_ln(embed_dims, 1, 2, 4)
        self.opacity_fc = linear_relu_ln(embed_dims, 1, 2, 1)
        self.semantics_fc = linear_relu_ln(embed_dims, 1, 2, semantic_dim)
        self.output_fc = linear_relu_ln(embed_dims, 1, 2)

    def forward(self, anchor):
        out = (self.xyz_fc(anchor[..., 0:3]) + self.scale_fc(anchor[..., 3:6])
               + self.rot_fc(anchor[..., 6:10])
               + self.opacity_fc(anchor[..., 10:11])
               + self.semantics_fc(anchor[..., 11:11 + self.semantic_dim]))
        return self.output_fc(out)


class AsymmetricFFN(nn.Module):
    """Linear -> ReLU -> Linear without identity (reference ffn_module.py
    names: ``layers.0.0`` and ``layers.1``; dropout is off at inference)."""

    def __init__(self, embed_dims: int = 128,
                 feedforward_channels: int = 512):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(embed_dims, feedforward_channels),
                          nn.ReLU()),
            nn.Linear(feedforward_channels, embed_dims))

    def forward(self, x):
        return self.layers(x)


class SparseGaussian3DKeyPointsGenerator(nn.Module):
    """Key points = mean + R^T (fixed and learnable offsets x scale)."""

    def __init__(self, embed_dims: int = 128, num_learnable_pts: int = 6,
                 learnable_fixed_scale: float = 6.0,
                 fix_scale=((0.0, 0.0, 0.0),),
                 pc_range=(-50.0, -50.0, -5.0, 50.0, 50.0, 3.0),
                 scale_range=(0.01, 3.2)):
        super().__init__()
        self.num_learnable_pts = num_learnable_pts
        self.learnable_fixed_scale = learnable_fixed_scale
        self.register_buffer("fix_scale",
                             torch.tensor(fix_scale, dtype=torch.float32),
                             persistent=False)
        self.pc_range = tuple(pc_range)
        self.scale_range = tuple(scale_range)
        self.learnable_fc = nn.Linear(embed_dims, num_learnable_pts * 3)

    @property
    def num_pts(self) -> int:
        return self.fix_scale.shape[0] + self.num_learnable_pts

    def forward(self, anchor, instance_feature):
        b, p = anchor.shape[:2]
        scale = self.fix_scale[None, None].expand(b, p, -1, 3)
        learn = safe_sigmoid(self.learnable_fc(instance_feature).reshape(
            b, p, self.num_learnable_pts, 3)) - 0.5
        scale = torch.cat([scale, learn * self.learnable_fixed_scale], -2)
        lo, hi = self.scale_range
        gs = lo + (hi - lo) * safe_sigmoid(anchor[..., None, 3:6])
        key_points = scale * gs                         # [B, P, K, 3]
        rot = quaternion_to_rotation_matrix(anchor[..., 6:10])
        # R^T applied to each key point: kp_i = sum_j R[j, i] v_j
        key_points = torch.einsum("bpji,bpkj->bpki", rot, key_points)
        return key_points + cartesian(anchor[..., :3],
                                      self.pc_range)[:, :, None]


def project_points(key_points, projection_mat, image_wh):
    """[B, P, K, 3] -> normalised (u, v) [B, cams, P, K, 2] and the
    in-front-and-inside mask [B, cams, P, K]."""
    pts = torch.cat([key_points, torch.ones_like(key_points[..., :1])], -1)
    proj = torch.einsum("bcij,bpkj->bcpki", projection_mat, pts)
    depth = proj[..., 2]
    uv = proj[..., :2] / depth[..., None].clamp_min(1e-5)
    uv = uv / image_wh[:, :, None, None, :]
    mask = ((depth > 1e-5) & (uv[..., 0] > 0.0) & (uv[..., 0] < 1.0)
            & (uv[..., 1] > 0.0) & (uv[..., 1] < 1.0))
    return uv, mask


class DeformableFeatureAggregation(nn.Module):
    """Deformable multi-camera multi-level cross attention (reference
    deformable_module.py), residual mode "none"."""

    def __init__(self, embed_dims: int = 128, num_groups: int = 4,
                 num_levels: int = 4, num_cams: int = 6,
                 num_learnable_pts: int = 6,
                 learnable_fixed_scale: float = 6.0,
                 fix_scale=((0.0, 0.0, 0.0),),
                 pc_range=(-50.0, -50.0, -5.0, 50.0, 50.0, 3.0),
                 scale_range=(0.01, 3.2)):
        super().__init__()
        self.num_groups = num_groups
        self.num_levels = num_levels
        self.num_cams = num_cams
        self.kps_generator = SparseGaussian3DKeyPointsGenerator(
            embed_dims, num_learnable_pts, learnable_fixed_scale, fix_scale,
            pc_range, scale_range)
        num_pts = self.kps_generator.num_pts
        self.camera_encoder = linear_relu_ln(embed_dims, 1, 2, 12)
        self.weights_fc = nn.Linear(embed_dims,
                                    num_groups * num_levels * num_pts)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    def attention_inputs(self, instance_feature, anchor, anchor_embed,
                         projection_mat, image_wh):
        """Sample locations [B, P*K, cams, 2] and masked-softmax weights
        [B, P*K, cams, L, G] of the aggregation."""
        b, p = instance_feature.shape[:2]
        k = self.kps_generator.num_pts
        key_points = self.kps_generator(anchor, instance_feature)
        cam_embed = self.camera_encoder(
            projection_mat[:, :, :3].reshape(b, self.num_cams, 12))
        feature = (instance_feature + anchor_embed)[:, :, None] \
            + cam_embed[:, None]
        weights = self.weights_fc(feature).reshape(
            b, p, self.num_cams, self.num_levels, k, self.num_groups)
        points_2d, vis = project_points(key_points, projection_mat,
                                        image_wh)
        weights = weights.permute(0, 1, 4, 2, 3, 5)     # [B, P, K, c, L, G]
        mask = vis.permute(0, 2, 3, 1)[..., None, None].expand(
            weights.shape)
        # rows that miss every camera are zeroed, not softmaxed over -inf
        all_miss = mask.sum(dim=(2, 3, 4), keepdim=True) == 0
        w = weights.masked_fill(~mask, float("-inf"))
        w = w.masked_fill(all_miss, 0.0)
        w = torch.softmax(w.reshape(b, p, -1, self.num_groups), dim=-2)
        w = w.reshape(weights.shape).masked_fill(all_miss, 0.0)
        w = w.reshape(b, p * k, self.num_cams, self.num_levels,
                      self.num_groups)
        loc = points_2d.permute(0, 2, 3, 1, 4).reshape(
            b, p * k, self.num_cams, 2)
        return loc.contiguous(), w.contiguous()

    def forward(self, instance_feature, anchor, anchor_embed, feature_maps,
                projection_mat, image_wh):
        """feature_maps: per level [B, cams, H_l, W_l, C] (NHWC)."""
        loc, w = self.attention_inputs(instance_feature, anchor,
                                       anchor_embed, projection_mat,
                                       image_wh)
        features = deformable_aggregation(feature_maps, loc, w,
                                          self.kps_generator.num_pts)
        return self.output_proj(features)


class SubMConv3d(nn.Module):
    """Submanifold conv weights in spconv's layout [C_out, k, k, k, C_in];
    the gather and matmul run in ``dtype``, the output is fp32."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, dtype=torch.float32):
        super().__init__()
        k = kernel_size
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, k, k, k,
                                               in_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x, nb_anchor):
        return submanifold_conv3d(x, nb_anchor, self.weight, self.bias,
                                  compute_dtype=self.dtype)


class SparseConv3DModule(nn.Module):
    """Three submanifold conv + LN + ReLU layers over the voxelised anchors,
    then an output projection (reference spconv3d_module.py). The convs
    compute in ``dtype`` (bf16 for the flagship, as the JAX package does
    on accelerators)."""

    def __init__(self, in_channels: int = 128, embed_channels: int = 128,
                 pc_range=(-50.0, -50.0, -5.0, 50.0, 50.0, 3.0),
                 grid_size=(1.0, 1.0, 1.0), kernel_size: int = 5,
                 dtype=torch.float32):
        super().__init__()
        self.pc_range = tuple(pc_range)
        self.grid_size = tuple(grid_size)
        self.kernel_size = kernel_size
        layers = []
        for i in range(3):
            layers += [SubMConv3d(in_channels if i == 0 else embed_channels,
                                  embed_channels, kernel_size, dtype),
                       nn.LayerNorm(embed_channels), nn.ReLU()]
        self.layer = nn.Sequential(*layers)
        self.output_proj = nn.Linear(embed_channels, embed_channels)

    def forward(self, instance_feature, anchor):
        xyz = cartesian(anchor[..., :3], self.pc_range)
        coords, grid_shape = voxel_indices(xyz, self.pc_range,
                                           self.grid_size)
        outs = []
        for bi in range(instance_feature.shape[0]):
            nb = neighbor_anchors(coords[bi], grid_shape, self.kernel_size)
            x = instance_feature[bi]
            for i in range(0, len(self.layer), 3):
                x = self.layer[i](x, nb)
                x = torch.relu(self.layer[i + 1](x))
            outs.append(x)
        return self.output_proj(torch.stack(outs))


class SparseGaussian3DRefinementModuleV2(nn.Module):
    """v2 refinement: world-space bounded xyz delta; scale, rotation,
    opacity and semantics replaced (reference refine_module_v2.py)."""

    def __init__(self, embed_dims: int = 128,
                 pc_range=(-50.0, -50.0, -5.0, 50.0, 50.0, 3.0),
                 scale_range=(0.01, 3.2), unit_xyz=(4.0, 4.0, 1.0),
                 semantic_dim: int = 17):
        super().__init__()
        self.pc_range = tuple(pc_range)
        self.scale_range = tuple(scale_range)
        self.semantic_dim = semantic_dim
        self.register_buffer("unit_xyz",
                             torch.tensor(unit_xyz, dtype=torch.float32),
                             persistent=False)
        out_dim = 11 + semantic_dim
        self.layers = nn.Sequential(
            *linear_relu_ln(embed_dims, 2, 2),
            nn.Linear(embed_dims, out_dim), Scale(out_dim))

    def forward(self, instance_feature, anchor, anchor_embed):
        output = self.layers(instance_feature + anchor_embed)
        delta_xyz = (2.0 * safe_sigmoid(output[..., :3]) - 1.0) \
            * self.unit_xyz
        original_xyz = cartesian(anchor[..., :3], self.pc_range)
        anchor_xyz = reverse_cartesian(original_xyz + delta_xyz,
                                       self.pc_range)
        scale_a = output[..., 3:6]
        rot = output[..., 6:10]
        rot = rot / rot.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        opa = output[..., 10:11]
        sem = output[..., 11:11 + self.semantic_dim]
        new_anchor = torch.cat([anchor_xyz, scale_a, rot, opa, sem], -1)
        lo, hi = self.scale_range
        gaussian = GaussianPrediction(
            means=cartesian(anchor_xyz, self.pc_range),
            scales=lo + (hi - lo) * safe_sigmoid(scale_a),
            rotations=rot,
            opacities=safe_sigmoid(opa),
            semantics=sem)
        return new_anchor, gaussian
