"""Encoder building blocks (gaussianformer_tpu/models/encoder/modules.py):
anchor embedding, FFN, deformable multi-camera aggregation, sparse-conv
self-encoding, v1 and v2 refinement. Module names follow the reference.

Anchor layout: [xyz(3), scale(3), rot quat(4), opacity(0|1), semantics(C)].
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ...kernels import spconv
from ...kernels.deformable import deformable_aggregation
from ...ops.coords import cartesian, reverse_cartesian, world_xyz
from ...ops.rotation import quaternion_to_rotation_matrix
from ...ops.safe_ops import safe_sigmoid
from ...ops.sparse_conv import (neighbor_anchors, submanifold_conv3d,
                                voxel_indices)
from ..layers import Scale, dropout, linear_relu_ln


class GaussianPrediction(NamedTuple):
    """Per-refine-layer decoded Gaussians (world space)."""
    means: torch.Tensor       # [B, P, 3]
    scales: torch.Tensor      # [B, P, 3]
    rotations: torch.Tensor   # [B, P, 4]
    opacities: torch.Tensor   # [B, P, 0|1]
    semantics: torch.Tensor   # [B, P, C_sem]


class SparseGaussian3DEncoder(nn.Module):
    """Anchor -> embedding: per-component MLPs summed, then projected."""

    def __init__(self, embed_dims: int = 128, semantic_dim: int = 17,
                 include_opa: bool = True):
        super().__init__()
        self.semantic_dim = semantic_dim
        self.include_opa = include_opa
        self.xyz_fc = linear_relu_ln(embed_dims, 1, 2, 3)
        self.scale_fc = linear_relu_ln(embed_dims, 1, 2, 3)
        self.rot_fc = linear_relu_ln(embed_dims, 1, 2, 4)
        if include_opa:
            self.opacity_fc = linear_relu_ln(embed_dims, 1, 2, 1)
        self.semantics_fc = linear_relu_ln(embed_dims, 1, 2, semantic_dim)
        self.output_fc = linear_relu_ln(embed_dims, 1, 2)

    def forward(self, anchor):
        out = (self.xyz_fc(anchor[..., 0:3]) + self.scale_fc(anchor[..., 3:6])
               + self.rot_fc(anchor[..., 6:10]))
        start = 10
        if self.include_opa:
            out = out + self.opacity_fc(anchor[..., 10:11])
            start = 11
        out = out + self.semantics_fc(
            anchor[..., start:start + self.semantic_dim])
        return self.output_fc(out)


class AsymmetricFFN(nn.Module):
    """Linear -> ReLU -> Linear (reference ffn_module.py names:
    ``layers.0.0`` and ``layers.1``), with ``ffn_drop`` dropout after the
    ReLU and after the second Linear in training. With ``add_identity``
    the input is added to the result, through ``identity_fc`` when its
    width ``in_channels`` is not ``embed_dims`` (the v1 models, whose
    deformable output is concatenated to the features). With ``pre_norm``
    the input first goes through a LayerNorm over its ``in_channels``, and
    the normalised input is what is added."""

    def __init__(self, embed_dims: int = 128,
                 feedforward_channels: int = 512, ffn_drop: float = 0.0,
                 add_identity: bool = False,
                 in_channels: Optional[int] = None, pre_norm: bool = False):
        super().__init__()
        self.ffn_drop = ffn_drop
        self.add_identity = add_identity
        in_channels = in_channels or embed_dims
        self.pre_norm = nn.LayerNorm(in_channels) if pre_norm else None
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(in_channels, feedforward_channels),
                          nn.ReLU()),
            nn.Linear(feedforward_channels, embed_dims))
        self.identity_fc = (nn.Linear(in_channels, embed_dims)
                            if add_identity and in_channels != embed_dims
                            else nn.Identity())

    def forward(self, x, training: bool = False, generator=None):
        if self.pre_norm is not None:
            x = self.pre_norm(x)
        p = self.ffn_drop if training else 0.0
        h = dropout(self.layers[0](x), p, generator)
        out = dropout(self.layers[1](h), p, generator)
        if not self.add_identity:
            return out
        return self.identity_fc(x) + out


class SparseGaussian3DKeyPointsGenerator(nn.Module):
    """Key points = mean + R^T (fixed and learnable offsets x scale). The
    mean is the anchor's cartesian xyz or, with ``xyz_coordinate``
    "polar", its (r, theta, phi) through ``spherical_to_cartesian`` with
    ``phi_activation``. DeformableFeatureAggregation never sets these, as
    in the JAX package: its key points read the anchor as cartesian."""

    def __init__(self, embed_dims: int = 128, num_learnable_pts: int = 6,
                 learnable_fixed_scale: float = 6.0,
                 fix_scale=((0.0, 0.0, 0.0),),
                 pc_range=(-50.0, -50.0, -5.0, 50.0, 50.0, 3.0),
                 scale_range=(0.01, 3.2), xyz_coordinate: str = "cartesian",
                 phi_activation: str = "sigmoid"):
        super().__init__()
        self.xyz_coordinate = xyz_coordinate
        self.phi_activation = phi_activation
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
        xyz = world_xyz(anchor, self.pc_range, self.xyz_coordinate,
                        self.phi_activation)
        return key_points + xyz[:, :, None]


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
    deformable_module.py); ``residual_mode`` is "none" or "cat" (the
    input features concatenated after the output, the v1 models). In
    training, attention dropout as the JAX package does it: a keep mask
    ``uniform > attn_drop`` joins the visibility mask before the masked
    softmax, with no rescale (modules.py:443-457)."""

    def __init__(self, embed_dims: int = 128, num_groups: int = 4,
                 num_levels: int = 4, num_cams: int = 6,
                 num_learnable_pts: int = 6,
                 learnable_fixed_scale: float = 6.0,
                 fix_scale=((0.0, 0.0, 0.0),),
                 pc_range=(-50.0, -50.0, -5.0, 50.0, 50.0, 3.0),
                 scale_range=(0.01, 3.2), attn_drop: float = 0.0,
                 residual_mode: str = "none"):
        super().__init__()
        if residual_mode not in ("none", "cat"):
            raise ValueError(f"residual_mode {residual_mode!r}")
        self.residual_mode = residual_mode
        self.attn_drop = attn_drop
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
                         projection_mat, image_wh, training: bool = False,
                         generator=None):
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
        keep = None
        if training and self.attn_drop > 0:
            keep = torch.rand(weights.shape, generator=generator,
                              device=weights.device) > self.attn_drop
            keep = keep.permute(0, 1, 4, 2, 3, 5)
        weights = weights.permute(0, 1, 4, 2, 3, 5)     # [B, P, K, c, L, G]
        mask = vis.permute(0, 2, 3, 1)[..., None, None].expand(
            weights.shape)
        if keep is not None:
            mask = mask & keep
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
                projection_mat, image_wh, training: bool = False,
                generator=None):
        """feature_maps: per level [B, cams, H_l, W_l, C] (NHWC)."""
        loc, w = self.attention_inputs(instance_feature, anchor,
                                       anchor_embed, projection_mat,
                                       image_wh, training, generator)
        features = deformable_aggregation(feature_maps, loc, w,
                                          self.kps_generator.num_pts)
        output = self.output_proj(features)
        if self.residual_mode == "cat":
            return torch.cat([output, instance_feature], dim=-1)
        return output


class SubMConv3d(nn.Module):
    """Submanifold conv weights in spconv's layout [C_out, k, k, k, C_in];
    the gather and matmul run in ``dtype``, the output is fp32."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, dtype=torch.float32,
                 bias: bool = True):
        super().__init__()
        k = kernel_size
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, k, k, k,
                                               in_channels))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_channels))
        else:
            self.register_parameter("bias", None)

    def forward(self, x, nb_anchor):
        return submanifold_conv3d(x, nb_anchor, self.weight, self.bias,
                                  compute_dtype=self.dtype)

    def fused(self, x, coords, table, grid_shape):
        """The same conv by ``csrc/spconv.cu`` on the voxel table (bf16
        compute, no autograd)."""
        return spconv.submanifold_conv3d_cuda(x, coords, table, grid_shape,
                                              self.weight, self.bias)


class SparseConv3DModule(nn.Module):
    """Submanifold convs over the voxelised anchors (reference
    spconv3d_module.py): three conv + LN + ReLU layers
    (``use_multi_layer``, GaussianFormer-2) or one conv without bias (the
    v1 models), then an output projection where ``use_out_proj``. The
    convs compute in ``dtype`` (bf16 at full width, as the JAX package
    does on accelerators). Where :func:`kernels.spconv.why_not_fused`
    allows it (a bf16 frame on the card), every conv of a call runs in
    ``csrc/spconv.cu`` on one voxel table built on the card; elsewhere (a
    train step, fp32, the CPU) in the gather form."""

    def __init__(self, in_channels: int = 128, embed_channels: int = 128,
                 pc_range=(-50.0, -50.0, -5.0, 50.0, 50.0, 3.0),
                 grid_size=(1.0, 1.0, 1.0), kernel_size: int = 5,
                 dtype=torch.float32, use_out_proj: bool = True,
                 use_multi_layer: bool = True):
        super().__init__()
        self.pc_range = tuple(pc_range)
        self.grid_size = tuple(grid_size)
        self.kernel_size = kernel_size
        self.use_multi_layer = use_multi_layer
        if use_multi_layer:
            layers = []
            for i in range(3):
                layers += [SubMConv3d(
                    in_channels if i == 0 else embed_channels,
                    embed_channels, kernel_size, dtype),
                    nn.LayerNorm(embed_channels), nn.ReLU()]
            self.layer = nn.Sequential(*layers)
        else:
            self.layer = SubMConv3d(in_channels, embed_channels,
                                    kernel_size, dtype, bias=False)
        self.output_proj = (nn.Linear(embed_channels, embed_channels)
                            if use_out_proj else nn.Identity())

    def forward(self, instance_feature, anchor):
        xyz = cartesian(anchor[..., :3], self.pc_range)
        coords, grid_shape = voxel_indices(xyz, self.pc_range,
                                           self.grid_size)
        convs = ([self.layer[i] for i in range(0, len(self.layer), 3)]
                 if self.use_multi_layer else [self.layer])
        fused = spconv.why_not_fused(
            instance_feature, [c.weight for c in convs],
            [c.bias for c in convs], convs[0].dtype) is None
        outs = []
        for bi in range(instance_feature.shape[0]):
            if fused:
                c32 = coords[bi].to(torch.int32).contiguous()
                table = spconv.voxel_table_cuda(c32, grid_shape)

                def conv(layer, x):
                    return layer.fused(x, c32, table, grid_shape)
            else:
                nb = neighbor_anchors(coords[bi], grid_shape,
                                      self.kernel_size)

                def conv(layer, x):
                    return layer(x, nb)
            x = instance_feature[bi]
            if self.use_multi_layer:
                for i in range(0, len(self.layer), 3):
                    x = conv(self.layer[i], x)
                    x = torch.relu(self.layer[i + 1](x))
            else:
                x = conv(self.layer, x)
            outs.append(x)
        return self.output_proj(torch.stack(outs))


def apply_semantics_activation(semantics, activation: str):
    if activation == "softplus":
        return torch.nn.functional.softplus(semantics)
    if activation != "identity":
        raise ValueError(f"semantics_activation {activation!r}")
    return semantics


class SparseGaussian3DRefinementModule(nn.Module):
    """v1 refinement (reference refine_module.py): the head's output is
    the new anchor. With ``restrict_xyz`` its xyz part is a bounded step,
    (2 sigmoid - 1) * 4 unit / range in the anchor's logit space; the
    components listed in ``refine_manual`` are added to the old anchor's,
    the others replace them. The anchor returned is that output with its
    quaternion normalised, not a re-encoding of the decoded Gaussian. With
    ``xyz_coordinate`` "polar" the Gaussian's mean is that anchor's
    (r, theta, phi) through ``spherical_to_cartesian`` with
    ``phi_activation``."""

    def __init__(self, embed_dims: int = 128,
                 pc_range=(-50.0, -50.0, -5.0, 50.0, 50.0, 3.0),
                 scale_range=(0.08, 0.64), unit_xyz=(4.0, 4.0, 1.0),
                 semantic_dim: int = 17, include_opa: bool = True,
                 semantics_activation: str = "identity",
                 restrict_xyz: bool = False, refine_manual=None,
                 xyz_coordinate: str = "cartesian",
                 phi_activation: str = "sigmoid"):
        super().__init__()
        self.xyz_coordinate = xyz_coordinate
        self.phi_activation = phi_activation
        self.pc_range = tuple(pc_range)
        self.scale_range = tuple(scale_range)
        self.semantic_dim = semantic_dim
        self.include_opa = include_opa
        self.semantics_activation = semantics_activation
        self.restrict_xyz = restrict_xyz
        self.refine_manual = tuple(refine_manual or ())
        self.register_buffer("unit_prob", torch.tensor(
            [unit_xyz[i] / (pc_range[i + 3] - pc_range[i]) * 4.0
             for i in range(3)], dtype=torch.float32), persistent=False)
        out_dim = 10 + int(include_opa) + semantic_dim
        self.layers = nn.Sequential(
            *linear_relu_ln(embed_dims, 2, 2),
            nn.Linear(embed_dims, out_dim), Scale(out_dim))

    def forward(self, instance_feature, anchor, anchor_embed):
        output = self.layers(instance_feature + anchor_embed)
        if self.restrict_xyz:
            delta = (2.0 * safe_sigmoid(output[..., :3]) - 1.0) \
                * self.unit_prob
            output = torch.cat([delta, output[..., 3:]], -1)
        k = len(self.refine_manual)
        if k:
            output = torch.cat([output[..., :k] + anchor[..., :k],
                                output[..., k:]], -1)
        xyz_a = output[..., :3]
        scale_a = output[..., 3:6]
        rot = output[..., 6:10]
        rot = rot / rot.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        output = torch.cat([xyz_a, scale_a, rot, output[..., 10:]], -1)
        sem_start = 10 + int(self.include_opa)
        lo, hi = self.scale_range
        gaussian = GaussianPrediction(
            means=world_xyz(output, self.pc_range, self.xyz_coordinate,
                            self.phi_activation),
            scales=lo + (hi - lo) * safe_sigmoid(scale_a),
            rotations=rot,
            opacities=safe_sigmoid(output[..., 10:sem_start]),
            semantics=apply_semantics_activation(
                output[..., sem_start:sem_start + self.semantic_dim],
                self.semantics_activation))
        return output, gaussian


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
