"""Top-level segmentor (gaussianformer_tpu/models/segmentor.py): images ->
ResNet+DCN -> FPN -> lifter -> GaussianOccEncoder -> GaussianHead. The
lifter is GaussianLifterV2 (a second tower, depth sampling and FPS;
GaussianFormer-2) or the v1 models' GaussianLifter, a learnable anchor
bank, with which there are no ``pixel_logits``.

``training=True`` is the train step's forward: the lifter's ray ground
truth, dropout, the head's supervised-layer choice. Gradients follow
autograd's mode: inference callers run under ``torch.inference_mode()``,
which also selects the DCN kernel's fused epilogue."""
from __future__ import annotations

import inspect
from typing import Optional, Sequence

import torch
from torch import nn

from ..configs.nuscenes import GaussianFormerConfig
from ..device import resolve_device
from ..utils.profiling import span
from .backbone.resnet import ResNet
from .encoder.gaussian_encoder import GaussianOccEncoder
from .encoder.modules import (AsymmetricFFN, DeformableFeatureAggregation,
                              SparseConv3DModule,
                              SparseGaussian3DRefinementModule,
                              SparseGaussian3DRefinementModuleV2)
from .head.gaussian_head import GaussianHead
from .lifter.gaussian_lifter import GaussianLifter
from .lifter.gaussian_lifter_v2 import GaussianLifterV2
from .neck.fpn import FPN


class BEVSegmentor(nn.Module):
    """Built from the config. ``module_overrides`` carries the edits the
    JAX package makes to the dicts of ``cfg.segmentor_cfg()`` to reach the
    options no config field sets, under the same names: ``lifter_cfg``
    (the v1 lifter's ``pts_init``), ``encoder_cfg`` with its
    ``refine_cfg`` / ``ffn_cfg`` / ``deformable_cfg`` / ``spconv_cfg``
    (the v1 refinement's ``xyz_coordinate`` and ``phi_activation``) and
    ``head_cfg`` (``dataset_type``); each key is a keyword of the module
    it reaches, and an unknown one raises."""

    def __init__(self, cfg: GaussianFormerConfig, module_overrides=None):
        super().__init__()
        dt = getattr(torch, cfg.compute_dtype)
        self.img_backbone = ResNet(depth=cfg.depth,
                                   base_channels=cfg.base_channels,
                                   stage_with_dcn=cfg.stage_with_dcn,
                                   dtype=dt)
        self.img_neck = FPN(self.img_backbone.out_channels, cfg.embed_dims)
        self.lifter_version = cfg.version
        if cfg.version == 1:
            lifter_cls = GaussianLifter
            lifter_cfg = dict(
                num_anchor=cfg.num_anchor, embed_dims=cfg.embed_dims,
                semantic_dim=cfg.semantic_dim, include_opa=cfg.include_opa)
        else:
            lifter_cls = GaussianLifterV2
            lifter_cfg = dict(
                num_anchor=cfg.num_anchor, embed_dims=cfg.embed_dims,
                semantic_dim=cfg.semantic_dim,
                num_samples=cfg.num_depth_samples, pc_range=cfg.pc_range,
                random_samples=cfg.random_samples,
                initializer_depth=cfg.depth,
                initializer_dcn=cfg.stage_with_dcn,
                initializer_base_channels=cfg.base_channels,
                initializer_out_channels=cfg.initializer_out_channels,
                voxel_size=cfg.grid.grid_size,
                occ_resolution=cfg.occ_resolution,
                empty_label=cfg.empty_label, dtype=dt)
        kps = dict(num_learnable_pts=cfg.num_learnable_pts,
                   learnable_fixed_scale=cfg.learnable_fixed_scale,
                   fix_scale=cfg.fix_scale, pc_range=cfg.pc_range,
                   scale_range=cfg.scale_range)
        refine_cfg = dict(embed_dims=cfg.embed_dims, pc_range=cfg.pc_range,
                          scale_range=cfg.scale_range, unit_xyz=cfg.unit_xyz,
                          semantic_dim=cfg.semantic_dim)
        if cfg.version == 1:
            refine_cfg.update(
                include_opa=cfg.include_opa,
                semantics_activation=cfg.semantics_activation,
                restrict_xyz=cfg.restrict_xyz,
                refine_manual=cfg.refine_manual)
        encoder_cfg = dict(
            ffn_cfg=dict(embed_dims=cfg.embed_dims,
                         feedforward_channels=cfg.embed_dims * 4,
                         ffn_drop=cfg.ffn_drop,
                         add_identity=cfg.ffn_add_identity,
                         in_channels=cfg.ffn_in_channels,
                         pre_norm=cfg.ffn_pre_norm),
            deformable_cfg=dict(
                embed_dims=cfg.embed_dims, num_cams=cfg.num_cams,
                attn_drop=cfg.attn_drop,
                residual_mode=cfg.deformable_residual_mode, **kps),
            refine_cfg=refine_cfg,
            spconv_cfg=dict(in_channels=cfg.embed_dims,
                            embed_channels=cfg.embed_dims,
                            pc_range=cfg.pc_range,
                            grid_size=cfg.spconv_grid_size, dtype=dt,
                            use_out_proj=cfg.spconv_use_out_proj,
                            use_multi_layer=cfg.spconv_use_multi_layer))
        head_cfg = dict(
            grid=cfg.grid, apply_loss_type=cfg.apply_loss_type,
            num_classes=cfg.num_classes, empty_label=cfg.empty_label,
            with_empty=cfg.with_empty, empty_mean=cfg.empty_mean,
            empty_scale=cfg.empty_scale,
            use_localaggprob=cfg.use_localaggprob,
            combine_geosem=cfg.combine_geosem,
            per_axis_radii=cfg.use_localaggprob_fast,
            max_scale=cfg.scale_range[1])
        refine_cls = (SparseGaussian3DRefinementModuleV2 if cfg.version == 2
                      else SparseGaussian3DRefinementModule)
        _apply_overrides(module_overrides or {}, {
            "lifter_cfg": (lifter_cfg, lifter_cls),
            "encoder_cfg": (encoder_cfg, {
                "ffn_cfg": AsymmetricFFN,
                "deformable_cfg": DeformableFeatureAggregation,
                "refine_cfg": refine_cls,
                "spconv_cfg": SparseConv3DModule}),
            "head_cfg": (head_cfg, GaussianHead)})
        self.lifter = lifter_cls(**lifter_cfg)
        self.encoder = GaussianOccEncoder(
            cfg.operation_order, cfg.embed_dims, cfg.semantic_dim,
            include_opa=cfg.include_opa, refine_version=cfg.version,
            **encoder_cfg)
        self.head = GaussianHead(**head_cfg)

    def forward(self, imgs, projection_mat, image_wh, occ_xyz=None,
                occ_label=None, occ_cam_mask=None, anchor_points=None, *,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                rep_only: bool = False, occ_only: bool = False,
                lifter_draws=None,
                apply_loss_layers: Optional[Sequence[int]] = None):
        """imgs [B, N, H, W, 3] normalised images; projection_mat
        [B, N, 4, 4] lidar -> image; image_wh [B, N, 2]; occ_xyz
        [B, X, Y, Z, 3] voxel centres (needed unless ``rep_only``);
        occ_label and occ_cam_mask [B, X, Y, Z], the ground truth of the
        losses; anchor_points [B, num_anchor, 3] in [0, 1]^3, the v1
        lifter's with ``pts_init``. ``generator`` drives the lifter's depth
        sampling and padding and, with ``training``, the dropout draws."""
        with span("forward"):
            b, n = imgs.shape[:2]
            flat = imgs.flatten(0, 1).permute(0, 3, 1, 2)
            with span("towers"):
                feats = self.img_neck(self.img_backbone(flat))
            ms_feats = [f.permute(0, 2, 3, 1).reshape(
                b, n, f.shape[2], f.shape[3], f.shape[1]).contiguous()
                for f in feats]
            with span("lifter"):
                if self.lifter_version == 1:
                    lifter_out = self.lifter(b, anchor_points)
                else:
                    lifter_out = self.lifter(
                        imgs, projection_mat, image_wh, occ_label,
                        occ_cam_mask, generator=generator,
                        draws=lifter_draws, compute_gt=training)
            with span("encoder"):
                enc_out = self.encoder(lifter_out["representation"],
                                       lifter_out["rep_features"], ms_feats,
                                       projection_mat, image_wh, training,
                                       generator)
            if rep_only:
                return {"representation": enc_out["representation"]}
            with span("head"):
                head_out = self.head(enc_out["representation"], occ_xyz,
                                     occ_label, occ_cam_mask, training,
                                     apply_loss_layers)
            if occ_only:
                return {"final_occ": head_out["final_occ"]}
            head_out["pixel_logits"] = lifter_out.get("pixel_logits")
            head_out["pixel_gt"] = lifter_out.get("pixel_gt")
            return head_out


def _apply_overrides(overrides, targets):
    """Update the module keyword dicts of ``targets`` (name -> (dict, the
    module class, or a dict of such targets one level down)) from the
    nested ``overrides``; a name or keyword that is not there raises."""
    for name, value in overrides.items():
        if name not in targets:
            raise KeyError(f"unknown module override {name!r}; known: "
                           f"{sorted(targets)}")
        kwargs, cls = targets[name]
        if isinstance(cls, dict):
            _apply_overrides(value, {k: (kwargs[k], c)
                                     for k, c in cls.items()})
            continue
        known = inspect.signature(cls.__init__).parameters
        for key in value:
            if key not in known or key == "self":
                raise KeyError(f"{name}: {cls.__name__} has no keyword "
                               f"{key!r}")
        kwargs.update(value)


def init_random_(model: nn.Module, generator: torch.Generator):
    """Seeded random weights: fan-in scaled normals for conv / linear
    weights (small ones for the DCN offset convs, so offsets are fractional
    and the bilinear paths run), zero biases, unit LayerNorm / BN scales,
    random BN statistics, N(0, 1) anchors; the v1 lifter's bank and the
    head's ``empty_scalar`` get the reference's own init."""
    own_init = ()
    if isinstance(getattr(model, "lifter", None), GaussianLifter):
        model.lifter.reset_parameters(generator)
        own_init = ("lifter.", "head.empty_scalar")
    # of the buffers only the BN statistics are weights: the others
    # (fix_scale, unit_xyz, the empty Gaussian) are the config's constants
    stats = [(n, t) for n, t in model.named_buffers()
             if n.rsplit(".", 1)[-1] in ("running_mean", "running_var")]
    for name, t in list(model.named_parameters()) + stats:
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith(own_init):
            continue
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
                    seed: Optional[int] = 0,
                    module_overrides=None) -> BEVSegmentor:
    """Build the segmentor on ``device`` (CUDA unless the caller asks for
    the CPU), with seeded random weights unless ``seed`` is None;
    ``module_overrides`` as :class:`BEVSegmentor` takes them."""
    dev = resolve_device(device)
    model = BEVSegmentor(cfg, module_overrides)
    if seed is not None:
        with torch.no_grad():
            init_random_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
