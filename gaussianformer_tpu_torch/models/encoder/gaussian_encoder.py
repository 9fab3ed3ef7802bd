"""Iterative Gaussian refinement decoder driven by ``operation_order``
(gaussianformer_tpu/models/encoder/gaussian_encoder.py): each entry is one
of identity, add, norm, ffn, deformable, spconv, refine; after every
refine but the last the anchor is re-embedded. ``layers[i]`` holds the
module of entry i (reference names). The GaussianFormer-2 order wraps each
op in identity / add; the v1 order has neither (its FFN adds its own
input) and refines with ``refine_version`` 1."""
from __future__ import annotations

from typing import Sequence

from torch import nn

from ...utils.profiling import span
from .modules import (AsymmetricFFN, DeformableFeatureAggregation,
                      SparseConv3DModule, SparseGaussian3DEncoder,
                      SparseGaussian3DRefinementModule,
                      SparseGaussian3DRefinementModuleV2)


class GaussianOccEncoder(nn.Module):
    def __init__(self, operation_order: Sequence[str], embed_dims: int = 128,
                 semantic_dim: int = 17, ffn_cfg=None, deformable_cfg=None,
                 refine_cfg=None, spconv_cfg=None, include_opa: bool = True,
                 refine_version: int = 2):
        super().__init__()
        self.operation_order = tuple(operation_order)
        self.anchor_encoder = SparseGaussian3DEncoder(
            embed_dims, semantic_dim, include_opa)
        refine_cls = (SparseGaussian3DRefinementModuleV2
                      if refine_version == 2
                      else SparseGaussian3DRefinementModule)
        builders = {
            "identity": nn.Identity, "add": nn.Identity,
            "norm": lambda: nn.LayerNorm(embed_dims),
            "ffn": lambda: AsymmetricFFN(**ffn_cfg),
            "deformable": lambda: DeformableFeatureAggregation(
                **deformable_cfg),
            "spconv": lambda: SparseConv3DModule(**spconv_cfg),
            "refine": lambda: refine_cls(**refine_cfg),
        }
        self.layers = nn.ModuleList(builders[op]()
                                    for op in self.operation_order)

    def forward(self, representation, rep_features, ms_img_feats,
                projection_mat, image_wh, training: bool = False,
                generator=None):
        """ms_img_feats: per level [B, cams, H_l, W_l, C] (NHWC).
        ``training`` turns dropout on, drawn from ``generator``."""
        anchor = representation
        instance_feature = rep_features
        anchor_embed = self.anchor_encoder(anchor)
        predictions = []
        identity = None
        last = len(self.operation_order) - 1
        for i, (op, layer) in enumerate(zip(self.operation_order,
                                            self.layers)):
            if op == "identity":
                identity = instance_feature
            elif op == "add":
                instance_feature = instance_feature + identity
            elif op == "norm":
                instance_feature = layer(instance_feature)
            elif op == "ffn":
                instance_feature = layer(instance_feature, training,
                                         generator)
            elif op == "deformable":
                with span("encoder/deformable"):
                    instance_feature = layer(instance_feature, anchor,
                                             anchor_embed, ms_img_feats,
                                             projection_mat, image_wh,
                                             training, generator)
            elif op == "spconv":
                with span("encoder/spconv"):
                    instance_feature = layer(instance_feature, anchor)
            else:  # refine
                anchor, gaussian = layer(instance_feature, anchor,
                                         anchor_embed)
                predictions.append(gaussian)
                if i != last:
                    anchor_embed = self.anchor_encoder(anchor)
        return {"representation": predictions, "final_anchor": anchor,
                "features": instance_feature}
