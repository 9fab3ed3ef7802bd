"""Pixel distribution loss (gaussianformer_tpu/losses/bce.py, reference
PixelDistributionLoss)."""
from __future__ import annotations

import torch


def pixel_distribution_loss(pixel_logits, pixel_gt):
    """Mean BCE of softmax(logits) against the per-ray occupancy ground
    truth; probabilities clamped to [1e-7, 1 - 1e-7]."""
    p = torch.softmax(pixel_logits, dim=-1).clamp(1e-7, 1.0 - 1e-7)
    t = pixel_gt.float()
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)).mean()
