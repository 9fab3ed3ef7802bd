"""Binary and distribution losses (gaussianformer_tpu/losses/bce.py,
reference loss/bce_loss.py): BCE of the prob head's occupancy
``bin_logits``, the density hinge, the depth CE of ``OccDepthLoss`` and
``PixelDistributionLoss``. Only the last is in a shipped config's loss."""
from __future__ import annotations

import torch


def binary_cross_entropy_loss(bin_logits_list, sampled_label, occ_mask,
                              empty_label: int = 17,
                              class_weights=(1.0, 1.0)):
    """BCE of each layer's occupancy probability (``bin_logits`` are
    probabilities, despite the name) against not-``empty_label``, weighted
    by (empty, occupied) ``class_weights`` normalised to sum to 2, over the
    masked voxels; summed over the layers (reference
    BinaryCrossEntropyLoss)."""
    w = torch.tensor(class_weights, dtype=torch.float32,
                     device=sampled_label.device)
    w = 2.0 * w / w.abs().sum()
    target = (sampled_label != empty_label).float()
    sample_w = torch.where(target > 0, w[1], w[0])
    validf = occ_mask.float()
    tot = 0.0
    for probs in bin_logits_list:
        p = probs.clamp(1e-6, 1.0 - 1e-6)
        bce = -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))
        tot = tot + (bce * sample_w * validf).sum() \
            / validf.sum().clamp_min(1.0)
    return tot


def occ_depth_loss(pixel_logits, pixel_gt):
    """CE of the per-ray depth logits against the ray's first occupied
    depth bin, the argmax of the occupancy ground truth (reference
    OccDepthLoss)."""
    depth_gt = pixel_gt.float().argmax(-1)
    logp = torch.log_softmax(pixel_logits, dim=-1)
    return -torch.gather(logp, -1, depth_gt[..., None]).mean()


def density_loss(density_list, sampled_label, occ_mask,
                 empty_label: int = 17, thresh: float = 0.0):
    """Hinge pushing the splat's density above ``thresh`` at occupied
    voxels and below it at empty ones, over the masked voxels; summed over
    the layers (reference config/prob/nuscenes_gs6400.py:66-69)."""
    occupied = sampled_label != empty_label
    validf = occ_mask.float()
    tot = 0.0
    for density in density_list:
        # torch.maximum, as jnp.maximum, halves the gradient at a tie: a
        # voxel no Gaussian reaches has a density of exactly 0
        zero = torch.zeros_like(density)
        hinge = torch.where(occupied, torch.maximum(thresh - density, zero),
                            torch.maximum(density - thresh, zero))
        tot = tot + (hinge * validf).sum() / validf.sum().clamp_min(1.0)
    return tot


def pixel_distribution_loss(pixel_logits, pixel_gt,
                            use_sigmoid: bool = False):
    """Mean BCE of softmax(logits), or with ``use_sigmoid`` of their
    sigmoid, against the per-ray occupancy ground truth; probabilities
    clamped to [1e-7, 1 - 1e-7]."""
    p = (torch.sigmoid(pixel_logits) if use_sigmoid
         else torch.softmax(pixel_logits, dim=-1)).clamp(1e-7, 1.0 - 1e-7)
    t = pixel_gt.float()
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)).mean()
