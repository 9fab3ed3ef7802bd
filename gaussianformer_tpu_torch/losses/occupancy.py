"""Occupancy loss of the prob configs: class-weighted CE on probabilities
plus Lovász (gaussianformer_tpu/losses/occupancy.py, reference
loss/occupancy_loss.py). Masked voxels get zero weight instead of being
removed: the CE divides by the summed weights of the voxels that take
part, and Lovász masks them, so the means are those of the reference.
Focal, dice and the sem/geo scal terms are not ported yet."""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from ..configs.nuscenes import MANUAL_CLASS_WEIGHT
from .lovasz import lovasz_softmax


def balanced_class_weights(weights: Sequence[float],
                           device=None) -> torch.Tensor:
    """The per-class CE weights, L1-normalised to sum to the number of
    classes (reference loss/occupancy_loss.py:85-92)."""
    w = torch.tensor(weights, dtype=torch.float64)
    w = len(weights) * w / w.abs().sum()
    return w.to(device=device, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class OccupancyLossCfg:
    ce_weight: float = 10.0
    lovasz_weight: float = 1.0
    lovasz_ignore: int = 17
    class_weight: Tuple[float, ...] = MANUAL_CLASS_WEIGHT


def weighted_ce_probs(probs, labels, class_weights, valid):
    """CE without softmax: weighted NLL of the clamped probabilities,
    over the summed weights of the participating voxels."""
    probs = probs.clamp(1e-6, 1.0 - 1e-6)
    picked = torch.gather(torch.log(probs), 1, labels[:, None])[:, 0]
    w = class_weights[labels] * valid
    return -(picked * w).sum() / w.sum().clamp_min(1e-12)


def occupancy_loss(cfg: OccupancyLossCfg, pred_occ, sampled_label,
                   occ_mask):
    """pred_occ: list of [B, N, C] probabilities; sampled_label [B, N];
    occ_mask [B, N] bool. Mean over the listed layers of
    ce_weight * CE + lovasz_weight * Lovász."""
    class_weights = balanced_class_weights(cfg.class_weight,
                                           device=sampled_label.device)
    tot = 0.0
    for probs in pred_occ:
        b, n, c = probs.shape
        flat = probs.reshape(b * n, c)
        labels = sampled_label.reshape(b * n).long()
        vf = occ_mask.reshape(b * n).float()
        loss = cfg.ce_weight * weighted_ce_probs(flat, labels,
                                                 class_weights, vf)
        lv_valid = (vf > 0) & (labels != cfg.lovasz_ignore)
        loss = loss + cfg.lovasz_weight * lovasz_softmax(flat, labels,
                                                         lv_valid)
        tot = tot + loss
    return tot / len(pred_occ)
