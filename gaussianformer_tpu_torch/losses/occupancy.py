"""Occupancy loss: class-weighted CE plus Lovász
(gaussianformer_tpu/losses/occupancy.py, reference loss/occupancy_loss.py).
The prob configs' predictions are probabilities (CE without softmax); the
v1 configs' are logits (``lovasz_use_softmax``: CE with log-softmax, and
Lovász on their softmax). Masked voxels get zero weight instead of being
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
    lovasz_use_softmax: bool = False   # False: inputs are probabilities
    class_weight: Tuple[float, ...] = MANUAL_CLASS_WEIGHT


def weighted_ce_probs(probs, labels, class_weights, valid):
    """CE without softmax: weighted NLL of the clamped probabilities,
    over the summed weights of the participating voxels."""
    probs = probs.clamp(1e-6, 1.0 - 1e-6)
    picked = torch.gather(torch.log(probs), 1, labels[:, None])[:, 0]
    w = class_weights[labels] * valid
    return -(picked * w).sum() / w.sum().clamp_min(1e-12)


def weighted_ce_with_softmax(logits, labels, class_weights, valid):
    """torch.nn.CrossEntropyLoss(weight, 'mean'): weighted NLL of the
    log-softmax, over the summed weights of the participating voxels."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, 1, labels[:, None])[:, 0]
    w = class_weights[labels] * valid
    return -(picked * w).sum() / w.sum().clamp_min(1e-12)


def occupancy_loss(cfg: OccupancyLossCfg, pred_occ, sampled_label,
                   occ_mask):
    """pred_occ: list of [B, N, C] probabilities (logits with
    ``lovasz_use_softmax``); sampled_label [B, N]; occ_mask [B, N] bool.
    Mean over the listed layers of ce_weight * CE + lovasz_weight *
    Lovász."""
    class_weights = balanced_class_weights(cfg.class_weight,
                                           device=sampled_label.device)
    tot = 0.0
    for pred in pred_occ:
        b, n, c = pred.shape
        flat = pred.reshape(b * n, c)
        labels = sampled_label.reshape(b * n).long()
        vf = occ_mask.reshape(b * n).float()
        if cfg.lovasz_use_softmax:
            ce = weighted_ce_with_softmax(flat, labels, class_weights, vf)
            probs = torch.softmax(flat, dim=-1)
        else:
            ce = weighted_ce_probs(flat, labels, class_weights, vf)
            probs = flat
        loss = cfg.ce_weight * ce
        lv_valid = (vf > 0) & (labels != cfg.lovasz_ignore)
        loss = loss + cfg.lovasz_weight * lovasz_softmax(probs, labels,
                                                         lv_valid)
        tot = tot + loss
    return tot / len(pred_occ)
