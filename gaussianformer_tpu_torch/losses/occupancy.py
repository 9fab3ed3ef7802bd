"""Occupancy loss (gaussianformer_tpu/losses/occupancy.py, reference
loss/occupancy_loss.py): class-weighted CE, or the distance-weighted focal
loss in its place, plus the optional sem/geo scal terms, Lovász and dice.
The prob configs' predictions are probabilities (CE without softmax); the
v1 configs' are logits (``lovasz_use_softmax``: CE with log-softmax, and
the other terms on their softmax). Masked voxels get zero weight instead
of being removed: the CE divides by the summed weights of the voxels that
take part, and Lovász masks them, so the means are those of the
reference."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import constant
from .focal import dice_loss, distance_weighted_focal_loss
from .lovasz import lovasz_softmax

# nuScenes class frequencies (reference loss/occupancy_loss.py:11-30)
NUSC_CLASS_FREQUENCIES = np.array([
    944004, 1897170, 152386, 2391677, 16957802, 724139, 189027, 2074468,
    413451, 2384460, 5916653, 175883646, 4275424, 51393615, 61411620,
    105975596, 116424404, 1892500630,
], dtype=np.float64)


def balanced_class_weights(num_classes: int,
                           manual: Optional[Sequence[float]] = None,
                           device=None) -> torch.Tensor:
    """The per-class CE weights, ``manual`` or else 1 / log(frequency),
    L1-normalised to sum to ``num_classes`` (reference
    occupancy_loss.py:85-92): a kept constant of ``device``, since a copy
    from the host each step would wait there for the forward."""
    if manual is not None:
        w = np.asarray(manual, np.float64)
    else:
        w = 1.0 / np.log(NUSC_CLASS_FREQUENCIES[:num_classes] + 0.001)
    w = num_classes * w / np.abs(w).sum()
    return constant(tuple(w.tolist()), torch.float32,
                    "cpu" if device is None else device)


@dataclasses.dataclass(frozen=True)
class OccupancyLossCfg:
    num_classes: int = 18
    empty_label: int = 17
    ce_weight: float = 10.0
    lovasz_weight: float = 1.0
    lovasz_ignore: int = 17
    lovasz_use_softmax: bool = False   # False: inputs are probabilities
    ignore_empty: bool = False
    use_lovasz: bool = True
    use_sem_geo_scal: bool = False
    sem_scal_weight: float = 1.0
    geo_scal_weight: float = 1.0
    manual_class_weight: Optional[Tuple[float, ...]] = None
    balance_cls_weight: bool = True
    use_focal: bool = False           # CustomFocalLoss replaces the CE
    focal_use_sigmoid: bool = True
    use_dice: bool = False
    dice_weight: float = 2.0


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


def _scal_bce_of_ratio(r):
    """BCE(inverse_sigmoid(r), 1) = -log(r), with the reference's clamped
    inverse-sigmoid round trip (occupancy_loss.py:157-162)."""
    return -torch.log(r.clamp(1e-5, 1.0 - 1e-5))


def sem_scal_loss(probs, labels, valid, num_classes: int):
    """Per-class precision, recall and specificity BCEs over the classes
    but the last, averaged over the classes present (reference
    occupancy_loss.py:185-239)."""
    validf = valid.to(probs.dtype)
    zero = probs.new_zeros(())
    losses, present = [], []
    for ci in range(num_classes - 1):
        p = probs[:, ci] * validf
        t = (labels == ci).to(probs.dtype) * validf
        nom = (p * t).sum()
        sum_p, sum_t = p.sum(), t.sum()
        sum_not_t = validf.sum() - sum_t
        loss = torch.where(sum_p > 0,
                           _scal_bce_of_ratio(nom / (sum_p + 1e-5)), zero)
        loss = loss + torch.where(
            sum_t > 0, _scal_bce_of_ratio(nom / (sum_t + 1e-5)), zero)
        spec = ((validf - p) * (validf - t)).sum() / (sum_not_t + 1e-5)
        loss = loss + torch.where(sum_not_t > 0, _scal_bce_of_ratio(spec),
                                  zero)
        losses.append(torch.where(sum_t > 0, loss, zero))
        present.append(sum_t > 0)
    return torch.stack(losses).sum() / torch.stack(present).sum().clamp_min(1)


def geo_scal_loss(probs, labels, valid, empty_label: int):
    """Binary geometric-completeness BCEs of occupied against empty
    (reference occupancy_loss.py:241-268)."""
    validf = valid.to(probs.dtype)
    empty_p = probs[:, empty_label]
    nonempty_p = (1.0 - empty_p) * validf
    nonempty_t = (labels != empty_label).to(probs.dtype) * validf
    intersection = (nonempty_t * nonempty_p).sum()
    precision = intersection / (nonempty_p.sum() + 1e-5)
    recall = intersection / (nonempty_t.sum() + 1e-5)
    spec = (((validf - nonempty_t) * empty_p * validf).sum()
            / ((validf - nonempty_t).sum() + 1e-5))
    return (_scal_bce_of_ratio(precision) + _scal_bce_of_ratio(recall)
            + _scal_bce_of_ratio(spec))


def occupancy_loss(cfg: OccupancyLossCfg, pred_occ, sampled_label,
                   occ_mask, sampled_xyz=None):
    """pred_occ: list of [B, N, C] probabilities (logits with
    ``lovasz_use_softmax``); sampled_label [B, N]; occ_mask [B, N] bool;
    ``sampled_xyz`` [B, N, 3], the voxel centres, only for ``use_focal``.
    Mean over the listed layers of ce_weight * CE (or the focal loss) and
    the switched-on terms."""
    device = sampled_label.device
    class_weights = balanced_class_weights(
        cfg.num_classes, cfg.manual_class_weight if cfg.balance_cls_weight
        else [1.0] * cfg.num_classes, device=device)
    valid = occ_mask
    if cfg.ignore_empty:
        valid = valid & (sampled_label != cfg.empty_label)
    labels = sampled_label.reshape(-1).long()
    vf = valid.reshape(-1).float()
    tot = 0.0
    for pred in pred_occ:
        flat = pred.reshape(-1, pred.shape[-1])
        if cfg.use_focal:
            if sampled_xyz is None:
                raise ValueError("use_focal needs sampled_xyz")
            ce = distance_weighted_focal_loss(
                pred, sampled_label, sampled_xyz,
                use_sigmoid=cfg.focal_use_sigmoid,
                class_weights=class_weights)
            probs = (torch.softmax(flat, dim=-1) if cfg.lovasz_use_softmax
                     else flat)
        elif cfg.lovasz_use_softmax:
            ce = weighted_ce_with_softmax(flat, labels, class_weights, vf)
            probs = torch.softmax(flat, dim=-1)
        else:
            ce = weighted_ce_probs(flat, labels, class_weights, vf)
            probs = flat
        loss = cfg.ce_weight * ce
        if cfg.use_sem_geo_scal:
            loss = loss + cfg.sem_scal_weight * sem_scal_loss(
                probs, labels, vf > 0, cfg.num_classes)
            loss = loss + cfg.geo_scal_weight * geo_scal_loss(
                probs, labels, vf > 0, cfg.empty_label)
        if cfg.use_lovasz:
            lv_valid = (vf > 0) & (labels != cfg.lovasz_ignore)
            loss = loss + cfg.lovasz_weight * lovasz_softmax(probs, labels,
                                                             lv_valid)
        if cfg.use_dice:
            loss = loss + cfg.dice_weight * dice_loss(
                probs, labels, class_weights=class_weights, valid=vf > 0)
        tot = tot + loss
    return tot / len(pred_occ)
