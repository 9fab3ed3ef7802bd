"""Focal and dice losses (gaussianformer_tpu/losses/focal.py, reference
loss/occupancy_loss.py:270-571): mmcv's sigmoid and softmax focal losses,
the reference's CustomFocalLoss, which weights each voxel by its
normalised BEV distance (c = ||xy|| / max + 1), and a multi-class dice
loss. No shipped config turns them on (``OccupancyLossCfg.use_focal`` /
``use_dice``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(logits, labels, *, gamma: float = 2.0,
                       alpha: float = 0.25, class_weights=None,
                       sample_weights=None):
    """Per-sample sigmoid focal loss summed over classes, mean over
    samples. logits [N, C]; labels [N] int, where C means background (no
    class is positive)."""
    c = logits.shape[1]
    onehot = (labels[:, None] == torch.arange(c, device=labels.device)
              ).to(logits.dtype)
    p = torch.sigmoid(logits)
    pt = (1.0 - p) * onehot + p * (1.0 - onehot)
    focal = (alpha * onehot + (1.0 - alpha) * (1.0 - onehot)) * pt ** gamma
    bce = -(onehot * F.logsigmoid(logits)
            + (1.0 - onehot) * F.logsigmoid(-logits))
    loss = bce * focal
    if class_weights is not None:
        loss = loss * class_weights[None, :]
    loss = loss.sum(-1)
    if sample_weights is not None:
        loss = loss * sample_weights
    return loss.mean()


def softmax_focal_loss(logits, labels, *, gamma: float = 2.0,
                       alpha: float = 0.25, class_weights=None,
                       sample_weights=None):
    """Softmax focal loss, mean over samples."""
    logp = torch.log_softmax(logits, dim=-1)
    pick_logp = torch.gather(logp, -1, labels[..., None])[..., 0]
    pt = torch.exp(pick_logp)
    loss = -alpha * (1.0 - pt) ** gamma * pick_logp
    if class_weights is not None:
        loss = loss * class_weights[labels]
    if sample_weights is not None:
        loss = loss * sample_weights
    return loss.mean()


def distance_weighted_focal_loss(logits, labels, sampled_xyz, *,
                                 use_sigmoid: bool = True,
                                 gamma: float = 2.0, alpha: float = 0.25,
                                 class_weights=None):
    """CustomFocalLoss: logits [B, N, C], labels [B, N], voxel centres
    [B, N, 3]; a voxel's weight grows from 1 at the ego to 2 at the
    farthest voxel in BEV. Every voxel counts: no mask."""
    dist = torch.linalg.vector_norm(sampled_xyz[..., :2], dim=-1)
    c = dist / dist.max().clamp_min(1e-6) + 1.0
    b, n = labels.shape
    fn = sigmoid_focal_loss if use_sigmoid else softmax_focal_loss
    return fn(logits.reshape(b * n, -1), labels.reshape(b * n).long(),
              gamma=gamma, alpha=alpha, class_weights=class_weights,
              sample_weights=c.reshape(b * n))


def dice_loss(probs, labels, *, class_weights=None, eps: float = 1e-5,
              valid=None):
    """Multi-class dice loss over [N, C] probabilities: 1 - 2 |P n T| /
    (|P| + |T|) per class, averaged (weighted by ``class_weights``);
    voxels outside ``valid`` count nowhere."""
    c = probs.shape[1]
    onehot = (labels[:, None] == torch.arange(c, device=labels.device)
              ).to(probs.dtype)
    if valid is not None:
        v = valid.to(probs.dtype)[:, None]
        probs = probs * v
        onehot = onehot * v
    inter = (probs * onehot).sum(0)
    denom = probs.sum(0) + onehot.sum(0)
    dice = 1.0 - 2.0 * inter / (denom + eps)
    if class_weights is not None:
        return (dice * class_weights).sum() / class_weights.sum()
    return dice.mean()
