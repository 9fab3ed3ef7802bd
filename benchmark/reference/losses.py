"""The configurations' losses in plain PyTorch: the occupancy loss
(class-weighted cross entropy, on probabilities for the prob head and on
logits for the additive one, plus Lovasz-softmax over the present
classes, the empty class ignored) and, where the configuration uses it,
the lifter's pixel distribution loss."""
from __future__ import annotations

import torch

# the configurations' manual class weights (GaussianFormer
# config/nuscenes_gs144000.py:53-56), L1-normalised to sum to 18
CLASS_WEIGHT = (
    1.01552756, 1.06897009, 1.30013094, 1.07253735, 0.94637502, 1.10087012,
    1.26960524, 1.06258364, 1.189019, 1.06217292, 1.00595144, 0.85706115,
    1.03923299, 0.90867526, 0.8936431, 0.85486129, 0.8527829, 0.5)


def class_weights(device):
    w = torch.tensor(CLASS_WEIGHT, dtype=torch.float64)
    return (len(CLASS_WEIGHT) * w / w.abs().sum()).float().to(device)


def lovasz_softmax(probs, labels, valid):
    """Mean over the classes present among the valid voxels of the Lovasz
    extension of the Jaccard loss of each class's errors."""
    n, c = probs.shape
    vf = valid.to(probs.dtype)
    fg = (labels[None] == torch.arange(c, device=probs.device)[:, None]
          ).to(probs.dtype) * vf
    err = (fg - probs.T).abs() * vf
    order = torch.sort(-err.detach(), dim=1, stable=True).indices
    err_s = torch.gather(err, 1, order)
    fg_s = torch.gather(fg, 1, order)
    vf_s = vf[order]
    gts = fg_s.sum(1, keepdim=True)
    inter = gts - fg_s.cumsum(1)
    union = gts + (vf_s - fg_s).cumsum(1)
    jac = 1.0 - inter / union.clamp_min(1e-12)
    grad = torch.cat([jac[:, :1], jac[:, 1:] - jac[:, :-1]], 1)
    losses = (err_s * grad).sum(1)
    present = gts[:, 0] > 0
    return torch.where(present, losses, torch.zeros_like(losses)).sum() \
        / present.sum().clamp_min(1)


def occupancy_loss(c, outs, labels, mask):
    """Mean over the supervised layers' outputs [B, N, C] of
    ce_weight * CE + lovasz_weight * Lovasz over the voxels of ``mask``."""
    lab = labels.reshape(-1).long()
    vf = mask.reshape(-1).float()
    w = class_weights(lab.device)[lab] * vf
    total = 0.0
    for out in outs:
        flat = out.reshape(-1, out.shape[-1])
        if c["lovasz_use_softmax"]:
            logp = torch.log_softmax(flat, -1)
            probs = torch.softmax(flat, -1)
        else:
            probs = flat
            logp = torch.log(flat.clamp(1e-6, 1.0 - 1e-6))
        ce = -(logp.gather(1, lab[:, None])[:, 0] * w).sum() \
            / w.sum().clamp_min(1e-12)
        lv = lovasz_softmax(probs, lab, (vf > 0) & (lab != 17))
        total = total + c["ce_weight"] * ce + c["lovasz_weight"] * lv
    return total / len(outs)


def pixel_distribution_loss(logits, gt):
    """Mean binary cross entropy of the softmaxed depth distribution
    against each ray's occupied bins, probabilities clamped to
    [1e-7, 1 - 1e-7]."""
    p = torch.softmax(logits, -1).clamp(1e-7, 1.0 - 1e-7)
    t = gt.float()
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)).mean()
