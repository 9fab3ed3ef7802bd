"""Anchor space <-> world space (gaussianformer_tpu/ops/coords.py)."""
import torch

from .safe_ops import safe_inverse_sigmoid, safe_sigmoid


def _bounds(pc_range, like):
    lo = torch.tensor(pc_range[:3], dtype=like.dtype, device=like.device)
    hi = torch.tensor(pc_range[3:6], dtype=like.dtype, device=like.device)
    return lo, hi


def cartesian(anchor_xyz, pc_range):
    """Anchor-space xyz logits -> world-space xyz."""
    lo, hi = _bounds(pc_range, anchor_xyz)
    return safe_sigmoid(anchor_xyz) * (hi - lo) + lo


def reverse_cartesian(xyz, pc_range):
    """World-space xyz -> anchor-space logits."""
    lo, hi = _bounds(pc_range, xyz)
    return safe_inverse_sigmoid((xyz - lo) / (hi - lo))
