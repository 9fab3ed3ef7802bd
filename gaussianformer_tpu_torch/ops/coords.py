"""Anchor space <-> world space (gaussianformer_tpu/ops/coords.py): the
cartesian pair and the polar anchors of ``spherical_to_cartesian``;
``world_xyz`` picks between them as the modules' ``xyz_coordinate``
says."""
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


def spherical_to_cartesian(anchor, pc_range, phi_activation: str = "loop"):
    """Polar anchor (r, theta, phi logits in ``anchor[..., :3]``) -> world
    xyz: each angle or radius mapped into its ``pc_range`` span, r and
    theta through the sigmoid, phi through the sigmoid or, with "loop",
    wrapped into [0, 1) by the floor remainder."""
    if phi_activation == "sigmoid":
        unit = safe_sigmoid(anchor[..., :3])
    elif phi_activation == "loop":
        unit = torch.cat([safe_sigmoid(anchor[..., :2]),
                          torch.remainder(anchor[..., 2:3], 1.0)], dim=-1)
    else:
        raise NotImplementedError(phi_activation)
    r, theta, phi = (unit[..., i] * (pc_range[i + 3] - pc_range[i])
                     + pc_range[i] for i in range(3))
    return torch.stack([r * torch.sin(theta) * torch.cos(phi),
                        r * torch.sin(theta) * torch.sin(phi),
                        r * torch.cos(theta)], dim=-1)


def world_xyz(anchor, pc_range, xyz_coordinate: str = "cartesian",
               phi_activation: str = "sigmoid"):
    """An anchor's world xyz: :func:`cartesian` of its first three
    entries, or with ``xyz_coordinate`` "polar" :func:`spherical_to_cartesian`
    with ``phi_activation``."""
    if xyz_coordinate == "polar":
        return spherical_to_cartesian(anchor, pc_range, phi_activation)
    return cartesian(anchor[..., :3], pc_range)
