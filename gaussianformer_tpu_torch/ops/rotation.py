"""Quaternion -> rotation matrix (gaussianformer_tpu/ops/rotation.py)."""
import torch


def quaternion_to_rotation_matrix(quat, eps: float = 1e-12):
    """[..., 4] (w, x, y, z), normalised internally -> [..., 3, 3]."""
    quat = quat / quat.norm(dim=-1, keepdim=True).clamp_min(eps)
    w, x, y, z = quat.unbind(-1)
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rows = [
        [ww + xx - yy - zz, 2.0 * (xy - wz), 2.0 * (xz + wy)],
        [2.0 * (xy + wz), ww - xx + yy - zz, 2.0 * (yz - wx)],
        [2.0 * (xz - wy), 2.0 * (yz + wx), ww - xx - yy + zz],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
