"""Inverse covariance of a Gaussian in the compact 6-vector layout
[ixx, iyy, izz, ixy, iyz, ixz], through the closed-form adjugate inverse of
the symmetric 3x3 (gaussianformer_tpu/ops/covariance.py)."""
import torch

from .rotation import quaternion_to_rotation_matrix


def build_covariance_inverse6(scales, rotations, eps: float = 0.0):
    """Cov = (S R)^T (S R) with S = diag(scales); returns inv(Cov) as
    [..., 6]."""
    r = quaternion_to_rotation_matrix(rotations)
    s2 = scales * scales
    # cov[i, j] = sum_k s_k^2 R[k, i] R[k, j]
    cov = torch.einsum("...k,...ki,...kj->...ij", s2, r, r)
    a, b, c = cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2]
    d, e, f = cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]
    ca = d * f - e * e
    cb = c * e - b * f
    cc = b * e - c * d
    cd = a * f - c * c
    ce = b * c - a * e
    cf = a * d - b * b
    det = a * ca + b * cb + c * cc
    inv_det = 1.0 / (det + eps)
    return torch.stack([ca, cd, cf, cb, ce, cc], dim=-1) * inv_det[..., None]
