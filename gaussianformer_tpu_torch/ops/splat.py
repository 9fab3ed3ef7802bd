"""Gaussian -> voxel splat (gaussianformer_tpu/ops/splat.py) in its two
variants, differentiable in the means, opacities, semantics and inverse
covariances.

Per point x and Gaussian g whose integer AABB holds x's voxel
(getRect semantics of the reference's localagg and localagg_prob):
    e_g(x)  = exp(-1/2 (mu_g - x)^T A_g (mu_g - x))
prob (GaussianFormer-2, :func:`splat_prob`):
    w_g     = (2 pi)^-3/2 sqrt(det A_g) opa_g
    logits  = sum_g sem_g w_g e_g / sum_g w_g e_g   (uniform fallback)
    bin     = 1 - prod_g (1 - e_g);  density = sum_g e_g
additive (the v1 models, :func:`splat_additive`):
    logits  = sum_g sem_g opa_g e_g
The per-point loop is kernel K4 and its backward kernel K7
(kernels/splat.py); this module packs the Gaussian tables, post-processes
the accumulators and prepares the backward's per-voxel cotangents, as the
JAX package's ``_splat_bwd_pallas_batched`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..kernels.splat import (NORM_3D, postprocess_prob, splat_accumulate,
                             splat_backward)


@dataclasses.dataclass(frozen=True)
class SplatGridSpec:
    """Static voxel-grid geometry (reference ``cuda_kwargs``)."""
    H: int = 200
    W: int = 200
    D: int = 16
    pc_min: Tuple[float, float, float] = (-50.0, -50.0, -5.0)
    grid_size: float = 0.5
    scale_multiplier: float = 4.0
    radii_min: int = 1

    @property
    def num_voxels(self) -> int:
        return self.H * self.W * self.D

    def voxelize(self, xyz):
        """World coords -> int64 voxel coords (floor, clipped in-grid)."""
        pc_min = torch.tensor(self.pc_min, dtype=xyz.dtype,
                              device=xyz.device)
        hi = torch.tensor([self.H - 1, self.W - 1, self.D - 1],
                          device=xyz.device)
        idx = torch.floor((xyz - pc_min) / self.grid_size).long()
        return torch.minimum(idx.clamp_min(0), hi)

    def radii(self, scales):
        """Isotropic voxel-space AABB radii (localagg_prob) from the
        Gaussians' largest scale."""
        r = torch.ceil(scales.detach().amax(-1, keepdim=True)
                       * self.scale_multiplier / self.grid_size)
        return r.expand(scales.shape).long().clamp_min(self.radii_min)


def det_compact(cov6):
    """Determinant of a symmetric 3x3 given as [xx, yy, zz, xy, yz, xz]."""
    xx, yy, zz, xy, yz, xz = cov6.unbind(-1)
    return (xx * yy * zz + 2.0 * xy * yz * xz
            - xx * yz * yz - yy * xz * xz - zz * xy * xy)


def pack_gaussians(means, opacities, semantics, scales, cov_inv6,
                   grid: SplatGridSpec, variant: str = "prob"):
    """One batch element's Gaussian tables for kernel K4 (the packing math
    of the JAX package's ``_pack_gaussians``): gdata [P, 9], box [P, 6]
    int32 (AABB lo, hi in voxels), sem_aug [P, C + 2] = [sem w, w, 1] with
    w = (2 pi)^-1.5 sqrt(det A) opa (prob) or w = opa (additive)."""
    mu_int = grid.voxelize(means.detach())
    rad = grid.radii(scales)
    box = torch.cat([mu_int - rad, mu_int + rad], dim=-1).to(torch.int32)
    gdata = torch.cat([means, cov_inv6], dim=-1).float().contiguous()
    w = opacities
    if variant == "prob":
        w = NORM_3D * torch.sqrt(det_compact(cov_inv6).clamp_min(1e-30)) * w
    sem_aug = torch.cat([semantics * w[:, None], w[:, None],
                         torch.ones_like(w[:, None])], dim=-1)
    return gdata, box.contiguous(), sem_aug.float().contiguous()


class SplatProbFunction(torch.autograd.Function):
    """One batch element's prob splat: K4 forward, which saves the logits,
    the probability sums and ``one_minus`` (as ``f_fwd`` does); K7
    backward on the per-voxel cotangents prepared here. Returns (logits
    [N, C], bin_logits [N], density [N], labels [N] int32)."""

    @staticmethod
    def forward(ctx, means, opacities, semantics, cov_inv6, points, scales,
                grid):
        gdata, box, sem_aug = pack_gaussians(means, opacities, semantics,
                                             scales, cov_inv6, grid)
        acc, one_minus, labels = splat_accumulate(points, gdata, box,
                                                  sem_aug, grid)
        logits, bins, density = postprocess_prob(acc, one_minus)
        c = semantics.shape[-1]
        ctx.grid = grid
        ctx.save_for_backward(points, gdata, opacities, semantics, box,
                              logits, acc[:, c], one_minus)
        ctx.mark_non_differentiable(labels)
        return logits, bins, density, labels

    @staticmethod
    def backward(ctx, g_logits, g_bin, g_density, _g_labels):
        (points, gdata, opa, sem, box, logits, prob_sum,
         one_minus) = ctx.saved_tensors
        covered = prob_sum > 1e-9
        inv_ps = torch.where(covered, 1.0 / torch.where(
            covered, prob_sum, torch.ones_like(prob_sum)),
            torch.zeros_like(prob_sum))
        gl = (g_logits * inv_ps[:, None]).contiguous()
        scalars = torch.stack([(gl * logits).sum(-1), g_bin * one_minus,
                               g_density], -1).contiguous()
        gmu, gopa, gsem, gcov = splat_backward(
            points, gdata, opa.float().contiguous(),
            sem.float().contiguous(), box, gl, scalars, ctx.grid)
        return gmu, gopa, gsem, gcov, None, None, None


class SplatAdditiveFunction(torch.autograd.Function):
    """One batch element's additive splat: K4 forward, which saves only
    its inputs (the JAX package's ``f_fwd`` saves no residuals for this
    variant); K7 backward on the logits cotangent as it comes. Returns
    (logits [N, C], labels [N] int32)."""

    @staticmethod
    def forward(ctx, means, opacities, semantics, cov_inv6, points, scales,
                grid):
        gdata, box, sem_aug = pack_gaussians(
            means, opacities, semantics, scales, cov_inv6, grid, "additive")
        acc, _, labels = splat_accumulate(points, gdata, box, sem_aug, grid,
                                          "additive")
        ctx.grid = grid
        ctx.save_for_backward(points, gdata, opacities, semantics, box)
        ctx.mark_non_differentiable(labels)
        return acc[:, :semantics.shape[-1]].contiguous(), labels

    @staticmethod
    def backward(ctx, g_logits, _g_labels):
        points, gdata, opa, sem, box = ctx.saved_tensors
        gmu, gopa, gsem, gcov = splat_backward(
            points, gdata, opa.float().contiguous(),
            sem.float().contiguous(), box, g_logits.float().contiguous(),
            None, ctx.grid, "additive")
        return gmu, gopa, gsem, gcov, None, None, None


def _splat_batched(function, n_out, points, means, opacities, semantics,
                   scales, cov_inv6, grid):
    outs = [function.apply(
        means[bi], opacities[bi], semantics[bi], cov_inv6[bi],
        points[bi].float().contiguous(), scales[bi], grid)
        for bi in range(points.shape[0])]
    return tuple(torch.stack([o[k] for o in outs]) for k in range(n_out))


def splat_additive(points, means, opacities, semantics, scales, cov_inv6,
                   grid: SplatGridSpec):
    """Batched additive splat with final-occ labels, differentiable in
    ``means``, ``opacities``, ``semantics`` and ``cov_inv6``. Shapes as
    :func:`splat_prob`. Returns (logits [B, N, C], labels [B, N] int32):
    the raw sums and their first-index argmax."""
    return _splat_batched(SplatAdditiveFunction, 2, points, means,
                          opacities, semantics, scales, cov_inv6, grid)


def splat_prob(points, means, opacities, semantics, scales, cov_inv6,
               grid: SplatGridSpec):
    """Batched prob splat with final-occ labels, differentiable in
    ``means``, ``opacities``, ``semantics`` and ``cov_inv6``.

    points [B, N, 3]; means [B, P, 3]; opacities [B, P]; semantics
    [B, P, C]; scales [B, P, 3]; cov_inv6 [B, P, 6]. Returns (logits
    [B, N, C], bin_logits [B, N], density [B, N], labels [B, N] int32)."""
    return _splat_batched(SplatProbFunction, 4, points, means, opacities,
                          semantics, scales, cov_inv6, grid)
