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
(kernels/splat.py); this module packs the Gaussian tables, bins them by
voxel tile once per splat on the card (the forward's bins serve the
backward), post-processes the accumulators and prepares the backward's
per-voxel cotangents, as the JAX package's ``_splat_bwd_pallas_batched``
does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..device import constant
from ..kernels.splat import (NORM_3D, bin_gaussians_cuda, entries_bound,
                             postprocess_prob, splat_accumulate,
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
        pc_min = constant(self.pc_min, xyz.dtype, xyz.device)
        hi = constant((self.H - 1, self.W - 1, self.D - 1), torch.int64,
                      xyz.device)
        idx = torch.floor((xyz - pc_min) / self.grid_size).long()
        return torch.minimum(idx.clamp_min(0), hi)

    def radii(self, scales, per_axis: bool = False):
        """Voxel-space AABB radii [P, 3] from the (detached) scales:
        ceil(scale * scale_multiplier / grid_size) of each axis
        (``per_axis``, the reference's localagg_prob_fast) or of the
        largest scale on all three (localagg_prob), at least
        ``radii_min``."""
        s = scales.detach()
        if not per_axis:
            s = s.amax(-1, keepdim=True).expand(scales.shape)
        r = torch.ceil(s * self.scale_multiplier / self.grid_size)
        return r.long().clamp_min(self.radii_min)

    def radius_bound(self, max_scale: float) -> int:
        """A bound on :meth:`radii` for scales up to ``max_scale`` (with a
        margin for the fp32 rounding of the scales and of the product)."""
        r = math.ceil(max_scale * self.scale_multiplier / self.grid_size
                      * (1.0 + 1e-5))
        return max(r, self.radii_min)


def det_compact(cov6):
    """Determinant of a symmetric 3x3 given as [xx, yy, zz, xy, yz, xz]."""
    xx, yy, zz, xy, yz, xz = cov6.unbind(-1)
    return (xx * yy * zz + 2.0 * xy * yz * xz
            - xx * yz * yz - yy * xz * xz - zz * xy * xy)


def pack_gaussians(means, opacities, semantics, scales, cov_inv6,
                   grid: SplatGridSpec, variant: str = "prob",
                   per_axis: bool = False):
    """One batch element's Gaussian tables for kernel K4 (the packing math
    of the JAX package's ``_pack_gaussians``): gdata [P, 9], box [P, 6]
    int32 (AABB lo, hi in voxels, with isotropic or ``per_axis`` radii),
    sem_aug [P, C + 2] = [sem w, w, 1] with w = (2 pi)^-1.5 sqrt(det A) opa
    (prob) or w = opa (additive)."""
    mu_int = grid.voxelize(means.detach())
    rad = grid.radii(scales, per_axis)
    box = torch.cat([mu_int - rad, mu_int + rad], dim=-1).to(torch.int32)
    gdata = torch.cat([means, cov_inv6], dim=-1).float().contiguous()
    w = opacities
    if variant == "prob":
        w = NORM_3D * torch.sqrt(det_compact(cov_inv6).clamp_min(1e-30)) * w
    sem_aug = torch.cat([semantics * w[:, None], w[:, None],
                         torch.ones_like(w[:, None])], dim=-1)
    return gdata, box.contiguous(), sem_aug.float().contiguous()


def _bins(points, box, grid, max_entries):
    """The splat's tile bins for K4 and K7 on the card, sized by
    ``max_entries``; None on the CPU, where the plain versions take no
    bins."""
    if not points.is_cuda:
        return None
    return bin_gaussians_cuda(points, box, grid, max_entries)


class SplatProbFunction(torch.autograd.Function):
    """One batch element's prob splat: K4 forward, which saves the logits,
    the probability sums and ``one_minus`` (as ``f_fwd`` does) and, on the
    card, its tile bins; K7 backward on the per-voxel cotangents prepared
    here. ``labels`` is the
    keyword dict of K4's label epilogue (``label_mode``, ``thresh``,
    ``empty_label``). Returns (logits [N, C], bin_logits [N], density [N],
    labels [N] int32)."""

    @staticmethod
    def forward(ctx, means, opacities, semantics, cov_inv6, points, scales,
                grid, per_axis, labels, max_entries):
        gdata, box, sem_aug = pack_gaussians(means, opacities, semantics,
                                             scales, cov_inv6, grid,
                                             per_axis=per_axis)
        ctx.bins = _bins(points, box, grid, max_entries)
        acc, one_minus, labels = splat_accumulate(
            points, gdata, box, sem_aug, grid, bins=ctx.bins, **labels)
        logits, bin_logits, density = postprocess_prob(acc, one_minus)
        c = semantics.shape[-1]
        ctx.grid = grid
        ctx.save_for_backward(points, gdata, opacities, semantics, box,
                              logits, acc[:, c], one_minus)
        ctx.mark_non_differentiable(labels)
        return logits, bin_logits, density, labels

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
            sem.float().contiguous(), box, gl, scalars, ctx.grid,
            bins=ctx.bins)
        return gmu, gopa, gsem, gcov, None, None, None, None, None, None


class SplatAdditiveFunction(torch.autograd.Function):
    """One batch element's additive splat: K4 forward, which saves only
    its inputs (the JAX package's ``f_fwd`` saves no residuals for this
    variant) and, on the card, its tile bins; K7 backward on the logits
    cotangent as it comes. Returns
    (logits [N, C], labels [N] int32)."""

    @staticmethod
    def forward(ctx, means, opacities, semantics, cov_inv6, points, scales,
                grid, per_axis, max_entries):
        gdata, box, sem_aug = pack_gaussians(
            means, opacities, semantics, scales, cov_inv6, grid, "additive",
            per_axis)
        ctx.bins = _bins(points, box, grid, max_entries)
        acc, _, labels = splat_accumulate(points, gdata, box, sem_aug, grid,
                                          "additive", bins=ctx.bins)
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
            None, ctx.grid, "additive", bins=ctx.bins)
        return gmu, gopa, gsem, gcov, None, None, None, None, None


def _splat_batched(function, n_out, points, means, opacities, semantics,
                   scales, cov_inv6, grid, bound, *extra):
    """``bound``: (the boxes' radius bound or None, the Gaussians at the
    end whose box may be the whole grid), which sizes the card's bins."""
    max_entries = entries_bound(means.shape[1], grid, *bound)
    outs = [function.apply(
        means[bi], opacities[bi], semantics[bi], cov_inv6[bi],
        points[bi].float().contiguous(), scales[bi], grid, *extra,
        max_entries)
        for bi in range(points.shape[0])]
    return tuple(torch.stack([o[k] for o in outs]) for k in range(n_out))


def splat_additive(points, means, opacities, semantics, scales, cov_inv6,
                   grid: SplatGridSpec, per_axis: bool = False,
                   max_radius=None, whole: int = 0):
    """Batched additive splat with final-occ labels, differentiable in
    ``means``, ``opacities``, ``semantics`` and ``cov_inv6``. Shapes,
    ``max_radius`` and ``whole`` as :func:`splat_prob`. Returns (logits
    [B, N, C], labels [B, N] int32): the raw sums and their first-index
    argmax."""
    return _splat_batched(SplatAdditiveFunction, 2, points, means,
                          opacities, semantics, scales, cov_inv6, grid,
                          (max_radius, whole), per_axis)


def splat_prob(points, means, opacities, semantics, scales, cov_inv6,
               grid: SplatGridSpec, per_axis: bool = False,
               label_mode: str = "combine", thresh: float = 0.5,
               empty_label: int = 17, max_radius=None, whole: int = 0):
    """Batched prob splat with final-occ labels, differentiable in
    ``means``, ``opacities``, ``semantics`` and ``cov_inv6``.

    points [B, N, 3]; means [B, P, 3]; opacities [B, P]; semantics
    [B, P, C]; scales [B, P, 3]; cov_inv6 [B, P, 6]. ``per_axis``: box
    radii per axis; ``label_mode``, ``thresh``, ``empty_label``: K4's
    label epilogue (``kernels.splat.labels_from_acc``); ``max_radius``: a
    bound on the boxes' radii (``SplatGridSpec.radius_bound``) but for the
    last ``whole`` Gaussians, which sizes the card's bins (None: every
    box may cover the grid). Returns (logits [B, N, C], bin_logits [B, N],
    density [B, N], labels [B, N] int32)."""
    labels = dict(label_mode=label_mode, thresh=thresh,
                  empty_label=empty_label)
    return _splat_batched(SplatProbFunction, 4, points, means, opacities,
                          semantics, scales, cov_inv6, grid,
                          (max_radius, whole), per_axis, labels)
