"""The Gaussian head in plain PyTorch: each supervised layer's Gaussians
splatted to the query points, densely (every point against every Gaussian
whose box can hold it), differentiable by autograd.

For a point x and a Gaussian g whose integer box holds x's voxel (box:
the mean's voxel plus or minus ceil(s * multiplier / voxel) on every
axis, s the largest scale, at least 1):
    e = exp(min(-1/2 (mu - x)^T A (mu - x), 30)),  A the inverse covariance
prob:     w = (2 pi)^-3/2 sqrt(det A) opacity; the semantics are
          sum sem w e / sum w e (uniform over the first C - 1 classes where
          sum w e <= 1e-9), the occupancy 1 - prod (1 - e), and the output
          [sem * occupancy, 1 - occupancy] with its argmax as the label
additive: sum sem opacity e, with its argmax as the label.
Softmaxed semantics get a zero empty column (prob).

With ``with_empty`` (GaussianFormer NonEmpty, ``prepare_gaussian_args``)
the learnt Gaussians' semantics get a zero empty column instead, and one
more Gaussian is appended: mean ``empty_mean``, scales ``empty_scale``,
the identity rotation, opacity 1, and as semantics the one-hot of
``empty_label`` times the trained scalar ``empty_scalar``. Its box, by the
rule above clamped to the grid, is the whole grid."""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .precision import REFERENCE, Precision

NORM = (2.0 * math.pi) ** -1.5
CHUNK = 8192


def inverse_covariance(scales, rotations):
    """[..., 6] = inverse of (S R)^T (S R) as [xx, yy, zz, xy, yz, xz]."""
    q = rotations / rotations.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)
    m = scales[..., :, None] * r
    inv = torch.linalg.inv(m.transpose(-1, -2) @ m)
    return torch.stack([inv[..., 0, 0], inv[..., 1, 1], inv[..., 2, 2],
                        inv[..., 0, 1], inv[..., 1, 2], inv[..., 0, 2]], -1)


def voxel_of(xyz, grid):
    lo = torch.tensor(grid["pc_min"], device=xyz.device, dtype=xyz.dtype)
    top = torch.tensor([grid["H"] - 1, grid["W"] - 1, grid["D"] - 1],
                       device=xyz.device)
    v = torch.floor((xyz - lo) / grid["grid_size"]).long()
    return torch.minimum(v.clamp_min(0), top)


def _chunk(pts, vox, mu, a6, table, lo, hi, prob: bool, prec: Precision):
    """(sum of table * e [n, T], log prod (1 - e) [n]) of one chunk of
    points against the Gaussians given."""
    d = prec.elementwise(mu)[None] - prec.elementwise(pts)[:, None]
    # each axis taken out once: an axis selected at each use would cost the
    # backward a zero-filled [n, P, 3] gradient for each use
    d0, d1, d2 = d.unbind(-1)
    a = prec.elementwise(a6)
    q = (a[:, 0] * d0 ** 2 + a[:, 1] * d1 ** 2 + a[:, 2] * d2 ** 2
         + 2.0 * (a[:, 3] * d0 * d1 + a[:, 4] * d1 * d2 + a[:, 5] * d0 * d2))
    inside = ((vox[:, None] >= lo[None]) & (vox[:, None] <= hi[None])).all(-1)
    e = torch.exp(torch.clamp_max(-0.5 * q, 30.0)) * inside
    acc = (e @ prec.elementwise(table)).float()
    if not prob:
        return acc, None
    return acc, torch.log1p(-e.float().clamp_max(1.0 - 1e-7)).sum(1)


def splat(points, means, opacities, semantics, scales, cov_inv6, grid,
          prob: bool, prec: Precision = REFERENCE):
    """One batch element. points [N, 3]; means [P, 3]; opacities [P];
    semantics [P, C]; scales [P, 3]; cov_inv6 [P, 6]. Returns (sums
    [N, C + 2] of (sem w e, w e, e), log prod (1 - e) [N] or None)."""
    vox = voxel_of(points, grid)
    mu_v = voxel_of(means.detach(), grid)
    r = torch.ceil(scales.detach().amax(-1, keepdim=True)
                   * grid["scale_multiplier"] / grid["grid_size"]
                   ).long().clamp_min(1)
    top = torch.tensor([grid["H"] - 1, grid["W"] - 1, grid["D"] - 1],
                       device=means.device)
    lo, hi = (mu_v - r).clamp_min(0), torch.minimum(mu_v + r, top)
    if prob:
        xx, yy, zz, xy, yz, xz = cov_inv6.unbind(-1)
        det = (xx * yy * zz + 2 * xy * yz * xz - xx * yz * yz - yy * xz * xz
               - zz * xy * xy)
        w = NORM * torch.sqrt(det.clamp_min(1e-30)) * opacities
    else:
        w = opacities
    table = torch.cat([semantics * w[:, None], w[:, None],
                       torch.ones_like(w[:, None])], -1)
    accs, logs = [], []
    for n0 in range(0, points.shape[0], CHUNK):
        v = vox[n0:n0 + CHUNK]
        # only the Gaussians whose box reaches this chunk's x extent
        near = ((lo[:, 0] <= v[:, 0].max()) & (hi[:, 0] >= v[:, 0].min())
                ).nonzero()[:, 0]
        args = (points[n0:n0 + CHUNK], v, means[near], cov_inv6[near],
                table[near], lo[near], hi[near], prob, prec)
        if torch.is_grad_enabled():
            acc, lg = checkpoint(_chunk, *args, use_reentrant=False)
        else:
            acc, lg = _chunk(*args)
        accs.append(acc)
        logs.append(lg)
    return torch.cat(accs), (torch.cat(logs) if prob else None)


class GaussianHead(torch.nn.Module):
    def __init__(self, c, prec: Precision = REFERENCE):
        super().__init__()
        self.prec = prec
        self.grid = dict(c["grid"])
        self.prob = c["use_localaggprob"]
        self.combine = c["combine_geosem"]
        self.num_decoder = c["num_decoder"]
        self.apply_loss_type = c["apply_loss_type"]
        self.with_empty = c["with_empty"]
        if self.with_empty:
            self.empty_label = c["empty_label"]
            self.empty_mean = tuple(c["empty_mean"])
            self.empty_scale = tuple(c["empty_scale"])
            self.empty_scalar = torch.nn.Parameter(torch.full((1,), 10.0))

    def layers(self, training):
        if not training or self.apply_loss_type == "random_1":
            return [self.num_decoder - 1]
        if self.apply_loss_type == "all":
            return list(range(self.num_decoder))
        raise NotImplementedError(self.apply_loss_type)

    def forward(self, preds, occ_xyz, training=False):
        """Returns (the list of outputs of the supervised layers
        [B, N, C], the labels of the last [B, N])."""
        b = occ_xyz.shape[0]
        pts = occ_xyz.reshape(b, -1, 3)
        outs = []
        for idx in self.layers(training):
            g = preds[idx]
            sem = g.semantics
            opa = (g.opacities[..., 0] if g.opacities.shape[-1]
                   else torch.ones_like(sem[..., 0]))
            means, scales, rots = g.means, g.scales, g.rotations
            if self.with_empty:
                means, scales, rots, opa, sem = self.add_empty(
                    means, scales, rots, opa, sem)
            elif self.prob:
                sem = torch.softmax(sem, -1)
                sem = torch.cat([sem, torch.zeros_like(sem[..., :1])], -1)
            cov = inverse_covariance(scales, rots)
            out = []
            for i in range(b):
                acc, log_om = splat(pts[i], means[i], opa[i], sem[i],
                                    scales[i], cov[i], self.grid,
                                    self.prob, self.prec)
                out.append(self.finish(acc, log_om))
            outs.append(torch.stack(out))
        return outs, outs[-1].argmax(-1)

    def add_empty(self, means, scales, rots, opa, sem):
        """The Gaussians [B, P, ...] with the empty Gaussian appended
        [B, P + 1, ...], and the empty column on the semantics."""
        b, dev = means.shape[0], means.device

        def one(v):
            return torch.tensor(v, dtype=means.dtype, device=dev).expand(
                b, 1, -1)
        sem = torch.cat([sem, torch.zeros_like(sem[..., :1])], -1)
        hot = (torch.arange(sem.shape[-1], device=dev)
               == self.empty_label).to(sem.dtype)
        return (torch.cat([means, one(self.empty_mean)], 1),
                torch.cat([scales, one(self.empty_scale)], 1),
                torch.cat([rots, one((1.0, 0.0, 0.0, 0.0))], 1),
                torch.cat([opa, torch.ones_like(opa[:, :1])], 1),
                torch.cat([sem, (hot * self.empty_scalar).expand(
                    b, 1, -1)], 1))

    def finish(self, acc, log_om):
        c = acc.shape[1] - 2
        if not self.prob:
            return acc[:, :c]
        total = acc[:, c]
        covered = total > 1e-9
        uniform = torch.full((c,), 1.0 / (c - 1), device=acc.device)
        uniform[-1] = 0.0
        sem = torch.where(covered[:, None], acc[:, :c] / torch.where(
            covered, total, torch.ones_like(total))[:, None], uniform)
        occ = 1.0 - torch.exp(log_om)
        if not self.combine:
            raise NotImplementedError("the threshold label mode")
        return torch.cat([sem[:, :-1] * occ[:, None], 1.0 - occ[:, None]],
                         -1)
