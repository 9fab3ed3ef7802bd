"""K4 / K7: Gaussian -> voxel splat with the final-occ label epilogue, and
its backward, in the two variants of the JAX package: ``prob`` (the
GaussianFormer-2 GMM superposition) and ``additive`` (the v1 models' plain
sum of opacity-weighted semantics).

Kernels: ``csrc/splat.cu`` (K4, replaces the TPU kernel
``gaussianformer_tpu/ops/pallas/splat_kernel.py::splat_raw_pallas`` with
``emit_labels``) and ``csrc/splat_bwd.cu`` (K7, replaces
``gaussianformer_tpu/ops/pallas/splat_bwd_kernel.py::splat_bwd_raw_pallas``).
Plain versions: :func:`splat_accumulate_plain`, a chunked dense form of
``gaussianformer_tpu/ops/splat.py::splat_dense_reference`` (with the
exponent clamp of ``_chunk_step``) plus :func:`labels_from_acc`, the
epilogue of ``_postprocess_prob`` and ``_labels_xla``; and
:func:`splat_backward_plain`, a chunked port of ``_splat_bwd_single``.

Inputs are the packed tables of ``ops/splat.py::pack_gaussians``:
``gdata`` [P, 9] = (mean, inverse covariance [xx, yy, zz, xy, yz, xz]),
``box`` [P, 6] int32 = (voxel lo xyz, voxel hi xyz) of each Gaussian's
AABB, ``sem_aug`` [P, C + 2] = (sem * w, w, 1), with w = (2 pi)^-1.5
sqrt(det A) opa for ``prob`` and w = opa for ``additive``. Outputs per
point: ``acc`` [N, C + 2] (semantic sums, sum of w e, density),
``one_minus`` [N] = prod(1 - e) (``prob``; None for ``additive``) and
``labels`` [N] int32: combine_geosem's argmax for ``prob``, the first-index
argmax of the raw sums for ``additive`` (0 where no box holds the voxel).
``grid`` is an ``ops.splat.SplatGridSpec``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _lib


def postprocess_prob(acc, one_minus):
    """(acc [N, C + 2], one_minus [N]) -> (logits, bin_logits, density):
    GMM normalisation with the uniform fallback when the probability sum
    is <= 1e-9."""
    c = acc.shape[-1] - 2
    prob_sum = acc[:, c]
    covered = prob_sum > 1e-9
    denom = torch.where(covered, prob_sum, torch.ones_like(prob_sum))
    uniform = torch.full((c,), 1.0 / (c - 1), dtype=acc.dtype,
                         device=acc.device)
    uniform[c - 1] = 0.0
    logits = torch.where(covered[:, None], acc[:, :c] / denom[:, None],
                         uniform)
    return logits, 1.0 - one_minus, acc[:, c + 1]


def combine_geosem(logits, bins):
    """[sem * bin, 1 - bin]: semantics over the occupied probability."""
    return torch.cat([logits[..., :-1] * bins[..., None],
                      1.0 - bins[..., None]], dim=-1)


VARIANTS = ("prob", "additive")


def _check_variant(variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"splat variant {variant!r} is not one of "
                         f"{VARIANTS}")


def labels_from_acc(acc, one_minus=None):
    """Final-occ labels [N] int32 from acc [N, C + 2]. With ``one_minus``
    [N] (prob): normalise, combine_geosem, first-index argmax. Without
    (additive): first-index argmax of the raw sums."""
    if one_minus is None:
        return torch.argmax(acc[:, :-2], dim=-1).to(torch.int32)
    logits, bins, _ = postprocess_prob(acc, one_minus)
    return torch.argmax(combine_geosem(logits, bins), dim=-1).to(torch.int32)


def splat_accumulate_plain(points, gdata, box, sem_aug, grid,
                           variant: str = "prob", chunk_n: int = 65536,
                           chunk_g: int = 128):
    """Dense (point-chunk x Gaussian-chunk) blocks; fp32 throughout."""
    _check_variant(variant)
    prob = variant == "prob"
    n = points.shape[0]
    p = gdata.shape[0]
    pint = grid.voxelize(points)
    acc = torch.zeros(n, sem_aug.shape[1], dtype=torch.float32,
                      device=points.device)
    one_minus = (torch.ones(n, dtype=torch.float32, device=points.device)
                 if prob else None)
    for n0 in range(0, n, chunk_n):
        pts = points[n0:n0 + chunk_n]
        pi = pint[n0:n0 + chunk_n]
        for g0 in range(0, p, chunk_g):
            gd = gdata[g0:g0 + chunk_g]
            bx = box[g0:g0 + chunk_g]
            dx = gd[None, :, 0] - pts[:, None, 0]
            dy = gd[None, :, 1] - pts[:, None, 1]
            dz = gd[None, :, 2] - pts[:, None, 2]
            logit = (-0.5 * (gd[:, 3] * dx * dx + gd[:, 4] * dy * dy
                             + gd[:, 5] * dz * dz)
                     - (gd[:, 6] * dx * dy + gd[:, 7] * dy * dz
                        + gd[:, 8] * dx * dz))
            inside = ((pi[:, None, :] >= bx[None, :, 0:3])
                      & (pi[:, None, :] <= bx[None, :, 3:6])).all(-1)
            e = torch.exp(torch.clamp_max(logit, 30.0)) * inside
            acc[n0:n0 + chunk_n] += e @ sem_aug[g0:g0 + chunk_g]
            if prob:
                one_minus[n0:n0 + chunk_n] *= torch.prod(1.0 - e, dim=1)
    return acc, one_minus, labels_from_acc(acc, one_minus)


def splat_accumulate_cuda(points, gdata, box, sem_aug, grid,
                          variant: str = "prob"):
    """Launch ``csrc/splat.cu``: one block of 256 points per tile."""
    _check_variant(variant)
    name = "splat_accumulate"
    _lib.require_cuda(name, points=points, gdata=gdata, box=box,
                      sem_aug=sem_aug)
    for key, t, dt in (("points", points, torch.float32),
                       ("gdata", gdata, torch.float32),
                       ("box", box, torch.int32),
                       ("sem_aug", sem_aug, torch.float32)):
        _lib.require_dtype(name, key, t, dt)
    n, p = points.shape[0], gdata.shape[0]
    ca = sem_aug.shape[1]
    if (points.shape != (n, 3) or gdata.shape != (p, 9)
            or box.shape != (p, 6) or sem_aug.shape[0] != p):
        raise ValueError(f"{name}: bad table shapes")
    acc = torch.empty(n, ca, dtype=torch.float32, device=points.device)
    labels = torch.empty(n, dtype=torch.int32, device=points.device)
    pc = (ctypes.c_float * 3)(*grid.pc_min)
    if variant == "additive":
        code = _lib.lib().gf_splat_forward_additive(
            points.data_ptr(), n, gdata.data_ptr(), box.data_ptr(),
            sem_aug.data_ptr(), p, ca - 2, pc, float(grid.grid_size),
            grid.H, grid.W, grid.D, acc.data_ptr(), labels.data_ptr(),
            _lib.stream_ptr(points))
        _lib.check(code, name)
        _lib.LAUNCHES["splat_additive"] += 1
        return acc, None, labels
    one_minus = torch.empty(n, dtype=torch.float32, device=points.device)
    code = _lib.lib().gf_splat_forward(
        points.data_ptr(), n, gdata.data_ptr(), box.data_ptr(),
        sem_aug.data_ptr(), p, ca - 2, pc, float(grid.grid_size),
        grid.H, grid.W, grid.D, acc.data_ptr(), one_minus.data_ptr(),
        labels.data_ptr(), _lib.stream_ptr(points))
    _lib.check(code, name)
    _lib.LAUNCHES["splat"] += 1
    return acc, one_minus, labels


def splat_accumulate(points, gdata, box, sem_aug, grid,
                     variant: str = "prob"):
    """Splat accumulators and labels: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors."""
    if points.device.type == "cpu":
        return splat_accumulate_plain(points, gdata, box, sem_aug, grid,
                                      variant)
    return splat_accumulate_cuda(points, gdata, box, sem_aug, grid, variant)


NORM_3D = (2.0 * math.pi) ** -1.5


def _det_terms(gdata, opa):
    """det(A), sqrt(max(det, 1e-30)) and w = (2 pi)^-1.5 sqrt(det) opa."""
    xx, yy, zz, xy, yz, xz = gdata[:, 3:9].unbind(-1)
    det = (xx * yy * zz + 2.0 * xy * yz * xz
           - xx * yz * yz - yy * xz * xz - zz * xy * xy)
    sqrt_det = torch.sqrt(det.clamp_min(1e-30))
    return det, sqrt_det, NORM_3D * sqrt_det * opa


def _finish_backward(gdata, opa, sd, sdd, gw, gsem, prob: bool):
    """Fold the per-Gaussian sums into (gmu, gopa, gsem, gcov): the
    exponent's moments and, for the prob variant, the det(A) term of w."""
    a = gdata[:, 3:9]
    xx, yy, zz, xy, yz, xz = a.unbind(-1)
    gmu = -torch.stack([xx * sd[:, 0] + xy * sd[:, 1] + xz * sd[:, 2],
                        xy * sd[:, 0] + yy * sd[:, 1] + yz * sd[:, 2],
                        xz * sd[:, 0] + yz * sd[:, 1] + zz * sd[:, 2]], -1)
    gcov = torch.cat([-0.5 * sdd[:, :3], -sdd[:, 3:]], -1)
    if not prob:
        return gmu, gw, gsem, gcov
    det, sqrt_det, _ = _det_terms(gdata, opa)
    gopa = gw * NORM_3D * sqrt_det
    gdet = torch.where(det > 1e-30,
                       gw * opa * NORM_3D / (2.0 * sqrt_det),
                       torch.zeros_like(gw))
    ddet = torch.stack([yy * zz - yz * yz, xx * zz - xz * xz,
                        xx * yy - xy * xy, 2.0 * (yz * xz - zz * xy),
                        2.0 * (xy * xz - xx * yz), 2.0 * (xy * yz - yy * xz)],
                       -1)
    return gmu, gopa, gsem, gcov + gdet[:, None] * ddet


@torch.no_grad()
def splat_backward_plain(points, gdata, opa, sem, box, gl, scalars, grid,
                         variant: str = "prob", chunk_n: int = 65536,
                         chunk_g: int = 128):
    """Hand-derived VJP of the splat in dense (point-chunk x
    Gaussian-chunk) blocks, fp32 (``_splat_bwd_single``). prob: ``gl``
    [N, C] is the covered, prob_sum-normalised logits cotangent and
    ``scalars`` [N, 3] holds (dot_gl, bin_term, g_density). additive:
    ``gl`` is the logits cotangent itself and ``scalars`` is None. The
    exponent's moments are summed in the displacement d = mu - x. Returns
    (gmu [P, 3], gopa [P], gsem [P, C], gcov [P, 6])."""
    _check_variant(variant)
    prob = variant == "prob"
    n = points.shape[0]
    p, c = sem.shape
    dev = points.device
    pint = grid.voxelize(points)
    w = _det_terms(gdata, opa)[2] if prob else opa
    f32 = dict(dtype=torch.float32, device=dev)
    sd = torch.zeros(p, 3, **f32)
    sdd = torch.zeros(p, 6, **f32)
    gw = torch.zeros(p, **f32)
    gsem = torch.zeros(p, c, **f32)
    for n0 in range(0, n, chunk_n):
        pts = points[n0:n0 + chunk_n]
        pi = pint[n0:n0 + chunk_n]
        gl_n = gl[n0:n0 + chunk_n]
        if prob:
            dot_gl, bin_term, g_dens = scalars[n0:n0 + chunk_n].unbind(-1)
        for g0 in range(0, p, chunk_g):
            sl = slice(g0, g0 + chunk_g)
            gd, bx = gdata[sl], box[sl]
            d = [gd[None, :, a] - pts[:, None, a] for a in range(3)]
            logit = (-0.5 * (gd[:, 3] * d[0] * d[0] + gd[:, 4] * d[1] * d[1]
                             + gd[:, 5] * d[2] * d[2])
                     - (gd[:, 6] * d[0] * d[1] + gd[:, 7] * d[1] * d[2]
                        + gd[:, 8] * d[0] * d[2]))
            inside = ((pi[:, None, :] >= bx[None, :, 0:3])
                      & (pi[:, None, :] <= bx[None, :, 3:6])).all(-1)
            power = torch.exp(torch.clamp_max(logit, 30.0)) * inside
            gprob = gl_n @ sem[sl].T
            gpower = gprob * w[None, sl]
            if prob:
                gprob = gprob - dot_gl[:, None]
                one_m = 1.0 - torch.clamp_max(power, 1.0 - 1e-9) + 1e-9
                gpower = (g_dens[:, None] + bin_term[:, None] / one_m
                          + gprob * w[None, sl])
            gw[sl] += (gprob * power).sum(0)
            gsem[sl] += (power * w[None, sl]).T @ gl_n
            glogit = gpower * power * (logit < 30.0)
            sd[sl] += torch.stack([(glogit * d[a]).sum(0)
                                   for a in range(3)], -1)
            sdd[sl] += torch.stack([(glogit * d[i] * d[j]).sum(0)
                                    for i, j in ((0, 0), (1, 1), (2, 2),
                                                 (0, 1), (1, 2), (0, 2))],
                                   -1)
    return _finish_backward(gdata, opa, sd, sdd, gw, gsem, prob)


def _require_raster(name, points, grid):
    """The kernel enumerates each Gaussian's AABB by raster index: the
    points must be the voxel grid in raster order (x slowest, z
    fastest), one per voxel."""
    if points.shape != (grid.num_voxels, 3):
        raise ValueError(f"{name}: points are not the {grid.H}x{grid.W}x"
                         f"{grid.D} voxel grid")
    idx = grid.voxelize(points)
    lin = (idx[:, 0] * grid.W + idx[:, 1]) * grid.D + idx[:, 2]
    if not torch.equal(lin, torch.arange(grid.num_voxels,
                                         device=points.device)):
        raise ValueError(f"{name}: points are not the voxel grid in raster "
                         f"order")


def splat_backward_cuda(points, gdata, opa, sem, box, gl, scalars, grid,
                        variant: str = "prob"):
    """Launch ``csrc/splat_bwd.cu``: one block per Gaussian over the
    voxels of its AABB (the additive variant walks boxes of more than 8192
    voxels in segments, in a second launch). The points must be the raster
    voxel grid. ``scalars`` is None for the additive variant."""
    _check_variant(variant)
    name = "splat_backward"
    p, c = sem.shape
    prob = variant == "prob"
    if prob == (scalars is None):
        raise ValueError(f"{name}: the prob variant, and only it, takes "
                         f"scalars")
    tensors = dict(points=points, gdata=gdata, opa=opa, sem=sem, box=box,
                   gl=gl)
    if prob:
        tensors["scalars"] = scalars
    _lib.require_cuda(name, **tensors)
    for key, t in tensors.items():
        _lib.require_dtype(name, key, t,
                           torch.int32 if key == "box" else torch.float32)
    n = points.shape[0]
    if (gdata.shape != (p, 9) or opa.shape != (p,) or box.shape != (p, 6)
            or gl.shape != (n, c)
            or (prob and scalars.shape != (n, 3))):
        raise ValueError(f"{name}: bad table shapes")
    _require_raster(name, points, grid)
    f32 = dict(dtype=torch.float32, device=points.device)
    gmu = torch.empty(p, 3, **f32)
    gopa = torch.empty(p, **f32)
    gsem = torch.empty(p, c, **f32)
    gcov = torch.empty(p, 6, **f32)
    if not prob:
        # big[0] counts, big[1:] lists the boxes the kernel walks in segments
        big = torch.zeros(p + 1, dtype=torch.int32, device=points.device)
        code = _lib.lib().gf_splat_backward_additive(
            points.data_ptr(), gdata.data_ptr(), opa.data_ptr(),
            sem.data_ptr(), box.data_ptr(), gl.data_ptr(), p, c, grid.H,
            grid.W, grid.D, gmu.data_ptr(), gopa.data_ptr(),
            gsem.data_ptr(), gcov.data_ptr(), big.data_ptr(),
            _lib.stream_ptr(points))
        _lib.check(code, name)
        _lib.LAUNCHES["splat_bwd_additive"] += 1
        return gmu, gopa, gsem, gcov
    code = _lib.lib().gf_splat_backward(
        points.data_ptr(), gdata.data_ptr(), opa.data_ptr(), sem.data_ptr(),
        box.data_ptr(), gl.data_ptr(), scalars.data_ptr(), p, c, grid.H,
        grid.W, grid.D, gmu.data_ptr(), gopa.data_ptr(), gsem.data_ptr(),
        gcov.data_ptr(), _lib.stream_ptr(points))
    _lib.check(code, name)
    _lib.LAUNCHES["splat_bwd"] += 1
    return gmu, gopa, gsem, gcov


def splat_backward(points, gdata, opa, sem, box, gl, scalars, grid,
                   variant: str = "prob"):
    """Per-Gaussian splat gradients: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors."""
    if points.device.type == "cpu":
        return splat_backward_plain(points, gdata, opa, sem, box, gl,
                                    scalars, grid, variant)
    return splat_backward_cuda(points, gdata, opa, sem, box, gl, scalars,
                               grid, variant)
