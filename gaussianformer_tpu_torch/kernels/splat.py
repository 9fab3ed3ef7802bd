"""K4: probabilistic Gaussian -> voxel splat with the final-occ label
epilogue.

Kernel: ``csrc/splat.cu`` (replaces the TPU kernel
``gaussianformer_tpu/ops/pallas/splat_kernel.py::splat_raw_pallas`` with
``emit_labels``). Plain version: :func:`splat_accumulate_plain`, a chunked
dense form of ``gaussianformer_tpu/ops/splat.py::splat_dense_reference``
(with the exponent clamp of ``_chunk_step``) plus :func:`labels_from_acc`,
the epilogue of ``_postprocess_prob`` and ``_labels_xla``.

Inputs are the packed tables of ``ops/splat.py::pack_gaussians``:
``gdata`` [P, 9] = (mean, inverse covariance [xx, yy, zz, xy, yz, xz]),
``box`` [P, 6] int32 = (voxel lo xyz, voxel hi xyz) of each Gaussian's
AABB, ``sem_aug`` [P, C + 2] = (sem * w, w, 1). Outputs per point:
``acc`` [N, C + 2] (semantic sums, probability sum, density),
``one_minus`` [N] = prod(1 - e) and ``labels`` [N] int32. ``grid`` is an
``ops.splat.SplatGridSpec``.
"""
from __future__ import annotations

import ctypes

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


def labels_from_acc(acc, one_minus):
    """Final-occ labels: normalise, combine_geosem, first-index argmax.
    [N, C + 2], [N] -> [N] int32."""
    logits, bins, _ = postprocess_prob(acc, one_minus)
    return torch.argmax(combine_geosem(logits, bins), dim=-1).to(torch.int32)


def splat_accumulate_plain(points, gdata, box, sem_aug, grid,
                           chunk_n: int = 65536, chunk_g: int = 128):
    """Dense (point-chunk x Gaussian-chunk) blocks; fp32 throughout."""
    n = points.shape[0]
    p = gdata.shape[0]
    pint = grid.voxelize(points)
    acc = torch.zeros(n, sem_aug.shape[1], dtype=torch.float32,
                      device=points.device)
    one_minus = torch.ones(n, dtype=torch.float32, device=points.device)
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
            one_minus[n0:n0 + chunk_n] *= torch.prod(1.0 - e, dim=1)
    return acc, one_minus, labels_from_acc(acc, one_minus)


def splat_accumulate_cuda(points, gdata, box, sem_aug, grid):
    """Launch ``csrc/splat.cu``: one block of 256 points per tile."""
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
    one_minus = torch.empty(n, dtype=torch.float32, device=points.device)
    labels = torch.empty(n, dtype=torch.int32, device=points.device)
    pc = (ctypes.c_float * 3)(*grid.pc_min)
    code = _lib.lib().gf_splat_forward(
        points.data_ptr(), n, gdata.data_ptr(), box.data_ptr(),
        sem_aug.data_ptr(), p, ca - 2, pc, float(grid.grid_size),
        grid.H, grid.W, grid.D, acc.data_ptr(), one_minus.data_ptr(),
        labels.data_ptr(), _lib.stream_ptr(points))
    _lib.check(code, name)
    _lib.LAUNCHES["splat"] += 1
    return acc, one_minus, labels


def splat_accumulate(points, gdata, box, sem_aug, grid):
    """Splat accumulators and labels: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors."""
    if points.device.type == "cpu":
        return splat_accumulate_plain(points, gdata, box, sem_aug, grid)
    return splat_accumulate_cuda(points, gdata, box, sem_aug, grid)
