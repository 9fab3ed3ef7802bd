"""K2: masked farthest-point sampling.

Kernel: ``csrc/fps.cu`` (replaces the TPU kernel
``gaussianformer_tpu/ops/pallas/fps_kernel.py``
``::farthest_point_sampling_pallas``).
Plain version: :func:`farthest_point_sampling_plain`, the loop of
``gaussianformer_tpu/ops/fps.py::farthest_point_sampling``.

Seed at the first valid index (0 when none is valid); invalid points
carry distance -inf and are taken only once the valid ones run out; ties
go to the FIRST index.
"""
from __future__ import annotations

import torch

from . import _lib


def _seed(valid):
    # argmax returns the first maximal index, and 0 when no point is valid
    return torch.argmax(valid.to(torch.int32)).to(torch.int32)


def farthest_point_sampling_plain(points, num_samples: int, valid_mask=None):
    """points [N, 3] fp32 -> [num_samples] int32 indices."""
    n = points.shape[0]
    valid = (torch.ones(n, dtype=torch.bool, device=points.device)
             if valid_mask is None else valid_mask.bool())
    x, y, z = points.float().unbind(-1)
    neg_inf = torch.tensor(float("-inf"), device=points.device)
    dist = torch.where(valid, torch.tensor(float("inf"),
                                           device=points.device), neg_inf)
    sel = torch.empty(num_samples, dtype=torch.int32, device=points.device)
    last = _seed(valid)
    sel[0] = last
    for i in range(1, num_samples):
        dx = x - x[last]
        dy = y - y[last]
        dz = z - z[last]
        d = dx * dx + dy * dy + dz * dz
        dist = torch.minimum(dist, torch.where(valid, d, neg_inf))
        last = torch.argmax(dist)
        sel[i] = last
    return sel


def farthest_point_sampling_cuda(points, num_samples: int, valid_mask=None,
                                 cluster_size: int = 0):
    """Launch ``csrc/fps.cu`` once for all ``num_samples`` selections, on a
    cluster of ``cluster_size`` blocks (8 or 16; 0: the card's default,
    :func:`default_cluster_size`), with the points in
    :func:`spatial_order`."""
    name = "farthest_point_sampling"
    _lib.require_cuda(name, points=points, valid_mask=valid_mask)
    _lib.require_dtype(name, "points", points, torch.float32)
    n = points.shape[0]
    if points.shape != (n, 3):
        raise ValueError(f"{name}: points must be [N, 3]")
    if num_samples < 1:
        raise ValueError(f"{name}: num_samples must be positive")
    valid_u8 = None
    if valid_mask is not None:
        if valid_mask.shape != (n,):
            raise ValueError(f"{name}: valid_mask must be [N]")
        seed = _seed(valid_mask)
    else:
        seed = torch.zeros((), dtype=torch.int32, device=points.device)
    # the kernel takes the points in Morton order, each with its own index
    # (for the output and the ties), and the seed's position in that order
    order = spatial_order(points)
    pts = points[order].contiguous()
    if valid_mask is not None:
        valid_u8 = valid_mask[order].to(torch.uint8).contiguous()
    seed_pos = torch.argmax((order == seed).to(torch.int32)).to(torch.int32)
    out = torch.empty(num_samples, dtype=torch.int32, device=points.device)
    code = _lib.lib().gf_fps_forward_ordered(
        pts.data_ptr(), None if valid_u8 is None else valid_u8.data_ptr(),
        order.data_ptr(), seed_pos.data_ptr(), n, num_samples,
        out.data_ptr(), cluster_size, _lib.stream_ptr(points))
    _lib.check(code, name)
    _lib.LAUNCHES["fps"] += 1
    return out


def _spread_bits(v):
    """The low 10 bits of ``v`` (int64) moved to every third bit."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def spatial_order(points):
    """A permutation [N] int32 that sorts ``points`` [N, 3] by their Morton
    code on a lattice of cubic cells, 1024 along the longest side of their
    bounding box, so that runs of
    consecutive points are compact (the FPS kernel skips a warp whose run
    lies far from the new point). Any permutation gives the kernel the same
    result; non-finite coordinates only make the runs less compact."""
    p = points.float()
    lo = p.amin(0)
    # one scale for the three axes: cubic cells, so a thin axis (the
    # lifter's height) does not stretch the runs across the others
    span = (p.amax(0) - lo).amax().clamp_min(1e-30)
    q = ((p - lo) / span * 1023.0).nan_to_num(0.0).clamp(0, 1023).long()
    code = (_spread_bits(q[:, 0]) | (_spread_bits(q[:, 1]) << 1)
            | (_spread_bits(q[:, 2]) << 2))
    # 30-bit codes: an int32 sort key
    return torch.argsort(code.to(torch.int32)).to(torch.int32)


def default_cluster_size() -> int:
    """Blocks in the kernel's cluster on this card (16 where it allows it,
    else 8)."""
    return _lib.lib().gf_fps_cluster_size()


def fps_step_floor_cuda(num_samples: int, device, cluster_size: int = 0):
    """Run the kernel's per-step exchange alone (the pruning test, block
    and cluster reductions, barriers and the new point's broadcast),
    ``num_samples - 1`` times over no points: the latency floor of a
    selection, for timing only. Never on the model's path, so not counted
    in ``LAUNCHES``."""
    out = torch.empty(num_samples, dtype=torch.int32, device=device)
    code = _lib.lib().gf_fps_step_floor(num_samples, out.data_ptr(),
                                        cluster_size, _lib.stream_ptr(out))
    _lib.check(code, "fps_step_floor")


def farthest_point_sampling(points, num_samples: int, valid_mask=None):
    """Masked FPS: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors."""
    if points.device.type == "cpu":
        return farthest_point_sampling_plain(points, num_samples, valid_mask)
    return farthest_point_sampling_cuda(points, num_samples, valid_mask)
