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


def farthest_point_sampling_cuda(points, num_samples: int, valid_mask=None):
    """Launch ``csrc/fps.cu`` once for all ``num_samples`` selections."""
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
        valid_u8 = valid_mask.to(torch.uint8).contiguous()
        seed = _seed(valid_mask)
    else:
        seed = torch.zeros((), dtype=torch.int32, device=points.device)
    out = torch.empty(num_samples, dtype=torch.int32, device=points.device)
    code = _lib.lib().gf_fps_forward(
        points.data_ptr(), None if valid_u8 is None else valid_u8.data_ptr(),
        seed.data_ptr(), n, num_samples, out.data_ptr(),
        _lib.stream_ptr(points))
    _lib.check(code, name)
    _lib.LAUNCHES["fps"] += 1
    return out


def farthest_point_sampling(points, num_samples: int, valid_mask=None):
    """Masked FPS: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors."""
    if points.device.type == "cpu":
        return farthest_point_sampling_plain(points, num_samples, valid_mask)
    return farthest_point_sampling_cuda(points, num_samples, valid_mask)
