"""K3: multi-camera, multi-level deformable aggregation with the key-point
sum fused.

Kernel: ``csrc/deformable.cu`` (replaces the TPU kernel
``gaussianformer_tpu/ops/pallas/deformable_kernel.py::deformable_fused_fwd``).
Plain version: :func:`deformable_aggregation_plain`,
``gaussianformer_tpu/ops/deformable.py::deformable_aggregation`` followed
by the sum over each anchor's key points.

Conventions of the reference op: locations are normalised (u, v) per
camera image; a location takes part only when strictly inside (0, 1) on
both axes; pixel coordinates are ``u * W - 0.5`` (align_corners=False);
bilinear corners outside the level contribute zero.
"""
from __future__ import annotations

import ctypes

import torch

from . import _lib


def deformable_aggregation_plain(feature_maps, points_2d, weights,
                                 num_pts: int, chunk: int = 4096):
    """feature_maps: per level [B, cams, H_l, W_l, C]; points_2d
    [B, Q, cams, 2] with Q = P * num_pts; weights [B, Q, cams, L, G].
    Returns [B, P, C] fp32."""
    b, q, cams, _ = points_2d.shape
    num_groups = weights.shape[-1]
    c = feature_maps[0].shape[-1]
    gdim = c // num_groups
    dev = points_2d.device
    inside = ((points_2d[..., 0] > 0.0) & (points_2d[..., 0] < 1.0)
              & (points_2d[..., 1] > 0.0) & (points_2d[..., 1] < 1.0))
    cam_off = torch.arange(b * cams, device=dev).reshape(b, 1, cams, 1)
    out = torch.zeros(b, q, c, dtype=torch.float32, device=dev)
    for lvl, feat in enumerate(feature_maps):
        h, w = feat.shape[2], feat.shape[3]
        flat = feat.reshape(-1, c)
        w_im = points_2d[..., 0] * w - 0.5
        h_im = points_2d[..., 1] * h - 0.5
        h0 = torch.floor(h_im)
        w0 = torch.floor(w_im)
        lh = h_im - h0
        lw = w_im - w0
        h0 = h0.long()
        w0 = w0.long()
        hs = torch.stack([h0, h0, h0 + 1, h0 + 1], dim=-1)
        ws = torch.stack([w0, w0 + 1, w0, w0 + 1], dim=-1)
        cw = torch.stack([(1 - lh) * (1 - lw), (1 - lh) * lw,
                          lh * (1 - lw), lh * lw], dim=-1)
        valid = ((hs >= 0) & (hs <= h - 1) & (ws >= 0) & (ws <= w - 1)
                 & inside[..., None])
        cw = cw * valid                                   # [B, Q, cams, 4]
        rows = (cam_off * (h * w) + hs.clamp(0, h - 1) * w
                + ws.clamp(0, w - 1))
        # combined weight per (corner, group): [B, Q, cams, 4, G]
        wl = cw[..., None] * weights[:, :, :, lvl, None, :].float()
        for q0 in range(0, q, chunk):
            g = flat[rows[:, q0:q0 + chunk].reshape(-1)].float().reshape(
                b, -1, cams * 4, num_groups, gdim)
            wc = wl[:, q0:q0 + chunk].reshape(b, -1, cams * 4, num_groups)
            out[:, q0:q0 + chunk] += (g * wc[..., None]).sum(2).reshape(
                b, -1, c)
    return out.reshape(b, q // num_pts, num_pts, c).sum(2)


def deformable_aggregation_cuda(feature_maps, points_2d, weights,
                                num_pts: int):
    """Launch ``csrc/deformable.cu``: one warp per anchor."""
    name = "deformable_aggregation"
    b, q, cams, _ = points_2d.shape
    levels = len(feature_maps)
    g = weights.shape[-1]
    c = feature_maps[0].shape[-1]
    _lib.require_cuda(name, points_2d=points_2d, weights=weights,
                      **{f"feature_maps[{i}]": f
                         for i, f in enumerate(feature_maps)})
    _lib.require_dtype(name, "points_2d", points_2d, torch.float32)
    _lib.require_dtype(name, "weights", weights, torch.float32)
    dt = feature_maps[0].dtype
    for i, f in enumerate(feature_maps):
        _lib.require_dtype(name, f"feature_maps[{i}]", f, dt)
        if f.shape[:2] != (b, cams) or f.shape[-1] != c:
            raise ValueError(f"{name}: feature_maps[{i}] has shape "
                             f"{tuple(f.shape)}")
    _lib.require_dtype(name, "feature_maps", feature_maps[0],
                       torch.float32, torch.bfloat16)
    if weights.shape != (b, q, cams, levels, g) or q % num_pts:
        raise ValueError(f"{name}: weights has shape {tuple(weights.shape)}")
    if not 1 <= levels <= 4 or c % g or (c // g) % max(c // 32, 1):
        raise ValueError(f"{name}: unsupported levels={levels}, C={c}, G={g}")
    p = q // num_pts
    out = torch.empty(b, p, c, dtype=torch.float32, device=points_2d.device)
    ptrs = (ctypes.c_void_p * levels)(*[f.data_ptr() for f in feature_maps])
    hs = (ctypes.c_int * levels)(*[f.shape[2] for f in feature_maps])
    ws = (ctypes.c_int * levels)(*[f.shape[3] for f in feature_maps])
    code = _lib.lib().gf_deformable_forward(
        ptrs, hs, ws, levels, int(dt == torch.bfloat16),
        points_2d.data_ptr(), weights.data_ptr(), out.data_ptr(),
        b, p, num_pts, cams, c, g, _lib.stream_ptr(points_2d))
    _lib.check(code, name)
    _lib.LAUNCHES["deformable"] += 1
    return out


def deformable_aggregation(feature_maps, points_2d, weights, num_pts: int):
    """Deformable aggregation summed over key points: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    if points_2d.device.type == "cpu":
        return deformable_aggregation_plain(feature_maps, points_2d,
                                            weights, num_pts)
    return deformable_aggregation_cuda(feature_maps, points_2d, weights,
                                       num_pts)
