"""Submanifold sparse 3D convolution over a fixed-size anchor set
(gaussianformer_tpu/ops/sparse_conv.py::submanifold_conv3d), in gather
("rulebook") form: a voxel -> anchor table, one neighbour-anchor lookup per
kernel tap, and a matmul per chunk of taps. Outputs exist only at input
sites; empty neighbour voxels contribute zero. When several anchors share a
voxel, the highest anchor index wins the neighbour lookup (the JAX
package's scatter is last-writer-wins)."""
from __future__ import annotations

import torch


def voxel_indices(xyz, pc_range, grid_size):
    """World xyz -> int64 voxel coords (truncation, as the reference does)
    plus the static grid shape."""
    lo = torch.tensor(pc_range[:3], dtype=xyz.dtype, device=xyz.device)
    gs = torch.tensor(grid_size, dtype=xyz.dtype, device=xyz.device)
    idx = ((xyz - lo) / gs).to(torch.int32).long()
    shape = tuple(int((pc_range[i + 3] - pc_range[i]) / float(grid_size[i]))
                  for i in range(3))
    hi = torch.tensor([s - 1 for s in shape], device=xyz.device)
    return torch.minimum(idx.clamp_min(0), hi), shape


def neighbor_anchors(coords, grid_shape, k: int):
    """[P, k^3] index of the anchor in each tap's neighbour voxel, or P
    where the voxel is empty or outside the grid."""
    p = coords.shape[0]
    dev = coords.device
    X, Y, Z = grid_shape
    r = (k - 1) // 2
    flat = (coords[:, 0] * Y + coords[:, 1]) * Z + coords[:, 2]
    table = torch.full((X * Y * Z + 1,), -1, dtype=torch.long, device=dev)
    table.scatter_reduce_(0, flat, torch.arange(p, device=dev),
                          reduce="amax")
    table = torch.where(table < 0, p, table)
    rng = torch.arange(-r, r + 1, device=dev)
    offs = torch.stack(torch.meshgrid(rng, rng, rng, indexing="ij"),
                       dim=-1).reshape(-1, 3)
    nb = coords[:, None, :] + offs[None]
    dims = torch.tensor([X, Y, Z], device=dev)
    inb = ((nb >= 0) & (nb < dims)).all(-1)
    nb_flat = (nb[..., 0] * Y + nb[..., 1]) * Z + nb[..., 2]
    nb_flat = torch.where(inb, nb_flat, torch.full_like(nb_flat, X * Y * Z))
    return table[nb_flat]


def submanifold_conv3d(features, nb_anchor, weight, bias=None,
                       compute_dtype=None, taps_per_chunk: int = 25):
    """features [P, C_in]; nb_anchor from :func:`neighbor_anchors`; weight
    [C_out, k, k, k, C_in] (spconv layout). Returns [P, C_out] fp32."""
    p, c_in = features.shape
    c_out = weight.shape[0]
    dt = compute_dtype or features.dtype
    kkk = nb_anchor.shape[1]
    feats = torch.cat([features.to(dt),
                       features.new_zeros(1, c_in, dtype=dt)])
    w_taps = weight.permute(1, 2, 3, 4, 0).reshape(kkk, c_in, c_out).to(dt)
    out = torch.zeros(p, c_out, dtype=torch.float32, device=features.device)
    for t0 in range(0, kkk, taps_per_chunk):
        nb = nb_anchor[:, t0:t0 + taps_per_chunk]
        g = feats[nb.reshape(-1)].reshape(p, -1)
        out += (g @ w_taps[t0:t0 + taps_per_chunk].reshape(-1, c_out)).float()
    if bias is not None:
        out = out + bias
    return out
