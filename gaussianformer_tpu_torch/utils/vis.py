"""Visualization of occupancy grids and Gaussians
(gaussianformer_tpu/utils/vis.py, the port's own copy): the reference
vis.py's renders (save_occ :58, save_gaussian :345, save_gaussian_topdown
:444) on matplotlib (mayavi is not a dependency here), top-down and
isometric voxel scatter renders plus Gaussian ellipse projections, with the
nuScenes colormap (vis.py:317-343). Inputs are numpy arrays (or CPU
tensors). With matplotlib installed the renders are the JAX package's
pixel for pixel; on a host without it (the card's machine has PIL but no
matplotlib) the same views are drawn with PIL and numpy, without axes or
titles: the occupancy's top-down colours, an isometric projection of the
voxels or of the Gaussians' ellipsoids, and the Gaussians' top-down
ellipses.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

# nuScenes 16-class + empty colormap (RGB 0-255)
NUSC_COLORMAP = np.array([
    [0, 0, 0],        # 0 noise/ignore
    [255, 120, 50],   # barrier
    [255, 192, 203],  # bicycle
    [255, 255, 0],    # bus
    [0, 150, 245],    # car
    [0, 255, 255],    # construction_vehicle
    [255, 127, 0],    # motorcycle
    [255, 0, 0],      # pedestrian
    [255, 240, 150],  # traffic_cone
    [135, 60, 0],     # trailer
    [160, 32, 240],   # truck
    [255, 0, 255],    # driveable_surface
    [139, 137, 137],  # other_flat
    [75, 0, 75],      # sidewalk
    [150, 240, 80],   # terrain
    [230, 230, 250],  # manmade
    [0, 175, 0],      # vegetation
    [255, 255, 255],  # empty
], dtype=np.float32) / 255.0


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _topdown(occ, empty_label):
    """The [X, Y, 3] colours of each column's highest occupied voxel
    (white where none is)."""
    occupied = occ != empty_label
    # highest occupied voxel per column
    top_z = np.where(occupied.any(-1),
                     occ.shape[2] - 1 - np.argmax(occupied[..., ::-1],
                                                  axis=-1), -1)
    img = np.ones(occ.shape[:2] + (3,), np.float32)
    ys, xs = np.nonzero(top_z >= 0)
    labels = occ[ys, xs, top_z[ys, xs]]
    img[ys, xs] = NUSC_COLORMAP[np.clip(labels, 0, len(NUSC_COLORMAP) - 1)]
    return img


def save_occ(path: str, occ: np.ndarray, empty_label: int = 17,
             view: str = "topdown", title: Optional[str] = None):
    """Render a [X, Y, Z] semantic occupancy grid.

    view: 'topdown' (z-argmax column color) or 'scatter3d'."""
    occ = np.asarray(occ)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt = _pyplot()
    if plt is None:
        if view == "topdown":
            return _write(path, np.rot90(_topdown(occ, empty_label)), 4)
        xs, ys, zs = np.nonzero(occ != empty_label)
        colors = NUSC_COLORMAP[np.clip(occ[xs, ys, zs], 0,
                                       len(NUSC_COLORMAP) - 1)]
        return _write(path, _isometric(np.stack([xs, ys, 2 * zs], -1)
                                       .astype(np.float32), colors, 4.0))

    if view == "topdown":
        img = _topdown(occ, empty_label)
        fig, ax = plt.subplots(figsize=(8, 8))
        ax.imshow(np.rot90(img))
        ax.set_axis_off()
    else:
        xs, ys, zs = np.nonzero(occ != empty_label)
        labels = occ[xs, ys, zs]
        fig = plt.figure(figsize=(10, 8))
        ax = fig.add_subplot(projection="3d")
        ax.scatter(xs, ys, zs, c=NUSC_COLORMAP[
            np.clip(labels, 0, len(NUSC_COLORMAP) - 1)], s=1)
        ax.set_box_aspect((occ.shape[0], occ.shape[1], occ.shape[2] * 2))
    if title:
        fig.suptitle(title)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def save_gaussian(path: str, means, scales, rotations, semantics,
                  opacities=None, pc_range=(-50, -50, -5, 50, 50, 3),
                  opacity_thresh: float = 0.3, scale_thresh: float = 0.05,
                  max_gaussians: int = 2000, mesh_res: int = 8):
    """3D ellipsoid render of Gaussians colored by argmax semantics
    (reference vis.py:345-443 `save_gaussian`, mayavi → matplotlib).

    Each Gaussian is drawn as its 1-sigma ellipsoid: unit-sphere mesh
    transformed by R @ diag(scales) + mean. Gaussians below the opacity /
    scale thresholds are dropped (the reference's sparse-gaussian
    filtering); the largest-opacity ``max_gaussians`` survive.
    """
    import torch

    from ..ops.rotation import quaternion_to_rotation_matrix

    means = np.asarray(means).reshape(-1, 3)
    scales = np.asarray(scales).reshape(-1, 3)
    rots = np.asarray(rotations).reshape(-1, 4)
    sem = np.asarray(semantics).reshape(means.shape[0], -1)
    labels = sem.argmax(-1)
    opa = (np.asarray(opacities).reshape(-1)
           if opacities is not None and np.size(opacities)
           else np.ones(len(means)))

    keep = (opa > opacity_thresh) & (scales.max(-1) > scale_thresh)
    keep &= np.all((means >= np.asarray(pc_range[:3]))
                   & (means <= np.asarray(pc_range[3:])), axis=-1)
    idx = np.nonzero(keep)[0]
    if len(idx) > max_gaussians:
        idx = idx[np.argsort(-opa[idx])[:max_gaussians]]

    rot_mats = quaternion_to_rotation_matrix(torch.from_numpy(
        np.asarray(rots[idx], np.float32))).numpy()

    # unit sphere mesh
    u = np.linspace(0, 2 * np.pi, mesh_res)
    v = np.linspace(0, np.pi, mesh_res)
    sx = np.outer(np.cos(u), np.sin(v))
    sy = np.outer(np.sin(u), np.sin(v))
    sz = np.outer(np.ones_like(u), np.cos(v))
    sphere = np.stack([sx, sy, sz], axis=-1)  # [res, res, 3]

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt = _pyplot()
    if plt is None:
        # every mesh point of every ellipsoid, z stretched twice as in
        # the box aspect above
        pts = np.einsum("kpc,kdc->kpd", sphere.reshape(1, -1, 3)
                        * scales[idx, None], rot_mats) + means[idx, None]
        colors = NUSC_COLORMAP[np.minimum(labels[idx] + 1,
                                          len(NUSC_COLORMAP) - 1)]
        return _write(path, _isometric(
            (pts.reshape(-1, 3) - np.asarray(pc_range[:3])) * (1, 1, 2),
            np.repeat(colors, sphere.shape[0] * sphere.shape[1], 0), 8.0))
    fig = plt.figure(figsize=(12, 9))
    ax = fig.add_subplot(projection="3d")
    for k, gi in enumerate(idx):
        pts = sphere * scales[gi]
        pts = pts @ rot_mats[k].T + means[gi]
        color = NUSC_COLORMAP[min(int(labels[gi]) + 1,
                                  len(NUSC_COLORMAP) - 1)]
        ax.plot_surface(pts[..., 0], pts[..., 1], pts[..., 2],
                        color=color, alpha=min(float(opa[gi]), 1.0),
                        linewidth=0, antialiased=False, shade=False)
    ax.set_xlim(pc_range[0], pc_range[3])
    ax.set_ylim(pc_range[1], pc_range[4])
    ax.set_zlim(pc_range[2], pc_range[5])
    ax.set_box_aspect((pc_range[3] - pc_range[0],
                       pc_range[4] - pc_range[1],
                       (pc_range[5] - pc_range[2]) * 2))
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def save_gaussian_topdown(path: str, means, scales, semantics,
                          opacities=None, pc_range=(-50, -50, -5, 50, 50, 3),
                          opacity_thresh: float = 0.0):
    """Top-down ellipse plot of Gaussians colored by argmax semantics
    (reference vis.py:444)."""
    means = np.asarray(means).reshape(-1, 3)
    scales = np.asarray(scales).reshape(-1, 3)
    sem = np.asarray(semantics).reshape(means.shape[0], -1)
    labels = sem.argmax(-1)
    keep = np.ones(len(means), bool)
    if opacities is not None and np.size(opacities):
        keep = np.asarray(opacities).reshape(-1) > opacity_thresh

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt = _pyplot()
    if plt is None:
        return _write(path, _ellipses(means[keep], scales[keep],
                                      labels[keep], pc_range))
    from matplotlib.patches import Ellipse
    fig, ax = plt.subplots(figsize=(10, 10))
    for m, s, c in zip(means[keep], scales[keep], labels[keep]):
        color = NUSC_COLORMAP[min(int(c) + 1, len(NUSC_COLORMAP) - 1)]
        ax.add_patch(Ellipse((m[0], m[1]), 2 * s[0], 2 * s[1],
                             facecolor=color, alpha=0.5, lw=0))
    ax.set_xlim(pc_range[0], pc_range[3])
    ax.set_ylim(pc_range[1], pc_range[4])
    ax.set_aspect("equal")
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


# ---- the views drawn with PIL and numpy, where matplotlib is missing ----

def _write(path: str, img, upscale: int = 1) -> str:
    """Save an [H, W, 3] image of colours in [0, 1] as a PNG, each pixel
    repeated ``upscale`` times along both axes."""
    from PIL import Image
    img = np.repeat(np.repeat(np.asarray(img), upscale, 0), upscale, 1)
    Image.fromarray(np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)
                    ).save(path)
    return path


def _isometric(xyz, colors, px_per_unit: float, size: int = 1200):
    """Points [N, 3] (z up) seen from above a corner at 30 degrees, on a
    white square of ``size`` pixels (shrunk to fit): the nearer point wins
    a pixel."""
    img = np.ones((size, size, 3), np.float32)
    if not len(xyz):
        return img
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    u = (x - y) * 0.866
    v = -(x + y) * 0.5 - z
    u, v = u - u.min(), v - v.min()
    px = min(px_per_unit, (size - 8) / max(u.max(), v.max(), 1e-6))
    u = np.round(u * px + 4).astype(np.int64)
    v = np.round(v * px + 4).astype(np.int64)
    order = np.argsort(x + y - z, kind="stable")[::-1]   # far first
    img[v[order], u[order]] = colors[order]
    return img


def _ellipses(means, scales, labels, pc_range, size: int = 1000):
    """Axis-aligned ellipses of semi-axes (sx, sy) at the means, each
    blended at alpha 0.5 over the ones before, on a white top-down square
    of ``size`` pixels over pc_range (x right, y up)."""
    img = np.ones((size, size, 3), np.float32)
    x0, y0, x1, y1 = pc_range[0], pc_range[1], pc_range[3], pc_range[4]
    kx, ky = size / (x1 - x0), size / (y1 - y0)
    for m, s, c in zip(means, scales, labels):
        cu, cv = (m[0] - x0) * kx, (y1 - m[1]) * ky
        ru, rv = max(s[0] * kx, 0.5), max(s[1] * ky, 0.5)
        u0, u1 = max(int(cu - ru), 0), min(int(cu + ru) + 1, size)
        v0, v1 = max(int(cv - rv), 0), min(int(cv + rv) + 1, size)
        if u0 >= u1 or v0 >= v1:
            continue
        vv, uu = np.mgrid[v0:v1, u0:u1] + 0.5
        inside = ((uu - cu) / ru) ** 2 + ((vv - cv) / rv) ** 2 <= 1.0
        patch = img[v0:v1, u0:u1]
        color = NUSC_COLORMAP[min(int(c) + 1, len(NUSC_COLORMAP) - 1)]
        patch[inside] = 0.5 * patch[inside] + 0.5 * color
    return img
