"""Synthetic data with the input contract of the nuScenes loader, made
from a seed with numpy: the dataset and batch of
gaussianformer_tpu/data/synthetic.py and ``__graft_entry__._synthetic_batch``,
:func:`finer_points` (the batch at query points finer than the splat grid),
:func:`lidar_points` (a LiDAR-like query set) and
:func:`write_nuscenes_files`, a small nuScenes-shaped set on disk for the
file pipeline (``data.dataset.NuScenesDataset``)."""
from __future__ import annotations

import os
import pickle
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .dataset import CAM_TYPES
from .transforms import occ_meshgrid


class SyntheticOccDataset:
    def __init__(self, num_samples: int = 8, num_cams: int = 6,
                 image_size: Tuple[int, int] = (864, 1600),
                 grid: Tuple[int, int, int] = (200, 200, 16),
                 pc_range=(-50.0, -50.0, -5.0, 50.0, 50.0, 3.0),
                 num_classes: int = 18, seed: int = 0):
        self.num_samples = num_samples
        self.num_cams = num_cams
        self.image_size = image_size
        self.grid = grid
        self.num_classes = num_classes
        self.seed = seed
        reso = (pc_range[3] - pc_range[0]) / grid[0]
        self.occ_xyz = occ_meshgrid(pc_range, grid, reso)

    def __len__(self):
        return self.num_samples

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed + index)
        h, w = self.image_size
        imgs = rng.randn(self.num_cams, h, w, 3).astype(np.float32)
        proj = np.zeros((self.num_cams, 4, 4), np.float32)
        f = 0.6 * w
        for c in range(self.num_cams):
            intr = np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0],
                             [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
            ang = 2 * np.pi * c / self.num_cams
            rot = np.eye(4, dtype=np.float32)
            rot[:3, :3] = np.array(
                [[np.cos(ang), -np.sin(ang), 0],
                 [0, 0, -1],
                 [np.sin(ang), np.cos(ang), 0]], np.float32)
            proj[c] = intr @ rot
        occ_label = np.full(self.grid, self.num_classes - 1, np.int32)
        k = rng.randint(2000, 6000)
        xi = rng.randint(0, self.grid[0], k)
        yi = rng.randint(0, self.grid[1], k)
        zi = rng.randint(0, max(self.grid[2] // 4, 1), k)
        occ_label[xi, yi, zi] = rng.randint(1, self.num_classes - 1, k)
        mask = rng.rand(*self.grid) > 0.2
        return {
            "imgs": imgs,
            "projection_mat": proj,
            "image_wh": np.full((self.num_cams, 2), (w, h), np.float32),
            "occ_label": occ_label,
            "occ_cam_mask": mask,
            "occ_xyz": self.occ_xyz,
        }


def synthetic_batch(batch: int = 1, image_size=(864, 1600),
                    grid=(200, 200, 16), seed: int = 0,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """The flagship synthetic batch as tensors on ``device`` (CUDA unless
    the caller asks for the CPU)."""
    dev = resolve_device(device)
    ds = SyntheticOccDataset(num_samples=batch, image_size=image_size,
                             grid=grid, seed=seed)
    samples = [ds[i] for i in range(batch)]
    return {k: torch.from_numpy(np.stack([s[k] for s in samples])).to(dev)
            for k in samples[0]}


def finer_points(batch: Dict[str, torch.Tensor], factor: int = 2,
                 pc_range=(-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
                 ) -> Dict[str, torch.Tensor]:
    """``batch`` with query points that are not the splat grid: ``occ_xyz``
    the voxel centres of a grid ``factor`` times finer on each axis over
    the same range, in that grid's raster order (x slowest; 8 points a
    voxel for factor 2), and ``occ_label`` and ``occ_cam_mask`` repeated
    ``factor`` times along each axis, as such points would be labelled."""
    b, *grid = batch["occ_label"].shape
    fine = tuple(n * factor for n in grid)
    reso = (pc_range[3] - pc_range[0]) / fine[0]
    xyz = torch.from_numpy(occ_meshgrid(pc_range, fine, reso)).to(
        batch["occ_xyz"].device)

    def repeat(t):
        for axis in (1, 2, 3):
            t = t.repeat_interleave(factor, dim=axis)
        return t
    return dict(batch, occ_xyz=xyz.expand(b, *xyz.shape).contiguous(),
                occ_label=repeat(batch["occ_label"]),
                occ_cam_mask=repeat(batch["occ_cam_mask"]))


#: nuScenes' lidar, a Velodyne HDL-32E: 32 beams evenly spaced in
#: elevation over this range (degrees), mounted this high (m)
LIDAR_ELEVATION = (-30.67, 10.67)
LIDAR_HEIGHT = 1.84


def lidar_points(seed: int = 0, sweeps: int = 10, azimuths: int = 1200,
                 boxes: int = 60, speed: float = 0.5,
                 max_range: float = 100.0) -> np.ndarray:
    """A LiDAR-like query set [N, 3] float32 (ego frame, ground at z = 0),
    from ``seed`` with numpy: ``sweeps`` aggregated sweeps of a 32-beam
    spinning sensor (:data:`LIDAR_ELEVATION`, :data:`LIDAR_HEIGHT`),
    ``azimuths`` rays a beam and sweep, the ego moving ``speed`` m along x
    between sweeps. Each ray returns its nearest hit within ``max_range``
    on the ground plane or on one of ``boxes`` random axis-aligned boxes
    (vehicles and buildings) and a building's face 52 m ahead, past the
    occupancy range, with 2 cm of range noise; a ray that hits nothing
    returns nothing. Returns past the range are kept (about 350,000 points
    at the defaults): dense near the ego, and crowded in the border voxels
    where the far returns clamp (the face's into a few border tiles)."""
    rng = np.random.RandomState(seed)
    lo_hi = [(np.array([52.0, -6.0, 0.0]), np.array([60.0, 6.0, 15.0]))]
    for k in range(boxes):
        big = k % 5 == 0   # a building among vehicles
        size = (rng.uniform(8, 20, 3) * (1, 1, 0.8) if big
                else np.array([rng.uniform(3.5, 5.0), rng.uniform(1.7, 2.1),
                               rng.uniform(1.4, 2.0)]))
        while True:
            c = rng.uniform(-60, 60, 2)
            if np.abs(c).max() > size[:2].max() / 2 + 4.0:
                break
        lo = np.array([c[0] - size[0] / 2, c[1] - size[1] / 2, 0.0])
        lo_hi.append((lo, lo + size))
    box_lo = np.stack([b[0] for b in lo_hi])
    box_hi = np.stack([b[1] for b in lo_hi])
    elev = np.deg2rad(np.linspace(*LIDAR_ELEVATION, 32))
    out = []
    for s in range(sweeps):
        origin = np.array([-speed * (sweeps - 1 - s), 0.0, LIDAR_HEIGHT])
        az = (np.arange(azimuths) + rng.rand()) * (2 * np.pi / azimuths)
        e, a = np.meshgrid(elev, az, indexing="ij")
        d = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a),
                      np.sin(e)], -1).reshape(-1, 3)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(d[:, 2] < 0, -origin[2] / d[:, 2], np.inf)
            inv = 1.0 / d
            t0 = (box_lo[None] - origin) * inv[:, None]
            t1 = (box_hi[None] - origin) * inv[:, None]
        near = np.nanmax(np.minimum(t0, t1), -1)
        far = np.nanmin(np.maximum(t0, t1), -1)
        hit = (far >= near) & (near > 0)
        t = np.minimum(t, np.where(hit, near, np.inf).min(-1))
        keep = t < max_range
        t = t[keep] + rng.randn(int(keep.sum())) * 0.02
        out.append(origin + d[keep] * t[:, None])
    return np.concatenate(out).astype(np.float32)


def _yaw(a: float) -> np.ndarray:
    return np.array([[np.cos(a), -np.sin(a), 0.0],
                     [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])


def mat_to_quat(m: np.ndarray) -> Tuple[float, float, float, float]:
    """3x3 rotation -> (w, x, y, z), the inverse of
    ``data.dataset.quat_to_mat``."""
    tr = np.trace(m)
    if tr > 0:
        s = 2.0 * np.sqrt(1.0 + tr)
        q = (0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s)
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
        v = [0.0, 0.0, 0.0]
        v[i] = 0.25 * s
        v[j] = (m[j, i] + m[i, j]) / s
        v[k] = (m[k, i] + m[i, k]) / s
        q = ((m[k, j] - m[j, k]) / s, *v)
    return tuple(float(x) for x in q)


def write_nuscenes_files(root: str, num_samples: int = 2,
                         image_size: Tuple[int, int] = (900, 1600),
                         num_labels: int = 4000, seed: int = 0
                         ) -> Dict[str, str]:
    """Write a nuScenes-shaped set of ``num_samples`` keyframes under
    ``root``: six PNG images of ``image_size`` (H, W) per frame, one
    SurroundOcc [K, 4] label npy per frame (``num_labels`` distinct voxels
    in the lowest 4 of the 200 x 200 x 16 grid's 16 layers, classes 0-16)
    and the pkl of infos, written as both
    ``nuscenes_infos_train_sweeps_occ.pkl`` and ``..._val_...``. The six
    cameras sit around the lidar and look outward as the synthetic batch's
    do; the ego pose moves and turns from frame to frame. Returns the CLIs'
    ``data_root``, ``anno_root`` and ``occ_path``."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    h, w = image_size
    occ_path = os.path.join(root, "occ")
    os.makedirs(occ_path, exist_ok=True)
    f = 0.6 * w
    intrinsic = [[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]]
    lidar_t = np.array([0.94, 0.0, 1.84])
    lidar_calib = {"rotation": mat_to_quat(_yaw(-np.pi / 2)),
                   "translation": lidar_t.tolist()}
    lidar2ego = _yaw(-np.pi / 2)
    infos = []
    for i in range(num_samples):
        pose = {"rotation": mat_to_quat(_yaw(0.3 * i)),
                "translation": [600.0 + 5.0 * i, 1600.0 - 2.0 * i, 0.0]}
        frame = {"LIDAR_TOP": {
            "filename": f"samples/LIDAR_TOP/frame{i}.pcd.bin",
            "calib": lidar_calib, "pose": pose}}
        for c, cam in enumerate(CAM_TYPES):
            ang = 2 * np.pi * c / len(CAM_TYPES)
            # camera axes in the lidar frame: x right, y down, z outward
            cam2lidar = np.array([[np.cos(ang), -np.sin(ang), 0.0],
                                  [0.0, 0.0, -1.0],
                                  [np.sin(ang), np.cos(ang), 0.0]]).T
            offset = 0.5 * cam2lidar[:, 2]
            name = f"samples/{cam}/frame{i}.png"
            os.makedirs(os.path.join(root, "samples", cam), exist_ok=True)
            coarse = rng.randint(0, 256, (max(h // 16, 1), max(w // 16, 1),
                                          3)).astype(np.uint8)
            Image.fromarray(coarse).resize((w, h), Image.BILINEAR).save(
                os.path.join(root, name))
            frame[cam] = {"filename": name, "pose": pose, "calib": {
                "rotation": mat_to_quat(lidar2ego @ cam2lidar),
                "translation": (lidar_t + lidar2ego @ offset).tolist(),
                "camera_intrinsic": intrinsic}}
        infos.append({"data": frame})
        cells = rng.choice(200 * 200 * 4, num_labels, replace=False)
        xyz = np.stack(np.unravel_index(cells, (200, 200, 4)), -1)
        labels = np.concatenate(
            [xyz, rng.randint(0, 17, (num_labels, 1))], -1).astype(np.int64)
        np.save(os.path.join(occ_path, f"frame{i}.pcd.bin.npy"), labels)
    data = {"infos": {"scene-0001": infos},
            "metadata": [("scene-0001", i) for i in range(num_samples)]}
    for split in ("train", "val"):
        with open(os.path.join(
                root, f"nuscenes_infos_{split}_sweeps_occ.pkl"), "wb") as fh:
            pickle.dump(data, fh)
    return {"data_root": root, "anno_root": root, "occ_path": occ_path}
