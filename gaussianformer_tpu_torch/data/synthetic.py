"""Synthetic data with the input contract of the nuScenes loader, made
from a seed with numpy: the dataset and batch of
gaussianformer_tpu/data/synthetic.py and ``__graft_entry__._synthetic_batch``,
and :func:`write_nuscenes_files`, a small nuScenes-shaped set on disk for
the file pipeline (``data.dataset.NuScenesDataset``)."""
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
