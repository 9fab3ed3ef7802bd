"""Synthetic batch with the input contract of the nuScenes loader, made
from a seed with numpy (a copy of gaussianformer_tpu/data/synthetic.py and
of the batch ``__graft_entry__._synthetic_batch`` stacks)."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device


def occ_meshgrid(pc_range=(-50.0, -50.0, -5.0, 50.0, 50.0, 3.0),
                 grid=(200, 200, 16), reso: float = 0.5) -> np.ndarray:
    """Voxel centres [X, Y, Z, 3] (x slowest, z fastest)."""
    axes = [np.arange(grid[i], dtype=np.float32) * reso + 0.5 * reso
            + pc_range[i] for i in range(3)]
    return np.stack(np.meshgrid(*axes, indexing="ij"),
                    axis=-1).astype(np.float32)


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
