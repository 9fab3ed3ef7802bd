"""nuScenes with SurroundOcc labels (gaussianformer_tpu/data/dataset.py,
reference dataset/dataset.py:13-169): the pkl's scene infos, the sorted
keyframes, each frame's camera geometry (lidar2img), the transforms of
``data.transforms`` and the model's input dict, as numpy arrays with the
JAX package's dtypes."""
from __future__ import annotations

import os
import pickle
import threading
from copy import deepcopy
from typing import Dict, Optional

import numpy as np

from . import transforms as T


def quat_to_mat(q) -> np.ndarray:
    """(w, x, y, z) -> 3x3 rotation matrix (pyquaternion's convention)."""
    w, x, y, z = [float(v) for v in q]
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _pose_mat(calib_or_pose) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = quat_to_mat(calib_or_pose["rotation"])
    m[:3, 3] = np.asarray(calib_or_pose["translation"], np.float64)
    return m


def get_sensor2global(calib, pose) -> np.ndarray:
    """sensor -> ego (``calib``) then ego -> global (``pose``) (reference
    dataset/utils.py:31-59)."""
    return _pose_mat(pose) @ _pose_mat(calib)


def get_img2global(calib, pose) -> np.ndarray:
    """camera -> global with the intrinsics: a global point is
    img2global @ [u d, v d, d, 1]."""
    viewpad = np.eye(4)
    viewpad[:3, :3] = np.asarray(calib["camera_intrinsic"], np.float64)
    return get_sensor2global(calib, pose) @ np.linalg.inv(viewpad)


CAM_TYPES = ["CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
             "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT"]


class NuScenesDataset:
    """``imageset``: a pkl of ``{"infos": {scene: [frame info, ...]},
    "metadata": [(scene, frame index), ...]}``; ``occ_path``: one SurroundOcc
    npy per frame, named after its lidar file. ``phase="train"`` draws
    augmentations (and photometric distortion) from the dataset's
    ``RandomState(seed)``; any other phase draws none."""

    def __init__(self, data_root: str, imageset: str, occ_path: str,
                 data_aug_conf: Optional[dict] = None, phase: str = "train",
                 img_norm: Optional[dict] = None, photometric: bool = True,
                 seed: int = 0):
        with open(imageset, "rb") as f:
            data = pickle.load(f)
        self.scene_infos = data["infos"]
        self.keyframes = sorted(
            data["metadata"], key=lambda x: x[0] + "{:0>3}".format(str(x[1])))
        self.data_root = data_root
        self.occ_path = occ_path
        self.data_aug_conf = data_aug_conf
        self.test_mode = phase != "train"
        self.photometric = photometric and not self.test_mode
        self.img_norm = img_norm or dict(
            mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375))
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        # the shared RandomState gives each sample one seed under this lock;
        # the sample then draws its augmentations from its own stream
        self._rng_lock = threading.Lock()

    def __getstate__(self):
        # a loader's worker processes get a copy without the lock
        state = dict(self.__dict__)
        del state["_rng_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._rng_lock = threading.Lock()

    def __len__(self):
        return len(self.keyframes)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        scene_token, idx = self.keyframes[index]
        info = deepcopy(self.scene_infos[scene_token][idx])
        lidar = info["data"]["LIDAR_TOP"]
        lidar2global = get_sensor2global(lidar["calib"], lidar["pose"])

        imgs, lidar2img = [], []
        for cam in CAM_TYPES:
            path = os.path.join(self.data_root, info["data"][cam]["filename"])
            with Image.open(path) as im:
                imgs.append(np.asarray(im.convert("RGB")))
            img2global = get_img2global(info["data"][cam]["calib"],
                                        info["data"][cam]["pose"])
            lidar2img.append(np.linalg.inv(img2global) @ lidar2global)
        lidar2img = np.asarray(lidar2img)

        label_file = os.path.join(
            self.occ_path, lidar["filename"].split("/")[-1] + ".npy")
        occ_label, occ_cam_mask, occ_xyz = T.load_occupancy_surroundocc(
            label_file)

        with self._rng_lock:
            rng = np.random.RandomState(self.rng.randint(2 ** 31))

        if self.data_aug_conf is not None:
            conf = self.data_aug_conf
            aug = T.sample_augmentation(
                rng, H=conf["H"], W=conf["W"], final_dim=conf["final_dim"],
                resize_lim=conf["resize_lim"],
                bot_pct_lim=conf.get("bot_pct_lim", (0.0, 0.0)),
                rot_lim=conf.get("rot_lim", (0.0, 0.0)),
                rand_flip=conf.get("rand_flip", True),
                test_mode=self.test_mode)
            imgs, lidar2img, shapes = T.resize_crop_flip(imgs, aug, lidar2img)
        else:
            shapes = [im.shape[:2] for im in imgs]
        if self.photometric:
            imgs = [T.photometric_distortion(im, rng) for im in imgs]
        img = T.normalize_images(imgs, **self.img_norm)

        return {
            "imgs": img,                                   # [6, H, W, 3]
            "projection_mat": lidar2img.astype(np.float32),
            "image_wh": np.asarray(shapes, np.float32)[:, ::-1].copy(),
            "occ_label": occ_label.astype(np.int32),
            "occ_cam_mask": occ_cam_mask,
            "occ_xyz": occ_xyz,
        }
