"""The input pipeline's transforms on the host, in numpy and PIL
(gaussianformer_tpu/data/transforms.py, reference
dataset/transform_3d.py), with the same ``RandomState`` draws in the same
order:

  - :func:`sample_augmentation`: the augmentation parameters
    (dataset/dataset.py:68-100);
  - :func:`resize_crop_flip`: the image warp and the matching update of
    lidar2img (transform_3d.py:75-138). With the shipped configs
    (``resize_lim=(1, 1)``, ``rot_lim=(0, 0)``) only the crop and the flip
    run; PIL resizes and rotates only for other limits;
  - :func:`photometric_distortion`: brightness, contrast and HSV jitter
    (transform_3d.py:181-287);
  - :func:`normalize_images`: (img - mean) / std on RGB images (PIL loads
    RGB, so the reference's BGR -> RGB step is a no-op);
  - :func:`occ_meshgrid`, the SurroundOcc and KITTI-360 label loaders
    (transform_3d.py:474-586) and the lidar / pseudo-lidar anchor points
    of the v1 ``pts_init`` (transform_3d.py:357-470).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from .. import native


@dataclasses.dataclass
class AugConfig:
    resize: float
    resize_dims: Tuple[int, int]     # (W, H)
    crop: Tuple[int, int, int, int]  # (x0, y0, x1, y1)
    flip: bool
    rotate: float                    # degrees


def sample_augmentation(rng: np.random.RandomState, *, H: int, W: int,
                        final_dim: Tuple[int, int],
                        resize_lim: Tuple[float, float],
                        bot_pct_lim: Tuple[float, float] = (0.0, 0.0),
                        rot_lim: Tuple[float, float] = (0.0, 0.0),
                        rand_flip: bool = True,
                        test_mode: bool = False) -> AugConfig:
    """Random resize, crop, flip and rotation in training; in test mode a
    fixed resize to cover ``final_dim``, a centred crop and no draw."""
    fH, fW = final_dim
    if not test_mode:
        resize = rng.uniform(*resize_lim)
        resize_dims = (int(W * resize), int(H * resize))
        newW, newH = resize_dims
        crop_h = int((1 - rng.uniform(*bot_pct_lim)) * newH) - fH
        crop_w = int(rng.uniform(0, max(0, newW - fW)))
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip = bool(rand_flip and rng.choice([0, 1]))
        rotate = rng.uniform(*rot_lim)
    else:
        resize = max(fH / H, fW / W)
        resize_dims = (int(W * resize), int(H * resize))
        newW, newH = resize_dims
        crop_h = int((1 - np.mean(bot_pct_lim)) * newH) - fH
        crop_w = int(max(0, newW - fW) / 2)
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip = False
        rotate = 0.0
    return AugConfig(resize, resize_dims, crop, flip, rotate)


def _rot2(deg: float) -> np.ndarray:
    h = deg / 180.0 * np.pi
    return np.array([[np.cos(h), np.sin(h)], [-np.sin(h), np.cos(h)]],
                    np.float64)


def img_transform_matrix(aug: AugConfig) -> np.ndarray:
    """3x3 homography of the resize / crop / flip / rotate chain
    (transform_3d.py:112-138)."""
    ida_rot = np.eye(2) * aug.resize
    ida_tran = -np.asarray(aug.crop[:2], np.float64)
    if aug.flip:
        A = np.array([[-1.0, 0.0], [0.0, 1.0]])
        b = np.array([aug.crop[2] - aug.crop[0], 0.0])
        ida_rot = A @ ida_rot
        ida_tran = A @ ida_tran + b
    A = _rot2(aug.rotate)
    b = np.array([aug.crop[2] - aug.crop[0],
                  aug.crop[3] - aug.crop[1]]) / 2.0
    b = A @ (-b) + b
    ida_rot = A @ ida_rot
    ida_tran = A @ ida_tran + b
    m = np.eye(3)
    m[:2, :2] = ida_rot
    m[:2, 2] = ida_tran
    return m


def resize_crop_flip(imgs: Sequence[np.ndarray], aug: AugConfig,
                     lidar2img: np.ndarray):
    """Warp each camera's [H, W, 3] uint8 RGB image and compose the warp
    into its lidar2img ([N, 4, 4], not modified). Returns (uint8 images,
    new lidar2img, [(h, w)] per image)."""
    from PIL import Image

    mat4 = np.eye(4)
    mat4[:3, :3] = img_transform_matrix(aug)
    new_imgs = []
    new_l2i = lidar2img.copy()
    for i, img in enumerate(imgs):
        im = Image.fromarray(img if img.dtype == np.uint8
                             else np.uint8(img))
        if im.size != tuple(aug.resize_dims):
            im = im.resize(aug.resize_dims)
        im = im.crop(aug.crop)
        if aug.flip:
            im = im.transpose(method=Image.FLIP_LEFT_RIGHT)
        if aug.rotate:
            im = im.rotate(aug.rotate)
        new_imgs.append(np.asarray(im))
        new_l2i[i] = mat4 @ lidar2img[i]
    return new_imgs, new_l2i, [x.shape[:2] for x in new_imgs]


def _rgb_to_hsv(img):
    """RGB in [0, 255] -> HSV (H in [0, 360), S in [0, 1], V in [0, 255]):
    h = (difference of channels) * 60 / delta + the sector's offset,
    negatives wrapped by +360."""
    r = np.ascontiguousarray(img[..., 0])
    g = np.ascontiguousarray(img[..., 1])
    b = np.ascontiguousarray(img[..., 2])
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    inv = 60.0 / np.maximum(delta, 1e-12)
    h = np.where(maxc == r, (g - b) * inv,
                 np.where(maxc == g, (b - r) * inv + 120.0,
                          (r - g) * inv + 240.0))
    h = np.where(h < 0, h + 360.0, h)
    h = np.where(delta == 0, 0.0, h)
    return np.stack([h, s, v], axis=-1)


def _hsv_to_rgb(hsv):
    """The inverse without branches: channel(n) = v - v s clip(min(k, 4 -
    k), 0, 1) with k = (n + h / 60) mod 6 and n = 5, 3, 1 for r, g, b."""
    h6 = hsv[..., 0] * (1.0 / 60.0)
    s, v = hsv[..., 1], hsv[..., 2]
    vs = v * s

    def chan(n):
        k = (n + h6) % 6.0
        return v - vs * np.clip(np.minimum(k, 4.0 - k), 0.0, 1.0)

    return np.stack([chan(5.0), chan(3.0), chan(1.0)], axis=-1)


def photometric_distortion(img: np.ndarray, rng: np.random.RandomState, *,
                           brightness_delta: float = 32.0,
                           contrast_range=(0.5, 1.5),
                           saturation_range=(0.5, 1.5),
                           hue_delta: float = 18.0) -> np.ndarray:
    """The reference's PhotoMetricDistortionMultiViewImage
    (transform_3d.py:181) on one image, float32 out. The gates are drawn
    in the reference's order; the RGB -> HSV -> RGB round trip is skipped
    when neither the saturation nor the hue jitter fires."""
    img = img.astype(np.float32)
    if rng.randint(2):
        img += rng.uniform(-brightness_delta, brightness_delta)
    mode = rng.randint(2)
    if mode == 1 and rng.randint(2):
        img *= rng.uniform(*contrast_range)
    sat = rng.uniform(*saturation_range) if rng.randint(2) else None
    hue = rng.uniform(-hue_delta, hue_delta) if rng.randint(2) else None
    if sat is not None or hue is not None:
        hsv = _rgb_to_hsv(np.clip(img, 0, 255))
        if sat is not None:
            hsv[..., 1] *= sat
        if hue is not None:
            hsv[..., 0] = (hsv[..., 0] + hue) % 360.0
        img = _hsv_to_rgb(hsv)
    else:
        np.clip(img, 0, 255, out=img)
    if mode == 0 and rng.randint(2):
        img *= rng.uniform(*contrast_range)
    if rng.randint(2):
        img = np.ascontiguousarray(img[..., rng.permutation(3)])
    return img


def normalize_images(imgs: Sequence[np.ndarray], mean, std) -> np.ndarray:
    """[N, H, W, 3] float32 (img - mean) * (1 / std): uint8 images through
    the native codec, float ones in numpy (the same float32 operations)."""
    mean = np.asarray(mean, np.float32)
    inv_std = 1.0 / np.asarray(std, np.float32)
    out = np.empty((len(imgs),) + tuple(imgs[0].shape), np.float32)
    for i, im in enumerate(imgs):
        if im.dtype == np.uint8:
            out[i] = native.normalize_image(im, mean, std)
        else:
            np.subtract(im, mean, out=out[i], casting="unsafe")
            out[i] *= inv_std
    return out


def occ_meshgrid(pc_range=(-50.0, -50.0, -5.0, 50.0, 50.0, 3.0),
                 grid=(200, 200, 16), reso: float = 0.5) -> np.ndarray:
    """Voxel centres [X, Y, Z, 3] (x slowest, z fastest)."""
    axes = [np.arange(grid[i], dtype=np.float32) * reso + 0.5 * reso
            + pc_range[i] for i in range(3)]
    return np.stack(np.meshgrid(*axes, indexing="ij"),
                    axis=-1).astype(np.float32)


def load_points(pts_path: str, pc_range, num_pts: int,
                rng: Optional[np.random.RandomState] = None,
                jitter: float = 0.2) -> np.ndarray:
    """Lidar anchor points of the v1 ``pts_init`` (reference
    LoadPointFromFile, transform_3d.py:357-408): nuScenes .bin points in
    range and farther than 1 m, padded with jittered copies or subsampled
    to exactly ``num_pts``, normalised to [0, 1]^3."""
    rng = rng or np.random.RandomState(0)
    scan = np.fromfile(pts_path, dtype=np.float32).reshape(-1, 5)[:, :3]
    return _prepare_anchor_points(scan, pc_range, num_pts, rng, jitter)


def load_pseudo_points(npy_path: str, pc_range, num_pts: int,
                       ego2lidar: Optional[np.ndarray] = None,
                       rng: Optional[np.random.RandomState] = None,
                       jitter: float = 0.3) -> np.ndarray:
    """Pseudo-lidar anchor points (reference LoadPseudoPointFromFile,
    transform_3d.py:411-470)."""
    rng = rng or np.random.RandomState(0)
    scan = np.load(npy_path)
    if ego2lidar is not None:
        h = np.concatenate([scan, np.ones_like(scan[:, :1])], axis=-1)
        scan = (ego2lidar[None] @ h[..., None])[..., 0]
    return _prepare_anchor_points(scan[:, :3], pc_range, num_pts, rng,
                                  jitter)


def _prepare_anchor_points(scan, pc_range, num_pts, rng, jitter):
    norm = np.linalg.norm(scan, 2, axis=-1)
    lo = np.asarray(pc_range[:3])
    hi = np.asarray(pc_range[3:6])
    mask = np.all((scan > lo) & (scan < hi), axis=-1) & (norm > 1.0)
    scan = scan[mask]
    if scan.shape[0] == 0:
        scan = np.zeros((1, 3), np.float32)
    if scan.shape[0] < num_pts:
        multi = int(np.ceil(num_pts / scan.shape[0]))
        extra = np.repeat(scan, multi, 0)
        extra = extra + rng.randn(*extra.shape) * jitter
        extra = extra[rng.choice(extra.shape[0],
                                 num_pts - scan.shape[0], False)]
        extra = np.clip(extra, lo, hi)
        scan = np.concatenate([scan, extra], 0)
    else:
        scan = scan[rng.choice(scan.shape[0], num_pts, False)]
    return ((scan - lo) / (hi - lo)).astype(np.float32)


def load_occupancy_kitti360(label_path: str, *,
                            unknown_to_empty: bool = False,
                            training: bool = False):
    """KITTI-360 SSCBench labels (reference LoadOccupancyKITTI360,
    transform_3d.py:543-586): a dense 256 x 256 x 32 grid of 0.2 m voxels
    from [0, -25.6, -2.0], label 255 (unknown) masked out."""
    label = np.load(label_path).astype(np.int64)
    if unknown_to_empty and training:
        label[label == 255] = 0
    mask = label != 255
    xyz = occ_meshgrid((0.0, -25.6, -2.0, 51.2, 25.6, 4.4),
                       (256, 256, 32), 0.2)
    return label, mask, xyz


def load_occupancy_surroundocc(label_path: str, grid=(200, 200, 16),
                               empty_label: int = 17):
    """Sparse [K, 4] (x, y, z, class) npy -> (int32 labels, bool camera
    mask, voxel centres), decoded by the native codec. The mask marks
    labels != 0 (class 0 is "unobserved" in the SurroundOcc release,
    transform_3d.py:509)."""
    label, mask = native.decode_occupancy(np.load(label_path), grid,
                                          empty_label)
    return label, mask.astype(bool), occ_meshgrid(grid=grid)
