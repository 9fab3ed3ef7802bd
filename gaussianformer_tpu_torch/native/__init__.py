"""Host-side data-path code in C++ (``occ_codec.cpp``), bound with ctypes
(gaussianformer_tpu/native/): the SurroundOcc label decode, the uint8
image normalisation and the voxel-centre meshgrid.

The source is compiled with ``g++`` at first use into
``gaussianformer_tpu_torch/_build/`` (listed in ``.gitignore``) under a
name that carries a hash of the source and flags, so an edit rebuilds;
processes that start at once build one at a time under an ``flock``.
Without ``g++`` every entry point runs its numpy version, with the same
results. Which of the two runs is logged once per process."""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger("gaussianformer_tpu_torch")

SRC = Path(__file__).resolve().parent / "occ_codec.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode()
                            + SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libocc_codec_{digest}.so"


def _build(path: Path):
    """Compile the source to ``path`` unless another process already has
    (the link goes to a per-process file, renamed into place)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, path)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32, i64, f32 = ctypes.c_int32, ctypes.c_int64, ctypes.c_float
    ptr = ctypes.POINTER
    lib.decode_occupancy.argtypes = [ptr(i32), i64, ptr(i32),
                                     ptr(ctypes.c_uint8), i64, i64, i64, i32]
    lib.normalize_image.argtypes = [ptr(ctypes.c_uint8), ptr(f32), i64,
                                    ptr(f32), ptr(f32)]
    lib.occ_meshgrid.argtypes = [ptr(f32), i64, i64, i64, f32, f32, f32,
                                 f32]
    for fn in (lib.decode_occupancy, lib.normalize_image, lib.occ_meshgrid):
        fn.restype = None
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The native library, built if needed; None where ``g++`` is absent
    or the build fails (the numpy versions run then)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if shutil.which("g++") is None:
            logger.info("native codec: no g++, the numpy versions run")
            return None
        path = library_path()
        try:
            if not path.exists():
                _build(path)
            _lib = _bind(ctypes.CDLL(str(path)))
        except (subprocess.CalledProcessError, OSError) as e:
            detail = getattr(e, "stderr", "") or e
            logger.warning("native codec: build or load failed, the numpy "
                           "versions run: %s", detail)
            return None
        logger.info("native codec: %s", path.name)
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def decode_occupancy(records: np.ndarray, grid=(200, 200, 16),
                     empty_label: int = 17):
    """Sparse [K, 4] (x, y, z, class) records -> (dense int32 labels filled
    with ``empty_label``, uint8 camera mask: label != 0). Records outside
    the grid are skipped; a later record of a voxel overwrites an
    earlier one."""
    records = np.ascontiguousarray(records, np.int32)
    if records.ndim != 2 or records.shape[1] != 4:
        raise ValueError(f"records must be [K, 4], got {records.shape}")
    x, y, z = grid
    lib = load()
    if lib is None:
        label = np.full(grid, empty_label, np.int32)
        r = records[(records[:, 0] >= 0) & (records[:, 0] < x)
                    & (records[:, 1] >= 0) & (records[:, 1] < y)
                    & (records[:, 2] >= 0) & (records[:, 2] < z)]
        label[r[:, 0], r[:, 1], r[:, 2]] = r[:, 3]
        return label, (label != 0).astype(np.uint8)
    label = np.empty(grid, np.int32)
    mask = np.empty(grid, np.uint8)
    lib.decode_occupancy(_ptr(records, ctypes.c_int32), records.shape[0],
                         _ptr(label, ctypes.c_int32),
                         _ptr(mask, ctypes.c_uint8), x, y, z, empty_label)
    return label, mask


def normalize_image(img_u8: np.ndarray, mean, std) -> np.ndarray:
    """uint8 [H, W, 3] -> float32 (img - mean) * (1 / std), in one pass."""
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    if img_u8.ndim != 3 or img_u8.shape[2] != 3:
        raise ValueError(f"image must be [H, W, 3], got {img_u8.shape}")
    mean = np.ascontiguousarray(mean, np.float32)
    inv_std = (1.0 / np.asarray(std, np.float32)).astype(np.float32)
    lib = load()
    if lib is None:
        return (img_u8.astype(np.float32) - mean) * inv_std
    out = np.empty(img_u8.shape, np.float32)
    lib.normalize_image(_ptr(img_u8, ctypes.c_uint8),
                        _ptr(out, ctypes.c_float),
                        img_u8.shape[0] * img_u8.shape[1],
                        _ptr(mean, ctypes.c_float),
                        _ptr(inv_std, ctypes.c_float))
    return out


def occ_meshgrid_native(pc_min=(-50.0, -50.0, -5.0), grid=(200, 200, 16),
                        reso: float = 0.5) -> np.ndarray:
    """Voxel centres [X, Y, Z, 3] from the grid's corner (equal to
    ``data.transforms.occ_meshgrid`` within float32 rounding)."""
    x, y, z = grid
    lib = load()
    if lib is None:
        from ..data.transforms import occ_meshgrid
        pc_range = (pc_min[0], pc_min[1], pc_min[2], pc_min[0] + x * reso,
                    pc_min[1] + y * reso, pc_min[2] + z * reso)
        return occ_meshgrid(pc_range, grid, reso)
    out = np.empty(tuple(grid) + (3,), np.float32)
    lib.occ_meshgrid(_ptr(out, ctypes.c_float), x, y, z, pc_min[0],
                     pc_min[1], pc_min[2], reso)
    return out
