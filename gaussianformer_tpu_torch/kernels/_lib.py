"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, which is loaded with
``ctypes``: one ``nvcc -c`` per source, all started together, then one
link. The library name carries a hash of the sources and flags, so an edit
rebuilds and a stale build is never loaded. The build goes to
``gaussianformer_tpu_torch/_build/`` (listed in ``.gitignore``). Processes
that start at once (test workers, a script beside them) build one at a
time: an ``flock`` on ``_build/build.lock`` is held from the check for the
library to its link, so no process compiles over another's objects.

Every wrapper counts its launches in :data:`LAUNCHES` (one per kernel
launch, nowhere else), so a run can show which kernels its path went
through.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES = {"dcn": 0, "fps": 0, "deformable": 0, "splat_bin": 0,
            "splat": 0, "splat_additive": 0, "dcn_bwd": 0,
            "deformable_bin": 0, "deformable_bwd": 0, "splat_bwd": 0,
            "splat_bwd_additive": 0}

_lock = threading.Lock()
_lib = None
#: ptxas register/spill report of the build that made the loaded library
#: (kept beside it, so a later process that loads it reads the same report)
BUILD_LOG = ""


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built with the CUDA toolkit's nvcc")
    return path


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` (if not already built) and return the
    library path."""
    global BUILD_LOG
    sources = sorted(CSRC_DIR.glob("*.cu"))
    lib_path = BUILD_DIR / f"libgf_kernels_{_digest(sources)}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        BUILD_LOG = log_path.read_text() if log_path.exists() else ""
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        # released when the file closes, or when a killed process's does
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            _compile_and_link(sources, lib_path, log_path)
    BUILD_LOG = log_path.read_text() if log_path.exists() else ""
    return lib_path


def _compile_and_link(sources, lib_path: Path, log_path: Path):
    """One ``nvcc -c`` per source, all started together, then the link
    into a per-process file that is renamed onto ``lib_path``. Called
    with the build lock held."""
    nvcc = _nvcc()
    obj_dir = BUILD_DIR / f"obj_{lib_path.stem}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    tmp = lib_path.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         "-o", str(tmp)] + [str(o) for _, o, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    log_path.write_text(log)
    os.replace(tmp, lib_path)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def _bind(so: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.gf_error_string.argtypes = [I]
    so.gf_error_string.restype = ctypes.c_char_p
    so.gf_dcn_forward.argtypes = [P, P, I, P, I, P, P, P, P,
                                  I, I, I, I, I, P]
    so.gf_dcn_forward.restype = I
    so.gf_fps_forward.argtypes = [P, P, P, I, I, P, P]
    so.gf_fps_forward.restype = I
    so.gf_fps_cluster_size.argtypes = []
    so.gf_fps_cluster_size.restype = I
    so.gf_fps_forward_ordered.argtypes = [P, P, P, P, I, I, P, I, P]
    so.gf_fps_forward_ordered.restype = I
    so.gf_fps_step_floor.argtypes = [I, P, I, P]
    so.gf_fps_step_floor.restype = I
    so.gf_deformable_forward.argtypes = [
        ctypes.POINTER(P), ctypes.POINTER(I), ctypes.POINTER(I), I, I,
        P, P, P, I, I, I, I, I, I, P]
    so.gf_deformable_forward.restype = I
    so.gf_splat_forward.argtypes = [P, P, P, P, I, I, I, I, P, P, P,
                                    P, P, P, I, F, I, P]
    so.gf_splat_forward.restype = I
    so.gf_dcn_backward.argtypes = [P, P, I, P, I, P, P, P, P, P, P, P,
                                   I, I, I, I, I, P]
    so.gf_dcn_backward.restype = I
    so.gf_dcn_backward_parts.argtypes = [P, P, I, P, I, P, P, P, P, P, P,
                                         P, I, I, I, I, I, I, P]
    so.gf_dcn_backward_parts.restype = I
    so.gf_dcn_backward_sizes.argtypes = [I, I, I, I, I,
                                         ctypes.POINTER(ctypes.c_longlong)]
    so.gf_dcn_backward_sizes.restype = I
    so.gf_deformable_backward.argtypes = [
        ctypes.POINTER(P), ctypes.POINTER(P), ctypes.POINTER(I),
        ctypes.POINTER(I), I, I, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
        P]
    so.gf_deformable_backward.restype = I
    so.gf_deformable_bin_sizes.argtypes = [
        ctypes.POINTER(I), ctypes.POINTER(I), I, I, I, I,
        ctypes.POINTER(ctypes.c_longlong)]
    so.gf_deformable_bin_sizes.restype = I
    so.gf_deformable_bin.argtypes = [ctypes.POINTER(I), ctypes.POINTER(I), I,
                                     P, I, I, I, P, P, P, P]
    so.gf_deformable_bin.restype = I
    so.gf_splat_backward.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I,
                                     P, P, P, P, P, P, P, P, P, P, I, P]
    so.gf_splat_backward.restype = I
    so.gf_splat_forward_additive.argtypes = [P, P, P, P, I, I, I, I, P, P,
                                             P, P, P, P]
    so.gf_splat_forward_additive.restype = I
    so.gf_splat_backward_additive.argtypes = [P, P, P, P, P, P, I, I, I, I,
                                              I, P, P, P, P, P, P, P, P, P,
                                              P, I, P]
    so.gf_splat_backward_additive.restype = I
    so.gf_splat_tile_dims.argtypes = [ctypes.POINTER(I)]
    so.gf_splat_tile_dims.restype = None
    L = ctypes.c_longlong
    so.gf_splat_bin_sizes.argtypes = [I, I, I, I, L, ctypes.POINTER(L)]
    so.gf_splat_bin_sizes.restype = I
    so.gf_splat_bin.argtypes = [P, I, P, I, ctypes.POINTER(F), F, I, I, I, L,
                                P, P, P, P, P, P, P, P, P]
    so.gf_splat_bin.restype = I
    return so


def check(code: int, name: str):
    """Raise if a kernel's C entry point returned an error."""
    if code == 0:
        return
    if code == -1:
        raise RuntimeError(f"{name}: unsupported shape for the CUDA kernel")
    msg = lib().gf_error_string(code).decode()
    raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, **tensors):
    """Validate device and contiguity of the tensors a kernel reads or
    writes through raw pointers."""
    dev = None
    for key, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} must be a CUDA tensor")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def require_dtype(name: str, key: str, t: torch.Tensor, *dtypes):
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: {key} has dtype {t.dtype}, "
                         f"expected one of {dtypes}")
