"""Checkpoints (gaussianformer_tpu/utils/checkpoint.py, reference
train.py:144-167 and 269-281): ``ckpt_{step:09d}.pt`` in the work dir,
written with ``torch.save``, and a ``latest`` file naming the newest, the
counterpart of the reference's latest.pth link for auto-resume. Both are
written to a temporary name and renamed, so a reader never sees half a
file."""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


def _write_atomic(path: str, write):
    tmp = f"{path}.tmp{os.getpid()}"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(work_dir: str, step: int, state: Dict[str, Any]) -> str:
    """Write ``state`` (tensors, numbers, strings and containers of them)
    as the checkpoint of ``step`` and point ``latest`` at it."""
    os.makedirs(work_dir, exist_ok=True)
    name = f"ckpt_{step:09d}.pt"
    path = os.path.join(os.path.abspath(work_dir), name)
    _write_atomic(path, lambda p: torch.save(state, p))

    def pointer(p):
        with open(p, "w") as f:
            f.write(name)
    _write_atomic(os.path.join(work_dir, "latest"), pointer)
    return path


def latest_checkpoint(work_dir: str) -> Optional[str]:
    """The checkpoint ``latest`` names, or None."""
    pointer = os.path.join(work_dir, "latest")
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        path = os.path.join(work_dir, f.read().strip())
    return path if os.path.exists(path) else None


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    return torch.load(path, map_location=map_location, weights_only=True)
