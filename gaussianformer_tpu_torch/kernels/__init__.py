"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
PyTorch versions. A wrapper launches its kernel for CUDA tensors and runs
the plain version only for CPU tensors."""
from ._lib import LAUNCHES, reset_launches

__all__ = ["LAUNCHES", "reset_launches"]
