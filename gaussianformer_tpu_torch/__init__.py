"""PyTorch + CUDA port of gaussianformer_tpu for NVIDIA Hopper.

The JAX package ``gaussianformer_tpu`` stays the reference; this package
imports nothing of it. Hand-written CUDA kernels live in ``csrc/`` with
their wrappers and plain PyTorch versions in ``kernels/``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
