"""The frozen BN that follows a conv, with the block's residual and the
ReLU, as one pass over the conv's output (the frame path).

Kernel: ``csrc/bn_epilogue.cu`` (``gf_bn_epilogue``). It replaces no TPU
kernel: the JAX package leaves the BN, the residual and the ReLU to XLA,
which fuses them into its convolutions. Plain version:
:func:`bn_epilogue_plain`, the eager expressions of
``models/backbone/resnet.py`` in fp32: at fp32 the same operations in the
same order, so the same bits; on bf16 the kernel's arithmetic, rounded once.

A BN is given as ``(weight, bias, running_mean, running_var, eps)``
(``FrozenBatchNorm2d.stats()``). The epilogue computes

    y = relu(a * inv_a + shift_a [+ b | + (b * inv_b + shift_b)])

with ``(inv, shift)`` of :func:`coefficients`, where ``a`` is a conv's
output [B, C, H, W] and ``b`` the block's identity input or its downsample
conv's output. It runs where :func:`applies` says so: with gradients off,
the plain version on the CPU and the kernel on bf16 channels-last tensors
on the card. While tracing is on, each BN it applies counts one
``bn_fused``.
"""
from __future__ import annotations

import torch

from ..utils import profiling
from . import _lib


def coefficients(weight, bias, running_mean, running_var, eps):
    """(inv, shift) with bn(x) = x * inv + shift, in the statistics'
    dtype (fp32)."""
    inv = torch.rsqrt(running_var + eps) * weight
    return inv, bias - running_mean * inv


def applies(x) -> bool:
    """Whether the BNs that follow a conv of output ``x`` run in the
    epilogue: gradients off (it has no backward; the scale and bias train),
    and ``x`` on the CPU (the plain version) or bf16 on the card (the
    kernel). An fp32 tower on the card keeps PyTorch's passes."""
    return not torch.is_grad_enabled() and (not x.is_cuda
                                            or x.dtype == torch.bfloat16)


def _bn(x, bn):
    inv, shift = coefficients(*bn)
    return x.float() * inv[:, None, None] + shift[:, None, None]


def bn_epilogue_plain(a, bn_a, b=None, bn_b=None):
    """What the kernel computes, in PyTorch: fp32 arithmetic, the result in
    ``a``'s dtype."""
    y = _bn(a, bn_a)
    if b is not None:
        y = y + (b.float() if bn_b is None else _bn(b, bn_b))
    return torch.relu(y).to(a.dtype)


def _stats(name, key, bn, c, device):
    weight, bias, mean, var, eps = bn
    for t in (weight, bias, mean, var):
        if (t.dtype != torch.float32 or t.device != device
                or t.shape != (c,) or not t.is_contiguous()):
            raise ValueError(f"{name}: {key}'s statistics must be fp32 [C] "
                             f"on {device}")
    return (weight.data_ptr(), bias.data_ptr(), mean.data_ptr(),
            var.data_ptr(), float(eps))


def _activation(name, key, t, shape):
    _lib.require_dtype(name, key, t, torch.bfloat16)
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if (not t.is_contiguous(memory_format=torch.channels_last)
            or t.data_ptr() % 16):
        raise ValueError(f"{name}: {key} must be channels_last and 16-byte "
                         f"aligned")


def bn_epilogue_cuda(a, bn_a, b=None, bn_b=None):
    """Launch ``gf_bn_epilogue``: ``a`` (and ``b``) bf16 [B, C, H, W] in
    channels_last memory with C % 8 == 0 -> bf16 channels_last."""
    name = "bn_epilogue"
    if a.dim() != 4:
        raise ValueError(f"{name}: a must be [B, C, H, W]")
    shape = tuple(a.shape)
    c = shape[1]
    if c % 8:
        raise ValueError(f"{name}: needs C % 8 == 0, got {c}")
    if bn_b is not None and b is None:
        raise ValueError(f"{name}: a BN of b needs b")
    _activation(name, "a", a, shape)
    if b is not None:
        _activation(name, "b", b, shape)
        if b.device != a.device:
            raise ValueError(f"{name}: b is on {b.device}, not {a.device}")
    sa = _stats(name, "a", bn_a, c, a.device)
    sb = ((None,) * 4 + (0.0,) if bn_b is None
          else _stats(name, "b", bn_b, c, a.device))
    if not a.is_cuda:
        raise ValueError(f"{name}: a must be a CUDA tensor")
    out = torch.empty_like(a, memory_format=torch.channels_last)
    code = _lib.lib().gf_bn_epilogue(
        a.data_ptr(), None if b is None else b.data_ptr(), *sa, *sb,
        out.data_ptr(), a.numel(), c, _lib.stream_ptr(a))
    _lib.check(code, name)
    _lib.LAUNCHES["bn_epilogue"] += 1
    return out


def bn_epilogue(a, bn_a, b=None, bn_b=None):
    """The epilogue: the plain version for a tensor off the card, the
    kernel on the card. Counts its BNs in ``bn_fused``."""
    profiling.count("bn_fused", 1 if bn_b is None else 2)
    if a.is_cuda:
        return bn_epilogue_cuda(a, bn_a, b, bn_b)
    return bn_epilogue_plain(a, bn_a, b, bn_b)
