"""K1: modulated deformable convolution v2 (3x3, stride 1, pad 1), forward.

Kernel: ``csrc/dcn.cu`` (replaces the TPU kernel
``gaussianformer_tpu/ops/pallas/dcn_kernel.py::deform_conv2d_pallas_fwd``).
Plain version: :func:`deform_conv2d_plain`, the gather form of
``gaussianformer_tpu/ops/dcn.py::deform_conv2d``.

Layouts follow the JAX package: ``x`` NHWC, ``offset`` [B, H, W, 18] with
(dy, dx) per tap (tap t = ky * 3 + kx), ``mask`` [B, H, W, 9] already
sigmoided, ``weight`` HWIO [3, 3, C_in, C_out]. ``epilogue=(inv, shift)``
fuses the frozen BN that follows the conv, and its ReLU.
"""
from __future__ import annotations

import torch

from . import _lib


def deform_conv2d_plain(x, offset, mask, weight, epilogue=None,
                        rows: int = 8):
    """Exact gather formulation, chunked over ``rows`` output rows.

    Samples are summed in fp32, rounded to ``x.dtype`` (as the kernel
    feeds its bf16 MMAs) and contracted with the weights in fp32."""
    b, h, w, cin = x.shape
    cout = weight.shape[-1]
    dev = x.device
    f32 = torch.float32
    off = offset.float().reshape(b, h, w, 9, 2)
    ty = torch.arange(3, device=dev, dtype=f32).repeat_interleave(3)
    tx = torch.arange(3, device=dev, dtype=f32).repeat(3)
    gy = (torch.arange(h, device=dev, dtype=f32) - 1.0)[:, None, None] + ty
    gx = (torch.arange(w, device=dev, dtype=f32) - 1.0)[None, :, None] + tx
    sy = gy + off[..., 0]
    sx = gx + off[..., 1]
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    ly = sy - y0
    lx = sx - x0
    y0 = y0.long()
    x0 = x0.long()
    ys = torch.stack([y0, y0, y0 + 1, y0 + 1], dim=-1)
    xs = torch.stack([x0, x0 + 1, x0, x0 + 1], dim=-1)
    cw = torch.stack([(1 - ly) * (1 - lx), (1 - ly) * lx,
                      ly * (1 - lx), ly * lx], dim=-1)
    valid = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    cwm = cw * valid * mask.float()[..., None]           # [B, H, W, 9, 4]
    idx = (ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)
           + (torch.arange(b, device=dev) * (h * w))[:, None, None, None,
                                                     None])
    x_flat = x.reshape(b * h * w, cin)
    w_mat = weight.reshape(9 * cin, cout).float()
    out = torch.empty(b, h, w, cout, dtype=f32, device=dev)
    for r0 in range(0, h, rows):
        ic = idx[:, r0:r0 + rows]
        g = x_flat[ic.reshape(-1)].float().reshape(*ic.shape, cin)
        v = (g * cwm[:, r0:r0 + rows, ..., None]).sum(-2)
        v = v.to(x.dtype).float()
        out[:, r0:r0 + rows] = (v.reshape(-1, 9 * cin) @ w_mat).reshape(
            b, -1, w, cout)
    if epilogue is not None:
        inv, shift = epilogue
        out = torch.relu(out * inv.float() + shift.float())
    return out.to(x.dtype)


def _pixel_stride(name, key, t, b, h, w, ch):
    """Row stride of a [B, H, W, ch] float32 view whose pixels are evenly
    spaced rows (e.g. a channel slice of the offset conv's output)."""
    _lib.require_dtype(name, key, t, torch.float32)
    if tuple(t.shape) != (b, h, w, ch):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                         f"expected {(b, h, w, ch)}")
    s = t.stride(2)
    if t.stride(3) != 1 or t.stride(1) != w * s or t.stride(0) != h * w * s:
        raise ValueError(f"{name}: {key} must hold dense pixel rows")
    return s


def deform_conv2d_cuda(x, offset, mask, weight, epilogue=None):
    """Launch ``csrc/dcn.cu``: bf16 ``x`` and ``weight``, fp32 offset and
    mask; returns bf16 [B, H, W, C_out]."""
    name = "deform_conv2d"
    b, h, w, cin = x.shape
    cout = weight.shape[-1]
    _lib.require_cuda(name, x=x, weight=weight)
    _lib.require_dtype(name, "x", x, torch.bfloat16)
    _lib.require_dtype(name, "weight", weight, torch.bfloat16)
    if tuple(weight.shape) != (3, 3, cin, cout):
        raise ValueError(f"{name}: weight has shape {tuple(weight.shape)}")
    if cin % 64 or cout % 8:
        raise ValueError(f"{name}: needs C_in % 64 == 0 and C_out % 8 == 0,"
                         f" got {cin}, {cout}")
    if offset.device != x.device or mask.device != x.device:
        raise ValueError(f"{name}: offset and mask must be on {x.device}")
    s_off = _pixel_stride(name, "offset", offset, b, h, w, 18)
    s_mask = _pixel_stride(name, "mask", mask, b, h, w, 9)
    inv = shift = None
    if epilogue is not None:
        inv, shift = (t.float().contiguous() for t in epilogue)
        _lib.require_cuda(name, inv=inv, shift=shift)
        if inv.shape != (cout,) or shift.shape != (cout,):
            raise ValueError(f"{name}: epilogue must be two [C_out] tensors")
    out = torch.empty(b, h, w, cout, dtype=torch.bfloat16, device=x.device)
    code = _lib.lib().gf_dcn_forward(
        x.data_ptr(), offset.data_ptr(), s_off, mask.data_ptr(), s_mask,
        weight.data_ptr(), None if inv is None else inv.data_ptr(),
        None if shift is None else shift.data_ptr(), out.data_ptr(),
        b, h, w, cin, cout, _lib.stream_ptr(x))
    _lib.check(code, name)
    _lib.LAUNCHES["dcn"] += 1
    return out


def deform_conv2d(x, offset, mask, weight, epilogue=None):
    """DCNv2 forward: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors."""
    if x.device.type == "cpu":
        return deform_conv2d_plain(x, offset, mask, weight, epilogue)
    return deform_conv2d_cuda(x, offset, mask, weight, epilogue)
