"""K1 / K5: modulated deformable convolution v2 (3x3, stride 1, pad 1),
forward and backward.

Kernels: ``csrc/dcn.cu`` (K1, replaces the TPU kernel
``gaussianformer_tpu/ops/pallas/dcn_kernel.py::deform_conv2d_pallas_fwd``)
and ``csrc/dcn_bwd.cu`` (K5, replaces ``deform_conv2d_pallas_bwd``).
Plain versions: :func:`deform_conv2d_plain`, the gather form of
``gaussianformer_tpu/ops/dcn.py::deform_conv2d``, and
:func:`deform_conv2d_backward_plain`, autograd through it.
:class:`DeformConv2dFunction` ties the two together for training.

Layouts follow the JAX package: ``x`` NHWC, ``offset`` [B, H, W, 18] with
(dy, dx) per tap (tap t = ky * 3 + kx), ``mask`` [B, H, W, 9] already
sigmoided, ``weight`` HWIO [3, 3, C_in, C_out]. ``epilogue=(inv, shift)``
fuses the frozen BN that follows the conv, and its ReLU.
"""
from __future__ import annotations

import ctypes

import torch

from . import _lib

#: the g_x window of ``csrc/dcn_bwd.cu``'s input-gradient launch (mirrors
#: its TH, TW, HALO and WCELLS): a block owns a TILE_H x TILE_W tile of
#: output pixels and sums g_x on chip over the first WINDOW_CELLS cells, in
#: raster order, of the tile and WINDOW_HALO pixels around it; other
#: corners in the image become fallback records
TILE_H, TILE_W, WINDOW_HALO, WINDOW_CELLS = 8, 8, 3, 192
#: K5's launches, as ``parts`` bits of :func:`deform_conv2d_backward_cuda`
#: in the order they run: the input launch, the weight launch, the g_offset
#: / g_mask sums over the channel chunks, the fallback records' bins, g_x
#: (each pixel's windows and fallback list), g_W (the splits' sum)
(INPUT_LAUNCH, WEIGHT_LAUNCH, OM_LAUNCH, BINS_LAUNCH, GX_LAUNCH,
 WSUM_LAUNCH) = 1, 2, 4, 8, 16, 32
#: the launches that make g_x, g_offset and g_mask, those that make g_W
INPUT_GRADS = INPUT_LAUNCH | OM_LAUNCH | BINS_LAUNCH | GX_LAUNCH
WEIGHT_GRADS = WEIGHT_LAUNCH | WSUM_LAUNCH


def deform_conv2d_plain(x, offset, mask, weight, epilogue=None,
                        rows: int = 8, sample_dtype=None):
    """Exact gather formulation, chunked over ``rows`` output rows.

    Samples are summed in fp32, rounded to ``sample_dtype`` (``x.dtype`` by
    default, as the kernel feeds its bf16 MMAs) and contracted with the
    weights in fp32. The rounding passes gradients straight through, so
    autograd through this function sums in fp32 as the backward kernel
    does."""
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
        v = v + (v.to(sample_dtype or x.dtype).float() - v).detach()
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


def deform_conv2d_backward_plain(x, offset, mask, weight, g_out):
    """(g_x, g_offset, g_mask, g_weight) of :func:`deform_conv2d_plain`
    without the epilogue, by autograd through it in fp32 (samples rounded
    to ``x.dtype`` as in the forward). g_x and g_weight come back in the
    dtypes of x and weight, g_offset and g_mask in fp32, as from the
    kernel."""
    leaves = [t.detach().float().requires_grad_()
              for t in (x, offset, mask, weight)]
    with torch.enable_grad():
        out = deform_conv2d_plain(*leaves, sample_dtype=x.dtype)
        g_x, g_off, g_mask, g_w = torch.autograd.grad(out, leaves,
                                                      g_out.float())
    return g_x.to(x.dtype), g_off, g_mask, g_w.to(weight.dtype)


def backward_sizes(b, h, w, cin, cout) -> tuple:
    """K5's (workspace words, the weight launch's splits, the fallback
    records' bound) for x [b, h, w, cin] -> cout (``gf_dcn_backward_sizes``;
    the splits follow the card's SM count)."""
    out = (ctypes.c_longlong * 3)()
    _lib.check(_lib.lib().gf_dcn_backward_sizes(b, h, w, cin, cout, out),
               "deform_conv2d_backward")
    return tuple(out)


def backward_workspace(x, cout):
    """A workspace for K5 on ``x`` -> ``cout`` channels (4-byte words)."""
    b, h, w, cin = x.shape
    return torch.empty(backward_sizes(b, h, w, cin, cout)[0],
                       dtype=torch.int32, device=x.device)


def deform_conv2d_backward_cuda(x, offset, mask, weight, g_out,
                                parts=INPUT_GRADS | WEIGHT_GRADS,
                                workspace=None, out=None):
    """Launch ``csrc/dcn_bwd.cu``: bf16 ``x``, ``weight`` and ``g_out``
    (C_out up to 512); returns g_x and g_weight in bf16 (summed in fp32),
    g_offset and g_mask in fp32, the same bits on every call. ``parts``
    selects the launches (a gradient whose last launch is left out comes
    back zero), so that each can be timed alone on a ``workspace``
    (:func:`backward_workspace`) that a whole call filled; by default the
    call allocates its own. ``out``: the four fp32 outputs (g_x
    [B, H, W, C_in], g_offset, g_mask, g_weight [9 C_in, C_out]) to write
    and return as they are, so that a launch is timed with no allocation
    or cast."""
    name = "deform_conv2d_backward"
    b, h, w, cin = x.shape
    cout = weight.shape[-1]
    g_out = g_out.contiguous()
    _lib.require_cuda(name, x=x, weight=weight, g_out=g_out)
    for key, t in (("x", x), ("weight", weight), ("g_out", g_out)):
        _lib.require_dtype(name, key, t, torch.bfloat16)
    if tuple(weight.shape) != (3, 3, cin, cout):
        raise ValueError(f"{name}: weight has shape {tuple(weight.shape)}")
    if tuple(g_out.shape) != (b, h, w, cout):
        raise ValueError(f"{name}: g_out has shape {tuple(g_out.shape)}")
    if cin % 64 or cout % 8 or cout > 512:
        raise ValueError(f"{name}: needs C_in % 64 == 0, C_out % 8 == 0 and"
                         f" C_out <= 512, got {cin}, {cout}")
    if offset.device != x.device or mask.device != x.device:
        raise ValueError(f"{name}: offset and mask must be on {x.device}")
    s_off = _pixel_stride(name, "offset", offset, b, h, w, 18)
    s_mask = _pixel_stride(name, "mask", mask, b, h, w, 9)
    f32 = dict(dtype=torch.float32, device=x.device)

    def alloc(shape, launch):
        # written whole by its launch, zero where that launch is left out
        return (torch.empty if parts & launch else torch.zeros)(shape, **f32)
    if out is None:
        g_x, g_offset, g_mask, g_w = (
            alloc((b, h, w, cin), GX_LAUNCH), alloc((b, h, w, 18), OM_LAUNCH),
            alloc((b, h, w, 9), OM_LAUNCH),
            alloc((9 * cin, cout), WSUM_LAUNCH))
    else:
        g_x, g_offset, g_mask, g_w = out
        _lib.require_cuda(name, g_x=g_x, g_offset=g_offset, g_mask=g_mask,
                          g_w=g_w)
        for key, t, shape in (("g_x", g_x, (b, h, w, cin)),
                              ("g_offset", g_offset, (b, h, w, 18)),
                              ("g_mask", g_mask, (b, h, w, 9)),
                              ("g_w", g_w, (9 * cin, cout))):
            _lib.require_dtype(name, key, t, torch.float32)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: out {key} has shape "
                                 f"{tuple(t.shape)}, expected {shape}")
    if workspace is None:
        workspace = backward_workspace(x, cout)
    elif (workspace.numel() * workspace.element_size()
          < 4 * backward_sizes(b, h, w, cin, cout)[0]):
        raise ValueError(f"{name}: the workspace is too small")
    _lib.require_cuda(name, x=x, workspace=workspace)
    code = _lib.lib().gf_dcn_backward_parts(
        x.data_ptr(), offset.data_ptr(), s_off, mask.data_ptr(), s_mask,
        weight.data_ptr(), g_out.data_ptr(), g_x.data_ptr(),
        g_offset.data_ptr(), g_mask.data_ptr(), g_w.data_ptr(),
        workspace.data_ptr(), b, h, w, cin, cout, parts,
        _lib.stream_ptr(x))
    _lib.check(code, name)
    if parts:
        _lib.LAUNCHES["dcn_bwd"] += 1
    if out is not None:
        return out
    return (g_x.to(x.dtype), g_offset, g_mask,
            g_w.reshape(weight.shape).to(weight.dtype))


def deform_conv2d_backward(x, offset, mask, weight, g_out):
    """DCNv2 backward: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors."""
    if x.device.type == "cpu":
        return deform_conv2d_backward_plain(x, offset, mask, weight, g_out)
    return deform_conv2d_backward_cuda(x, offset, mask, weight, g_out)


def window_outside_share(offset) -> tuple[float, int]:
    """Of the bilinear corners inside the image that the samples of
    ``offset`` [B, H, W, 18] reach, the share that lies outside the g_x
    window of the output pixel's tile (and so becomes one of the backward
    kernel's fallback records, as do the corners past a full bucket), and
    the count of corners in the image."""
    b, h, w, _ = offset.shape
    dev = offset.device
    off = offset.detach().float().reshape(b, h, w, 9, 2)
    tap = torch.arange(9, device=dev)
    yy = torch.arange(h, device=dev)[:, None, None]
    xx = torch.arange(w, device=dev)[None, :, None]
    y0 = torch.floor((yy - 1 + tap // 3) + off[..., 0]).long()
    x0 = torch.floor((xx - 1 + tap % 3) + off[..., 1]).long()
    cy = torch.stack([y0, y0, y0 + 1, y0 + 1], -1)
    cx = torch.stack([x0, x0 + 1, x0, x0 + 1], -1)
    inside = (cy >= 0) & (cy <= h - 1) & (cx >= 0) & (cx <= w - 1)
    wy = cy - ((yy // TILE_H) * TILE_H - WINDOW_HALO)[..., None]
    wx = cx - ((xx // TILE_W) * TILE_W - WINDOW_HALO)[..., None]
    ww = TILE_W + 2 * WINDOW_HALO
    in_win = ((wy >= 0) & (wy < TILE_H + 2 * WINDOW_HALO) & (wx >= 0)
              & (wx < ww) & (wy * ww + wx < WINDOW_CELLS))
    n = int(inside.sum())
    return int((inside & ~in_win).sum()) / max(n, 1), n


class DeformConv2dFunction(torch.autograd.Function):
    """DCNv2 without the epilogue, differentiable: K1 forward, K5
    backward (the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight):
        ctx.save_for_backward(x, offset, mask, weight)
        return deform_conv2d(x, offset, mask, weight)

    @staticmethod
    def backward(ctx, g_out):
        return deform_conv2d_backward(*ctx.saved_tensors, g_out)
