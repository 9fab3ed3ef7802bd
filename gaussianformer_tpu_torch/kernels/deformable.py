"""K3 / K6: multi-camera, multi-level deformable aggregation with the
key-point sum fused, forward and backward.

Kernels: ``csrc/deformable.cu`` (K3, replaces the TPU kernel
``gaussianformer_tpu/ops/pallas/deformable_kernel.py::deformable_fused_fwd``)
and ``csrc/deformable_bwd.cu`` (K6, replaces ``deformable_fused_bwd``) on
the pixel bins of ``csrc/deformable_bin.cu``, which let it gather each
feature pixel's gradient instead of scattering it with atomics.
Plain versions: :func:`deformable_aggregation_plain`,
``gaussianformer_tpu/ops/deformable.py::deformable_aggregation`` followed
by the sum over each anchor's key points;
:func:`deformable_aggregation_backward_plain`, autograd through it;
:func:`bin_samples_plain`, the bins; and
:func:`feature_grads_from_bins_plain`, the feature gradients gathered from
the bins as K6's features launch gathers them.
:class:`DeformableAggregationFunction` ties the forward and backward
together.

Conventions of the reference op: locations are normalised (u, v) per
camera image; a location takes part only when strictly inside (0, 1) on
both axes; pixel coordinates are ``u * W - 0.5`` (align_corners=False);
bilinear corners outside the level contribute zero.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..device import constant
from . import _lib


def deformable_aggregation_plain(feature_maps, points_2d, weights,
                                 num_pts: int, chunk: int = 4096):
    """feature_maps: per level [B, cams, H_l, W_l, C]; points_2d
    [B, Q, cams, 2] with Q = P * num_pts; weights [B, Q, cams, L, G].
    Returns [B, P, C] fp32."""
    b, q, cams, _ = points_2d.shape
    num_groups = weights.shape[-1]
    c = feature_maps[0].shape[-1]
    gdim = c // num_groups
    dev = points_2d.device
    inside = ((points_2d[..., 0] > 0.0) & (points_2d[..., 0] < 1.0)
              & (points_2d[..., 1] > 0.0) & (points_2d[..., 1] < 1.0))
    cam_off = torch.arange(b * cams, device=dev).reshape(b, 1, cams, 1)
    out = torch.zeros(b, q, c, dtype=torch.float32, device=dev)
    for lvl, feat in enumerate(feature_maps):
        h, w = feat.shape[2], feat.shape[3]
        flat = feat.reshape(-1, c)
        w_im = points_2d[..., 0] * w - 0.5
        h_im = points_2d[..., 1] * h - 0.5
        h0 = torch.floor(h_im)
        w0 = torch.floor(w_im)
        lh = h_im - h0
        lw = w_im - w0
        h0 = h0.long()
        w0 = w0.long()
        hs = torch.stack([h0, h0, h0 + 1, h0 + 1], dim=-1)
        ws = torch.stack([w0, w0 + 1, w0, w0 + 1], dim=-1)
        cw = torch.stack([(1 - lh) * (1 - lw), (1 - lh) * lw,
                          lh * (1 - lw), lh * lw], dim=-1)
        valid = ((hs >= 0) & (hs <= h - 1) & (ws >= 0) & (ws <= w - 1)
                 & inside[..., None])
        cw = cw * valid                                   # [B, Q, cams, 4]
        rows = (cam_off * (h * w) + hs.clamp(0, h - 1) * w
                + ws.clamp(0, w - 1))
        # combined weight per (corner, group): [B, Q, cams, 4, G]
        wl = cw[..., None] * weights[:, :, :, lvl, None, :].float()
        for q0 in range(0, q, chunk):
            g = flat[rows[:, q0:q0 + chunk].reshape(-1)].float().reshape(
                b, -1, cams * 4, num_groups, gdim)
            wc = wl[:, q0:q0 + chunk].reshape(b, -1, cams * 4, num_groups)
            out[:, q0:q0 + chunk] += (g * wc[..., None]).sum(2).reshape(
                b, -1, c)
    return out.reshape(b, q // num_pts, num_pts, c).sum(2)


def deformable_aggregation_cuda(feature_maps, points_2d, weights,
                                num_pts: int):
    """Launch ``csrc/deformable.cu``: one warp per anchor."""
    name = "deformable_aggregation"
    b, q, cams, _ = points_2d.shape
    levels = len(feature_maps)
    g = weights.shape[-1]
    c = feature_maps[0].shape[-1]
    _lib.require_cuda(name, points_2d=points_2d, weights=weights,
                      **{f"feature_maps[{i}]": f
                         for i, f in enumerate(feature_maps)})
    _lib.require_dtype(name, "points_2d", points_2d, torch.float32)
    _lib.require_dtype(name, "weights", weights, torch.float32)
    dt = feature_maps[0].dtype
    for i, f in enumerate(feature_maps):
        _lib.require_dtype(name, f"feature_maps[{i}]", f, dt)
        if f.shape[:2] != (b, cams) or f.shape[-1] != c:
            raise ValueError(f"{name}: feature_maps[{i}] has shape "
                             f"{tuple(f.shape)}")
    _lib.require_dtype(name, "feature_maps", feature_maps[0],
                       torch.float32, torch.bfloat16)
    if weights.shape != (b, q, cams, levels, g) or q % num_pts:
        raise ValueError(f"{name}: weights has shape {tuple(weights.shape)}")
    if not 1 <= levels <= 4 or c % g or (c // g) % max(c // 32, 1):
        raise ValueError(f"{name}: unsupported levels={levels}, C={c}, G={g}")
    p = q // num_pts
    out = torch.empty(b, p, c, dtype=torch.float32, device=points_2d.device)
    ptrs = (ctypes.c_void_p * levels)(*[f.data_ptr() for f in feature_maps])
    hs = (ctypes.c_int * levels)(*[f.shape[2] for f in feature_maps])
    ws = (ctypes.c_int * levels)(*[f.shape[3] for f in feature_maps])
    code = _lib.lib().gf_deformable_forward(
        ptrs, hs, ws, levels, int(dt == torch.bfloat16),
        points_2d.data_ptr(), weights.data_ptr(), out.data_ptr(),
        b, p, num_pts, cams, c, g, _lib.stream_ptr(points_2d))
    _lib.check(code, name)
    _lib.LAUNCHES["deformable"] += 1
    return out


def _forward(feature_maps, points_2d, weights, num_pts: int):
    if points_2d.device.type == "cpu":
        return deformable_aggregation_plain(feature_maps, points_2d,
                                            weights, num_pts)
    return deformable_aggregation_cuda(feature_maps, points_2d, weights,
                                       num_pts)


def deformable_aggregation_backward_plain(feature_maps, points_2d, weights,
                                          num_pts: int, g_out):
    """(feature-map gradients in the maps' dtypes, g_points_2d,
    g_weights) of :func:`deformable_aggregation_plain`, by autograd in
    fp32: the feature gradients are summed in fp32 and cast at the end, as
    in the kernel."""
    feats = [f.detach().float().requires_grad_() for f in feature_maps]
    pts = points_2d.detach().requires_grad_()
    wts = weights.detach().requires_grad_()
    with torch.enable_grad():
        out = deformable_aggregation_plain(feats, pts, wts, num_pts)
        grads = torch.autograd.grad(out, feats + [pts, wts], g_out.float())
    return ([g.to(f.dtype) for g, f in zip(grads, feature_maps)],
            grads[-2], grads[-1])


#: ``parts`` of :func:`deformable_aggregation_backward_cuda`: its points
#: launch (g_points_2d, g_weights), its features launch (the feature
#: gradients), or both
POINTS_LAUNCH = 1
FEATURES_LAUNCH = 2
BOTH_LAUNCHES = POINTS_LAUNCH | FEATURES_LAUNCH


@dataclasses.dataclass
class DeformableBins:
    """K6's pixel bins (``csrc/deformable_bin.cu``): every corner inside
    its level of every in-image sample, listed by feature pixel.

    A pixel's key is level-major, then plane (b * cams + cam), y, x: the
    earlier levels' pixels + ``((b * cams + cam) * H_l + y) * W_l + x``.
    An entry is
    ``sample * 4 + corner`` with sample ``pair * L + l`` and pair
    ``(b * Q + q) * cams + cam``, corners in the order (y0, x0), (y0, x0+1),
    (y0+1, x0), (y0+1, x0+1). ``entries`` holds each pixel's entries in
    sample order, pixel after pixel; ``pixel_start`` [pixels + 1] the first
    of each pixel's, its last element the total. On the card ``entries``
    is the bound the shapes give (4 L entries a pair), of which the first
    ``pixel_start[-1]`` are the bins, and ``workspace_bytes`` what the
    binning needed besides; the plain bins hold the entries alone."""
    entries: torch.Tensor
    pixel_start: torch.Tensor
    level_shapes: tuple
    workspace_bytes: int = 0

    @property
    def num_entries(self) -> int:
        """The entries' total (a host read on the card)."""
        return int(self.pixel_start[-1].item())

    def stats(self) -> dict:
        """Entries, the longest pixel list and the mean list of the pixels
        that have entries (host reads)."""
        lengths = self.pixel_start.diff()
        used = int((lengths > 0).sum().item())
        e = self.num_entries
        return {"entries": e, "longest_list": int(lengths.max().item())
                if lengths.numel() else 0,
                "mean_list": e / used if used else 0.0,
                "pixels": int(lengths.numel()), "pixels_used": used}


def bin_samples_plain(points_2d, level_shapes) -> DeformableBins:
    """The plain version of ``csrc/deformable_bin.cu``: the bins of
    ``points_2d`` [B, Q, cams, 2] over levels of ``level_shapes`` (H_l,
    W_l), with the forward's gates (strictly inside (0, 1), ``u W - 0.5``,
    corners outside the level dropped)."""
    b, q, cams, _ = points_2d.shape
    levels = len(level_shapes)
    dev = points_2d.device
    u, v = points_2d[..., 0].reshape(-1), points_2d[..., 1].reshape(-1)
    inside = (u > 0) & (u < 1) & (v > 0) & (v < 1)
    pair = torch.arange(u.numel(), device=dev)
    plane = (pair // (q * cams)) * cams + pair % cams
    keys, vals, off = [], [], 0
    for lvl, (h, w) in enumerate(level_shapes):
        h0 = torch.floor(v * h - 0.5).long()
        w0 = torch.floor(u * w - 0.5).long()
        for n in range(4):
            hy, wx = h0 + (n >> 1), w0 + (n & 1)
            ok = inside & (hy >= 0) & (hy <= h - 1) & (wx >= 0) & (wx <= w - 1)
            keys.append((off + (plane * h + hy) * w + wx)[ok])
            vals.append(((pair * levels + lvl) * 4 + n)[ok])
        off += b * cams * h * w
    keys, vals = torch.cat(keys), torch.cat(vals)
    # by key, and in sample order within a key
    order = torch.argsort(keys * (4 * levels * u.numel() + 1) + vals)
    keys, vals = keys[order], vals[order]
    pixel_start = torch.searchsorted(keys, torch.arange(off + 1, device=dev))
    return DeformableBins(vals.int(), pixel_start.int(),
                          tuple(map(tuple, level_shapes)))


def bin_samples_cuda(points_2d, level_shapes) -> DeformableBins:
    """Launch ``csrc/deformable_bin.cu``: K6's pixel bins on the card, with
    no host read."""
    name = "deformable_bin"
    _lib.require_cuda(name, points_2d=points_2d)
    _lib.require_dtype(name, "points_2d", points_2d, torch.float32)
    b, q, cams, _ = points_2d.shape
    levels = len(level_shapes)
    hs = (ctypes.c_int * levels)(*[h for h, _ in level_shapes])
    ws = (ctypes.c_int * levels)(*[w for _, w in level_shapes])
    sizes = (ctypes.c_longlong * 3)()
    lib = _lib.lib()
    _lib.check(lib.gf_deformable_bin_sizes(hs, ws, levels, b, q, cams,
                                           sizes), name)
    emax, npix, words = sizes
    i32 = dict(dtype=torch.int32, device=points_2d.device)
    work = torch.empty(words, **i32)
    entries = torch.empty(emax, **i32)
    pixel_start = torch.empty(npix + 1, **i32)
    code = lib.gf_deformable_bin(
        hs, ws, levels, points_2d.data_ptr(), b, q, cams, work.data_ptr(),
        entries.data_ptr(), pixel_start.data_ptr(),
        _lib.stream_ptr(points_2d))
    _lib.check(code, name)
    _lib.LAUNCHES["deformable_bin"] += 1
    return DeformableBins(entries, pixel_start,
                          tuple(map(tuple, level_shapes)),
                          workspace_bytes=4 * words)


def feature_grads_from_bins_plain(feature_maps, points_2d, weights,
                                  num_pts: int, g_out, bins: DeformableBins):
    """The feature gradients of :func:`deformable_aggregation_plain` in
    gather form, as K6's features launch computes them: each pixel's sum of
    w[g] cw g_out[anchor] over its bins' list in order (fp32), in the maps'
    dtypes. The plain twin of that launch."""
    b, q, cams, _ = points_2d.shape
    levels = len(feature_maps)
    num_groups = weights.shape[-1]
    c = feature_maps[0].shape[-1]
    e = bins.entries[:bins.num_entries].long()
    corner, sample = e & 3, e >> 2
    lvl, pair = sample % levels, sample // levels
    uv = points_2d.reshape(-1, 2)[pair]
    shapes = constant(bins.level_shapes, torch.float32, e.device)[lvl]
    h_im = uv[:, 1] * shapes[:, 0] - 0.5
    w_im = uv[:, 0] * shapes[:, 1] - 0.5
    lh, lw = h_im - torch.floor(h_im), w_im - torch.floor(w_im)
    cw = (torch.where(corner >> 1 == 1, lh, 1 - lh)
          * torch.where(corner & 1 == 1, lw, 1 - lw))
    wg = weights.reshape(-1, num_groups)[sample].float() * cw[:, None]
    anchor = pair // (num_pts * cams)
    terms = (wg[:, :, None] * g_out.float().reshape(-1, num_groups,
                                                     c // num_groups)[anchor]
             ).reshape(-1, c)
    grads = torch.segment_reduce(terms, "sum",
                                 lengths=bins.pixel_start.diff(), axis=0,
                                 unsafe=True)
    out, off = [], 0
    for f in feature_maps:
        n = f.shape[0] * f.shape[1] * f.shape[2] * f.shape[3]
        out.append(grads[off:off + n].reshape(f.shape).to(f.dtype))
        off += n
    return out


def deformable_aggregation_backward_cuda(feature_maps, points_2d, weights,
                                         num_pts: int, g_out, bins=None,
                                         parts: int = BOTH_LAUNCHES):
    """Launch ``csrc/deformable_bwd.cu`` on the pixel bins of
    :func:`bin_samples_cuda` (built here unless given): the points launch
    (one warp an anchor) and the features launch (each pixel's gradient
    gathered from its list, summed in fp32 and written once in the maps'
    dtype). Every output is written by the kernels (``parts`` runs one
    launch alone, for timing: the other's outputs are then left unset)."""
    name = "deformable_aggregation_backward"
    b, q, cams, _ = points_2d.shape
    levels = len(feature_maps)
    g = weights.shape[-1]
    c = feature_maps[0].shape[-1]
    g_out = g_out.float().contiguous()
    _lib.require_cuda(name, points_2d=points_2d, weights=weights,
                      g_out=g_out,
                      **{f"feature_maps[{i}]": f
                         for i, f in enumerate(feature_maps)})
    _lib.require_dtype(name, "points_2d", points_2d, torch.float32)
    _lib.require_dtype(name, "weights", weights, torch.float32)
    dt = feature_maps[0].dtype
    _lib.require_dtype(name, "feature_maps", feature_maps[0],
                       torch.float32, torch.bfloat16)
    for i, f in enumerate(feature_maps):
        _lib.require_dtype(name, f"feature_maps[{i}]", f, dt)
        if f.shape[:2] != (b, cams) or f.shape[-1] != c:
            raise ValueError(f"{name}: feature_maps[{i}] has shape "
                             f"{tuple(f.shape)}")
    if weights.shape != (b, q, cams, levels, g) or q % num_pts:
        raise ValueError(f"{name}: weights has shape {tuple(weights.shape)}")
    p = q // num_pts
    if g_out.shape != (b, p, c):
        raise ValueError(f"{name}: g_out has shape {tuple(g_out.shape)}")
    shapes = tuple((f.shape[2], f.shape[3]) for f in feature_maps)
    if bins is None:
        bins = bin_samples_cuda(points_2d, shapes)
    elif bins.level_shapes != shapes:
        raise ValueError(f"{name}: bins of levels {bins.level_shapes}, "
                         f"not {shapes}")
    g_feats = [torch.empty_like(f) for f in feature_maps]
    g_pts = torch.empty_like(points_2d)
    g_wts = torch.empty_like(weights)
    ptrs = (ctypes.c_void_p * levels)(*[f.data_ptr() for f in feature_maps])
    gptrs = (ctypes.c_void_p * levels)(*[t.data_ptr() for t in g_feats])
    hs = (ctypes.c_int * levels)(*[h for h, _ in shapes])
    ws = (ctypes.c_int * levels)(*[w for _, w in shapes])
    code = _lib.lib().gf_deformable_backward(
        ptrs, gptrs, hs, ws, levels, int(dt == torch.bfloat16),
        points_2d.data_ptr(), weights.data_ptr(), g_out.data_ptr(),
        g_pts.data_ptr(), g_wts.data_ptr(), bins.entries.data_ptr(),
        bins.pixel_start.data_ptr(), b, p, num_pts, cams, c, g, parts,
        _lib.stream_ptr(points_2d))
    _lib.check(code, name)
    _lib.LAUNCHES["deformable_bwd"] += 1
    return g_feats, g_pts, g_wts


def deformable_aggregation_backward(feature_maps, points_2d, weights,
                                    num_pts: int, g_out):
    """The backward: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors."""
    if points_2d.device.type == "cpu":
        return deformable_aggregation_backward_plain(
            feature_maps, points_2d, weights, num_pts, g_out)
    return deformable_aggregation_backward_cuda(
        feature_maps, points_2d, weights, num_pts, g_out)


class DeformableAggregationFunction(torch.autograd.Function):
    """Differentiable aggregation: K3 forward, K6 backward (the plain
    versions on the CPU). Arguments: points_2d, weights, num_pts, then the
    feature maps."""

    @staticmethod
    def forward(ctx, points_2d, weights, num_pts, *feature_maps):
        ctx.num_pts = num_pts
        ctx.save_for_backward(points_2d, weights, *feature_maps)
        return _forward(list(feature_maps), points_2d, weights, num_pts)

    @staticmethod
    def backward(ctx, g_out):
        points_2d, weights, *feats = ctx.saved_tensors
        g_feats, g_pts, g_wts = deformable_aggregation_backward(
            feats, points_2d, weights, ctx.num_pts, g_out)
        return (g_pts, g_wts, None, *g_feats)


def deformable_aggregation(feature_maps, points_2d, weights, num_pts: int):
    """Deformable aggregation summed over key points, differentiable in
    every input: the plain versions for CPU tensors, the CUDA kernels for
    CUDA tensors."""
    return DeformableAggregationFunction.apply(points_2d, weights, num_pts,
                                               *feature_maps)
