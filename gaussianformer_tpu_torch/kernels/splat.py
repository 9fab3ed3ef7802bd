"""K4 / K7: Gaussian -> voxel splat with the final-occ label epilogue, and
its backward, in the two variants of the JAX package: ``prob`` (the
GaussianFormer-2 GMM superposition) and ``additive`` (the v1 models' plain
sum of opacity-weighted semantics).

Kernels: ``csrc/splat.cu`` (K4, replaces the TPU kernel
``gaussianformer_tpu/ops/pallas/splat_kernel.py::splat_raw_pallas`` with
``emit_labels``) and ``csrc/splat_bwd.cu`` (K7, replaces
``gaussianformer_tpu/ops/pallas/splat_bwd_kernel.py::splat_bwd_raw_pallas``).
Plain versions: :func:`splat_accumulate_plain`, a chunked dense form of
``gaussianformer_tpu/ops/splat.py::splat_dense_reference`` (with the
exponent clamp of ``_chunk_step``) plus :func:`labels_from_acc`, the
epilogue of ``_postprocess_prob`` and ``_labels_xla``; and
:func:`splat_backward_plain`, a chunked port of ``_splat_bwd_single``.

Inputs are the packed tables of ``ops/splat.py::pack_gaussians``:
``gdata`` [P, 9] = (mean, inverse covariance [xx, yy, zz, xy, yz, xz]),
``box`` [P, 6] int32 = (voxel lo xyz, voxel hi xyz) of each Gaussian's
AABB, ``sem_aug`` [P, C + 2] = (sem * w, w, 1), with w = (2 pi)^-1.5
sqrt(det A) opa for ``prob`` and w = opa for ``additive``. Outputs per
point: ``acc`` [N, C + 2] (semantic sums, sum of w e, density),
``one_minus`` [N] = prod(1 - e) (``prob``; None for ``additive``) and
``labels`` [N] int32: for ``prob`` by one of two label modes (keyword
``label_mode``; a mode of the epilogue, not a splat variant), combine_geosem's
argmax (``"combine"``) or the normalised semantics' argmax where the
occupancy exceeds ``thresh`` and ``empty_label`` elsewhere (``"threshold"``);
for ``additive`` the first-index argmax of the raw sums (0 where no box
holds the voxel). ``grid`` is an ``ops.splat.SplatGridSpec``.

Both kernels take the points as the raster voxel grid and the Gaussians
binned by voxel tile (:class:`SplatBins`, built on the card by
``csrc/splat_bin.cu`` through :func:`bin_gaussians_cuda`; plain version
:func:`bin_gaussians_plain`). The forward builds the bins, the autograd
function keeps them for the backward. The card's bins are sized by a bound
(:func:`entries_bound`) and read nothing back to the host while a CUDA
graph is captured: their flag word (points not the raster grid, entries
past the bound) is then checked after a replay
(:func:`check_deferred_flags`), and at once in an eager call.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ..device import constant
from . import _lib


def postprocess_prob(acc, one_minus):
    """(acc [N, C + 2], one_minus [N]) -> (logits, bin_logits, density):
    GMM normalisation with the uniform fallback when the probability sum
    is <= 1e-9."""
    c = acc.shape[-1] - 2
    prob_sum = acc[:, c]
    covered = prob_sum > 1e-9
    denom = torch.where(covered, prob_sum, torch.ones_like(prob_sum))
    uniform = constant((1.0 / (c - 1),) * (c - 1) + (0.0,), acc.dtype,
                       acc.device)
    logits = torch.where(covered[:, None], acc[:, :c] / denom[:, None],
                         uniform)
    return logits, 1.0 - one_minus, acc[:, c + 1]


def combine_geosem(logits, bins):
    """[sem * bin, 1 - bin]: semantics over the occupied probability."""
    return torch.cat([logits[..., :-1] * bins[..., None],
                      1.0 - bins[..., None]], dim=-1)


VARIANTS = ("prob", "additive")
LABEL_MODES = ("combine", "threshold")


def _check_variant(variant: str, label_mode: str = "combine"):
    if variant not in VARIANTS:
        raise ValueError(f"splat variant {variant!r} is not one of "
                         f"{VARIANTS}")
    if label_mode not in LABEL_MODES:
        raise ValueError(f"label mode {label_mode!r} is not one of "
                         f"{LABEL_MODES}")
    if variant == "additive" and label_mode != "combine":
        raise ValueError("the additive splat has one label rule: pass no "
                         "label_mode")


def labels_from_acc(acc, one_minus=None, mode: str = "combine",
                    thresh: float = 0.5, empty_label: int = 17):
    """Final-occ labels [N] int32 from acc [N, C + 2], all first-index
    argmaxes. With ``one_minus`` [N] (prob) the semantics are normalised
    (uniform fallback) and ``mode`` picks the rule: ``"combine"``, the
    argmax of combine_geosem; ``"threshold"``, the argmax of the C
    normalised lanes where 1 - one_minus > ``thresh`` (strictly), else
    ``empty_label``. Without (additive): the argmax of the raw sums."""
    if one_minus is None:
        return torch.argmax(acc[:, :-2], dim=-1).to(torch.int32)
    logits, bins, _ = postprocess_prob(acc, one_minus)
    if mode == "combine":
        return torch.argmax(combine_geosem(logits, bins),
                            dim=-1).to(torch.int32)
    sem = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.where(bins > thresh, sem,
                       torch.full_like(sem, empty_label))


def splat_accumulate_plain(points, gdata, box, sem_aug, grid,
                           variant: str = "prob", *,
                           label_mode: str = "combine", thresh: float = 0.5,
                           empty_label: int = 17, chunk_n: int = 65536,
                           chunk_g: int = 128):
    """Dense (point-chunk x Gaussian-chunk) blocks; fp32 throughout."""
    _check_variant(variant, label_mode)
    prob = variant == "prob"
    n = points.shape[0]
    p = gdata.shape[0]
    pint = grid.voxelize(points)
    acc = torch.zeros(n, sem_aug.shape[1], dtype=torch.float32,
                      device=points.device)
    one_minus = (torch.ones(n, dtype=torch.float32, device=points.device)
                 if prob else None)
    for n0 in range(0, n, chunk_n):
        pts = points[n0:n0 + chunk_n]
        pi = pint[n0:n0 + chunk_n]
        for g0 in range(0, p, chunk_g):
            gd = gdata[g0:g0 + chunk_g]
            bx = box[g0:g0 + chunk_g]
            dx = gd[None, :, 0] - pts[:, None, 0]
            dy = gd[None, :, 1] - pts[:, None, 1]
            dz = gd[None, :, 2] - pts[:, None, 2]
            logit = (-0.5 * (gd[:, 3] * dx * dx + gd[:, 4] * dy * dy
                             + gd[:, 5] * dz * dz)
                     - (gd[:, 6] * dx * dy + gd[:, 7] * dy * dz
                        + gd[:, 8] * dx * dz))
            inside = ((pi[:, None, :] >= bx[None, :, 0:3])
                      & (pi[:, None, :] <= bx[None, :, 3:6])).all(-1)
            e = torch.exp(torch.clamp_max(logit, 30.0)) * inside
            acc[n0:n0 + chunk_n] += e @ sem_aug[g0:g0 + chunk_g]
            if prob:
                one_minus[n0:n0 + chunk_n] *= torch.prod(1.0 - e, dim=1)
    return acc, one_minus, labels_from_acc(acc, one_minus, label_mode, thresh,
                                           empty_label)


#: voxels of a tile along x, y and z (``TX``, ``TY``, ``TZ`` of
#: ``csrc/splat_bin.cuh``)
TILE = (8, 8, 16)
#: the entry's flag: the box holds every voxel of the tile (the sign bit)
COVERS = -2 ** 31
#: Gaussians a block of the binning's count and expand launches (``GBLOCK``
#: of ``csrc/splat_bin.cu``), which sizes its scratch
GBLOCK = 256


def tile_counts(grid) -> tuple:
    """Tiles along x, y and z (partial bricks at the far edges count)."""
    return tuple(-(-n // t) for n, t in zip((grid.H, grid.W, grid.D), TILE))


@dataclasses.dataclass(frozen=True)
class SplatBins:
    """The Gaussians of one splat binned by voxel tile (tiles numbered in
    raster order, x slowest). ``entries`` [E] int32 is tile-major: tile t's
    Gaussians are ``entries[tile_start[t]:tile_start[t + 1]]`` in ascending
    index order, each with :data:`COVERS` or-ed in (the sign bit) where its
    box holds the whole tile. ``slot`` [E] int32 is each entry's position in
    the Gaussian-major order, where Gaussian g's entries are
    ``gauss_start[g]:gauss_start[g + 1]``, its tiles in raster order.
    ``tile_items`` [2 T + 1] int32: the kernels' work items, one block
    each: the tiles by descending list length (ties by index), a tile whose
    list is longer than twice the mean as two halves; item = 4 t + (0 the
    whole tile, 1 / 2 a half); ``tile_items[2 T]`` counts them, the rest is
    -1. On the card ``entries`` and ``slot`` hold the bound of
    :func:`entries_bound` (their first ``tile_start[-1]`` are the bins) and
    ``flags`` [1] int32 the binning's flag word (:data:`NOT_RASTER`,
    :data:`OVER_BOUND`); the plain bins hold the entries alone."""
    tile_start: torch.Tensor
    tile_items: torch.Tensor
    entries: torch.Tensor
    slot: torch.Tensor
    gauss_start: torch.Tensor
    grid_dims: tuple
    flags: torch.Tensor = None

    @property
    def num_entries(self) -> int:
        """The entries' total (a host read on the card)."""
        return int(self.tile_start[-1].item())

    @property
    def capacity(self) -> int:
        """The entries the arrays hold room for."""
        return self.entries.shape[0]

    def gaussians(self):
        return self.entries[:self.num_entries] & 0x7FFFFFFF

    def covers(self):
        return self.entries[:self.num_entries] < 0

    def stats(self) -> dict:
        """Entries, the COVERS share and the tiles' mean and largest list
        lengths (host reads)."""
        lengths = (self.tile_start[1:] - self.tile_start[:-1]).float()
        e = self.num_entries
        return dict(entries=e, tiles=lengths.numel(),
                    covers_share=(self.covers().sum().item() / e if e
                                  else 0.0),
                    mean_list=lengths.mean().item(),
                    max_list=int(lengths.max().item()))


def _check_bins(name, bins, grid, p):
    if (bins.grid_dims != (grid.H, grid.W, grid.D)
            or bins.gauss_start.shape[0] != p + 1):
        raise ValueError(f"{name}: the bins are not of this grid and these "
                         f"{p} Gaussians")


def _work_items(tile_start):
    """The work items of :class:`SplatBins` from the tiles' starts."""
    lengths = tile_start[1:] - tile_start[:-1]
    tiles = lengths.shape[0]
    total = int(tile_start[-1])
    order = torch.argsort(-lengths, stable=True)
    split = lengths[order] * tiles > 2 * total
    code = torch.stack([torch.where(split, 4 * order + 1, 4 * order),
                        torch.where(split, 4 * order + 2, -1)], -1)
    items = code.reshape(-1)
    items = items[items >= 0]
    pad = torch.full((2 * tiles - items.shape[0],), -1,
                     dtype=items.dtype, device=items.device)
    return torch.cat([items, pad, items.new_tensor([items.shape[0]])])


def _tile_extents(box, grid):
    """Per box [P, 6], its clipped lower tile [P, 3] and the tiles it meets
    along each axis [P, 3] (0 where it misses the grid)."""
    dev = box.device
    dims = constant((grid.H, grid.W, grid.D), torch.int64, dev)
    tile = constant(TILE, torch.int64, dev)
    b = box.long()
    lo = b[:, :3].clamp_min(0)
    hi = torch.minimum(b[:, 3:], dims - 1)
    meets = (lo <= hi).all(-1)
    tlo = lo // tile
    return tlo, torch.where(meets[:, None], hi // tile - tlo + 1,
                            torch.zeros_like(tlo))


def bin_gaussians_plain(box, grid) -> SplatBins:
    """The bins of :class:`SplatBins` by plain tensor operations (each box
    clipped to the grid, its tiles enumerated, a stable sort by tile)."""
    dev = box.device
    dims = constant((grid.H, grid.W, grid.D), torch.int64, dev)
    tile = constant(TILE, torch.int64, dev)
    nt = tile_counts(grid)
    b = box.long()
    tlo, ext = _tile_extents(box, grid)
    count = ext.prod(-1)
    gauss_start = torch.cat([count.new_zeros(1), count.cumsum(0)])
    g = torch.repeat_interleave(torch.arange(b.shape[0], device=dev), count)
    k = torch.arange(g.shape[0], device=dev) - gauss_start[g]
    e = ext[g]
    iz = k % e[:, 2]
    r = k // e[:, 2]
    t3 = tlo[g] + torch.stack([r // e[:, 1], r % e[:, 1], iz], -1)
    key = (t3[:, 0] * nt[1] + t3[:, 1]) * nt[2] + t3[:, 2]
    t_lo = t3 * tile
    t_hi = torch.minimum(t_lo + tile, dims) - 1
    covers = ((b[g, :3] <= t_lo) & (b[g, 3:] >= t_hi)).all(-1)
    sorted_key, order = torch.sort(key, stable=True)
    vals = torch.where(covers, g + COVERS, g)
    tile_start = torch.searchsorted(
        sorted_key, torch.arange(nt[0] * nt[1] * nt[2] + 1, device=dev))
    i32 = torch.int32
    return SplatBins(tile_start.to(i32), _work_items(tile_start).to(i32),
                     vals[order].to(i32), order.to(i32), gauss_start.to(i32),
                     (grid.H, grid.W, grid.D))


#: bits of the binning's flag word: the points are not the raster voxel
#: grid; the entries passed the bound (the bins are then empty)
NOT_RASTER, OVER_BOUND = 1, 2
#: the flag words of bins built while a CUDA graph was being captured, which
#: no host read checked (:func:`check_deferred_flags` reads them)
DEFERRED_FLAGS = []


def entries_bound(p: int, grid, max_radius=None, whole: int = 0) -> int:
    """The most entries the bins of ``p`` Gaussians can hold on ``grid``:
    every tile for each when ``max_radius`` is None; else the tiles a box of
    that radius (in voxels, on every axis) can meet, and every tile for the
    last ``whole`` of them (the v1 head's empty Gaussian)."""
    nt = tile_counts(grid)
    every = nt[0] * nt[1] * nt[2]
    if max_radius is None:
        return p * every
    per = math.prod(min(-(-2 * max_radius // t) + 1, n)
                    for t, n in zip(TILE, nt))
    return min((p - whole) * per + whole * every, p * every)


def bin_flags_plain(points, box, grid, max_entries=None) -> int:
    """The flag word of ``csrc/splat_bin.cu``'s binning by plain tensor
    operations: :data:`NOT_RASTER` unless point i lies in voxel i of the
    raster order (x slowest) for every i, :data:`OVER_BOUND` when the boxes
    meet more tiles than ``max_entries`` (by default the bound of any
    boxes)."""
    vox = grid.voxelize(points)
    lin = (vox[:, 0] * grid.W + vox[:, 1]) * grid.D + vox[:, 2]
    raster = torch.equal(lin, torch.arange(points.shape[0],
                                           device=points.device))
    cap = entries_bound(box.shape[0], grid)
    if max_entries is not None:
        cap = min(cap, max_entries)
    over = bin_gaussians_plain(box, grid).num_entries > cap
    return (0 if raster else NOT_RASTER) | (OVER_BOUND if over else 0)


def check_flags(flags, name="splat_bins"):
    """Raise for a binning's flag word (a host read)."""
    bits = int(flags.item())
    if bits & NOT_RASTER:
        raise ValueError(f"{name}: points are not the voxel grid in raster "
                         f"order")
    if bits & OVER_BOUND:
        raise ValueError(f"{name}: the boxes met more tiles than the bound "
                         f"the bins were sized by")


def check_deferred_flags():
    """Check the flag words of the bins built during a CUDA graph's capture
    (after a replay, which rewrote them; a host read). The capturer empties
    :data:`DEFERRED_FLAGS` before its capture."""
    for flags in DEFERRED_FLAGS:
        check_flags(flags)


def bin_gaussians_cuda(points, box, grid, max_entries=None) -> SplatBins:
    """Launch ``csrc/splat_bin.cu`` in one call with no host read: count
    each box's tiles (and check that the points are the raster voxel grid,
    one per voxel, x slowest), scan, expand, sort stably by tile (a
    counting sort) and make the work items, into arrays of ``max_entries``
    entries (:func:`entries_bound`). Without it an eager call sizes them
    by the boxes' own tiles (one host read) and a capture by every tile
    for every box. The flag word is read at once in an eager call, which
    raises ``ValueError`` for other points or for boxes past the bound;
    during a CUDA graph's capture it joins :data:`DEFERRED_FLAGS`. Grids of
    more than 4096 tiles are not taken."""
    name = "splat_bins"
    _lib.require_cuda(name, points=points, box=box)
    _lib.require_dtype(name, "points", points, torch.float32)
    _lib.require_dtype(name, "box", box, torch.int32)
    p = box.shape[0]
    if box.shape != (p, 6):
        raise ValueError(f"{name}: bad box shape {tuple(box.shape)}")
    if points.shape != (grid.num_voxels, 3):
        raise ValueError(f"{name}: points are not the {grid.H}x{grid.W}x"
                         f"{grid.D} voxel grid")
    capturing = torch.cuda.is_current_stream_capturing()
    cap = entries_bound(p, grid)
    if max_entries is not None:
        cap = min(cap, max_entries)
    elif not capturing:
        cap = int(_tile_extents(box, grid)[1].prod(-1).sum())
    nt = tile_counts(grid)
    tiles = nt[0] * nt[1] * nt[2]
    lib = _lib.lib()
    sizes = (ctypes.c_longlong * 2)()
    _lib.check(lib.gf_splat_bin_sizes(p, grid.H, grid.W, grid.D, cap, sizes),
               name)
    i32 = dict(dtype=torch.int32, device=points.device)
    # scratch: the counts, the blocks' offsets with the total and the flag
    # word, and the counting sort's keys, values and per-block tile counts
    meta = torch.empty(p + sizes[1] + sizes[0], **i32)
    out = torch.empty(p + 1 + 2 * cap + 3 * tiles + 2, **i32)
    gauss_start, rest = out[:p + 1], out[p + 1:]
    entries, slot = rest[:cap], rest[cap:2 * cap]
    tile_start = rest[2 * cap:2 * cap + tiles + 1]
    tile_items = rest[2 * cap + tiles + 1:]
    counts, offsets = meta[:p], meta[p:p + sizes[1]]
    pc = (ctypes.c_float * 3)(*grid.pc_min)
    _lib.check(lib.gf_splat_bin(
        points.data_ptr(), points.shape[0], box.data_ptr(), p, pc,
        float(grid.grid_size), grid.H, grid.W, grid.D, cap,
        counts.data_ptr(), offsets.data_ptr(),
        meta[p + sizes[1]:].data_ptr(), gauss_start.data_ptr(),
        entries.data_ptr(), slot.data_ptr(), tile_start.data_ptr(),
        tile_items.data_ptr(), _lib.stream_ptr(points)), name)
    _lib.LAUNCHES["splat_bin"] += 1
    flags = offsets[-1:]
    if capturing:
        DEFERRED_FLAGS.append(flags)
    else:
        check_flags(flags, name)
    return SplatBins(tile_start, tile_items, entries, slot, gauss_start,
                     (grid.H, grid.W, grid.D), flags)


def splat_accumulate_cuda(points, gdata, box, sem_aug, grid,
                          variant: str = "prob", *,
                          label_mode: str = "combine", thresh: float = 0.5,
                          empty_label: int = 17, bins: SplatBins = None):
    """Launch ``csrc/splat.cu``: one block per voxel tile over the tile's
    binned Gaussians. The points must be the raster voxel grid. ``bins``:
    this splat's :class:`SplatBins`, built here when not given."""
    _check_variant(variant, label_mode)
    name = "splat_accumulate"
    _lib.require_cuda(name, points=points, gdata=gdata, box=box,
                      sem_aug=sem_aug)
    for key, t, dt in (("points", points, torch.float32),
                       ("gdata", gdata, torch.float32),
                       ("box", box, torch.int32),
                       ("sem_aug", sem_aug, torch.float32)):
        _lib.require_dtype(name, key, t, dt)
    n, p = points.shape[0], gdata.shape[0]
    ca = sem_aug.shape[1]
    if (points.shape != (n, 3) or gdata.shape != (p, 9)
            or box.shape != (p, 6) or sem_aug.shape[0] != p):
        raise ValueError(f"{name}: bad table shapes")
    if bins is None:
        bins = bin_gaussians_cuda(points, box, grid)
    elif n != grid.num_voxels:
        raise ValueError(f"{name}: points are not the voxel grid")
    _check_bins(name, bins, grid, p)
    acc = torch.empty(n, ca, dtype=torch.float32, device=points.device)
    labels = torch.empty(n, dtype=torch.int32, device=points.device)
    common = (points.data_ptr(), gdata.data_ptr(), box.data_ptr(),
              sem_aug.data_ptr(), ca - 2, grid.H, grid.W, grid.D,
              bins.tile_start.data_ptr(), bins.tile_items.data_ptr(),
              bins.entries.data_ptr(), acc.data_ptr())
    if variant == "additive":
        code = _lib.lib().gf_splat_forward_additive(
            *common, labels.data_ptr(), _lib.stream_ptr(points))
        _lib.check(code, name)
        _lib.LAUNCHES["splat_additive"] += 1
        return acc, None, labels
    one_minus = torch.empty(n, dtype=torch.float32, device=points.device)
    code = _lib.lib().gf_splat_forward(
        *common, one_minus.data_ptr(), labels.data_ptr(),
        int(label_mode == "threshold"), float(thresh), int(empty_label),
        _lib.stream_ptr(points))
    _lib.check(code, name)
    _lib.LAUNCHES["splat"] += 1
    return acc, one_minus, labels


def splat_accumulate(points, gdata, box, sem_aug, grid,
                     variant: str = "prob", bins: SplatBins = None,
                     **labels):
    """Splat accumulators and labels: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (on ``bins`` where given).
    ``labels``: the prob label mode's keywords (``label_mode``,
    ``thresh``, ``empty_label``)."""
    if points.device.type == "cpu":
        return splat_accumulate_plain(points, gdata, box, sem_aug, grid,
                                      variant, **labels)
    return splat_accumulate_cuda(points, gdata, box, sem_aug, grid, variant,
                                 bins=bins, **labels)


NORM_3D = (2.0 * math.pi) ** -1.5


def _det_terms(gdata, opa):
    """det(A), sqrt(max(det, 1e-30)) and w = (2 pi)^-1.5 sqrt(det) opa."""
    xx, yy, zz, xy, yz, xz = gdata[:, 3:9].unbind(-1)
    det = (xx * yy * zz + 2.0 * xy * yz * xz
           - xx * yz * yz - yy * xz * xz - zz * xy * xy)
    sqrt_det = torch.sqrt(det.clamp_min(1e-30))
    return det, sqrt_det, NORM_3D * sqrt_det * opa


def _finish_backward(gdata, opa, sd, sdd, gw, gsem, prob: bool):
    """Fold the per-Gaussian sums into (gmu, gopa, gsem, gcov): the
    exponent's moments and, for the prob variant, the det(A) term of w."""
    a = gdata[:, 3:9]
    xx, yy, zz, xy, yz, xz = a.unbind(-1)
    gmu = -torch.stack([xx * sd[:, 0] + xy * sd[:, 1] + xz * sd[:, 2],
                        xy * sd[:, 0] + yy * sd[:, 1] + yz * sd[:, 2],
                        xz * sd[:, 0] + yz * sd[:, 1] + zz * sd[:, 2]], -1)
    gcov = torch.cat([-0.5 * sdd[:, :3], -sdd[:, 3:]], -1)
    if not prob:
        return gmu, gw, gsem, gcov
    det, sqrt_det, _ = _det_terms(gdata, opa)
    gopa = gw * NORM_3D * sqrt_det
    gdet = torch.where(det > 1e-30,
                       gw * opa * NORM_3D / (2.0 * sqrt_det),
                       torch.zeros_like(gw))
    ddet = torch.stack([yy * zz - yz * yz, xx * zz - xz * xz,
                        xx * yy - xy * xy, 2.0 * (yz * xz - zz * xy),
                        2.0 * (xy * xz - xx * yz), 2.0 * (xy * yz - yy * xz)],
                       -1)
    return gmu, gopa, gsem, gcov + gdet[:, None] * ddet


@torch.no_grad()
def splat_backward_plain(points, gdata, opa, sem, box, gl, scalars, grid,
                         variant: str = "prob", chunk_n: int = 65536,
                         chunk_g: int = 128):
    """Hand-derived VJP of the splat in dense (point-chunk x
    Gaussian-chunk) blocks, fp32 (``_splat_bwd_single``). prob: ``gl``
    [N, C] is the covered, prob_sum-normalised logits cotangent and
    ``scalars`` [N, 3] holds (dot_gl, bin_term, g_density). additive:
    ``gl`` is the logits cotangent itself and ``scalars`` is None. The
    exponent's moments are summed in the displacement d = mu - x. Returns
    (gmu [P, 3], gopa [P], gsem [P, C], gcov [P, 6])."""
    _check_variant(variant)
    prob = variant == "prob"
    n = points.shape[0]
    p, c = sem.shape
    dev = points.device
    pint = grid.voxelize(points)
    w = _det_terms(gdata, opa)[2] if prob else opa
    f32 = dict(dtype=torch.float32, device=dev)
    sd = torch.zeros(p, 3, **f32)
    sdd = torch.zeros(p, 6, **f32)
    gw = torch.zeros(p, **f32)
    gsem = torch.zeros(p, c, **f32)
    for n0 in range(0, n, chunk_n):
        pts = points[n0:n0 + chunk_n]
        pi = pint[n0:n0 + chunk_n]
        gl_n = gl[n0:n0 + chunk_n]
        if prob:
            dot_gl, bin_term, g_dens = scalars[n0:n0 + chunk_n].unbind(-1)
        for g0 in range(0, p, chunk_g):
            sl = slice(g0, g0 + chunk_g)
            gd, bx = gdata[sl], box[sl]
            d = [gd[None, :, a] - pts[:, None, a] for a in range(3)]
            logit = (-0.5 * (gd[:, 3] * d[0] * d[0] + gd[:, 4] * d[1] * d[1]
                             + gd[:, 5] * d[2] * d[2])
                     - (gd[:, 6] * d[0] * d[1] + gd[:, 7] * d[1] * d[2]
                        + gd[:, 8] * d[0] * d[2]))
            inside = ((pi[:, None, :] >= bx[None, :, 0:3])
                      & (pi[:, None, :] <= bx[None, :, 3:6])).all(-1)
            power = torch.exp(torch.clamp_max(logit, 30.0)) * inside
            gprob = gl_n @ sem[sl].T
            gpower = gprob * w[None, sl]
            if prob:
                gprob = gprob - dot_gl[:, None]
                one_m = 1.0 - torch.clamp_max(power, 1.0 - 1e-9) + 1e-9
                gpower = (g_dens[:, None] + bin_term[:, None] / one_m
                          + gprob * w[None, sl])
            gw[sl] += (gprob * power).sum(0)
            gsem[sl] += (power * w[None, sl]).T @ gl_n
            glogit = gpower * power * (logit < 30.0)
            sd[sl] += torch.stack([(glogit * d[a]).sum(0)
                                   for a in range(3)], -1)
            sdd[sl] += torch.stack([(glogit * d[i] * d[j]).sum(0)
                                    for i, j in ((0, 0), (1, 1), (2, 2),
                                                 (0, 1), (1, 2), (0, 2))],
                                   -1)
    return _finish_backward(gdata, opa, sd, sdd, gw, gsem, prob)


#: the backward's launches (``parts``): the tile launch and the fold
TILE_LAUNCH, FOLD_LAUNCH = 1, 2


def splat_backward_cuda(points, gdata, opa, sem, box, gl, scalars, grid,
                        variant: str = "prob", *, bins: SplatBins = None,
                        parts: int = TILE_LAUNCH | FOLD_LAUNCH):
    """Launch ``csrc/splat_bwd.cu``: per voxel tile, each binned
    Gaussian's sums into its slot of a workspace (entries x (10 + C)
    floats), then a fold per Gaussian in a fixed order; no atomics. The
    points must be the raster voxel grid. ``scalars`` is None for the
    additive variant. ``bins``: the forward's :class:`SplatBins`, built
    here when not given. ``parts`` selects the launches (to time them
    apart; with one left out the outputs are not written)."""
    _check_variant(variant)
    name = "splat_backward"
    p, c = sem.shape
    prob = variant == "prob"
    if prob == (scalars is None):
        raise ValueError(f"{name}: the prob variant, and only it, takes "
                         f"scalars")
    tensors = dict(points=points, gdata=gdata, opa=opa, sem=sem, box=box,
                   gl=gl)
    if prob:
        tensors["scalars"] = scalars
    _lib.require_cuda(name, **tensors)
    for key, t in tensors.items():
        _lib.require_dtype(name, key, t,
                           torch.int32 if key == "box" else torch.float32)
    n = points.shape[0]
    if (gdata.shape != (p, 9) or opa.shape != (p,) or box.shape != (p, 6)
            or gl.shape != (n, c)
            or (prob and scalars.shape != (n, 3))):
        raise ValueError(f"{name}: bad table shapes")
    if bins is None:
        bins = bin_gaussians_cuda(points, box, grid)
    elif points.shape != (grid.num_voxels, 3):
        raise ValueError(f"{name}: points are not the voxel grid")
    _check_bins(name, bins, grid, p)
    f32 = dict(dtype=torch.float32, device=points.device)
    gmu = torch.empty(p, 3, **f32)
    gopa = torch.empty(p, **f32)
    gsem = torch.empty(p, c, **f32)
    gcov = torch.empty(p, 6, **f32)
    work = torch.empty(bins.capacity, -(-(10 + c) // 4) * 4, **f32)
    head = (points.data_ptr(), gdata.data_ptr(), opa.data_ptr(),
            sem.data_ptr(), box.data_ptr(), gl.data_ptr())
    tail = (p, c, grid.H, grid.W, grid.D, bins.tile_start.data_ptr(),
            bins.tile_items.data_ptr(), bins.entries.data_ptr(),
            bins.slot.data_ptr(),
            bins.gauss_start.data_ptr(), work.data_ptr(), gmu.data_ptr(),
            gopa.data_ptr(), gsem.data_ptr(), gcov.data_ptr(), int(parts),
            _lib.stream_ptr(points))
    if prob:
        code = _lib.lib().gf_splat_backward(*head, scalars.data_ptr(), *tail)
    else:
        code = _lib.lib().gf_splat_backward_additive(*head, *tail)
    _lib.check(code, name)
    _lib.LAUNCHES["splat_bwd" if prob else "splat_bwd_additive"] += 1
    return gmu, gopa, gsem, gcov


def splat_backward(points, gdata, opa, sem, box, gl, scalars, grid,
                   variant: str = "prob", bins: SplatBins = None):
    """Per-Gaussian splat gradients: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (on the forward's ``bins`` where
    given)."""
    if points.device.type == "cpu":
        return splat_backward_plain(points, gdata, opa, sem, box, gl,
                                    scalars, grid, variant)
    return splat_backward_cuda(points, gdata, opa, sem, box, gl, scalars,
                               grid, variant, bins=bins)
