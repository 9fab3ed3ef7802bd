"""The splat's per-tile Gaussian bins (``kernels/splat.py``:
``bin_gaussians_plain``, the plain version of ``csrc/splat_bin.cu``) on the
CPU: against a brute-force enumeration of each box's voxels, on small grids
with partial bricks, boxes reaching past the grid or wholly outside it, a
whole-grid box, tiles that no Gaussian reaches and per-axis boxes; and the
plain splat summed tile by tile over the lists against the plain splat of
the whole grid. Inputs are made with numpy from a seed."""
import numpy as np
import pytest
import torch

from gaussianformer_tpu_torch.kernels import splat
from gaussianformer_tpu_torch.ops.covariance import build_covariance_inverse6
from gaussianformer_tpu_torch.ops.splat import SplatGridSpec, pack_gaussians


def _brute_force(box, dims):
    """Per tile (raster order), the sorted (Gaussian, covers) pairs; per
    Gaussian, its tiles in raster order; from each box's voxels."""
    tile = np.array(splat.TILE)
    dims = np.array(dims)
    nt = -(-dims // tile)
    per_tile = [[] for _ in range(int(nt.prod()))]
    per_gauss = []
    for g, b in enumerate(box):
        lo = np.maximum(b[:3], 0)
        hi = np.minimum(b[3:], dims - 1)
        tiles = []
        if (lo <= hi).all():
            vox = np.stack(np.meshgrid(*[np.arange(lo[a], hi[a] + 1)
                                         for a in range(3)],
                                       indexing="ij"), -1).reshape(-1, 3)
            for t3 in np.unique(vox // tile, axis=0):
                t_lo = t3 * tile
                t_hi = np.minimum(t_lo + tile, dims) - 1
                covers = bool((b[:3] <= t_lo).all() and (b[3:] >= t_hi).all())
                t = int((t3[0] * nt[1] + t3[1]) * nt[2] + t3[2])
                tiles.append(t)
                per_tile[t].append((g, covers))
        per_gauss.append(sorted(tiles))
    return per_tile, per_gauss


def _assert_bins_match(box, grid):
    bins = splat.bin_gaussians_plain(torch.from_numpy(box), grid)
    per_tile, per_gauss = _brute_force(box, (grid.H, grid.W, grid.D))
    ts = bins.tile_start.tolist()
    gs = bins.gauss_start.tolist()
    ent = bins.gaussians().tolist()
    cov = bins.covers().tolist()
    slot = bins.slot.tolist()
    assert len(ts) == len(per_tile) + 1 and ts[0] == 0
    assert ts[-1] == bins.num_entries == gs[-1]
    for t, want in enumerate(per_tile):
        got = list(zip(ent[ts[t]:ts[t + 1]], cov[ts[t]:ts[t + 1]]))
        assert got == sorted(want), t
    # the slots are a permutation; Gaussian g's slots hold its tiles in
    # raster order
    assert sorted(slot) == list(range(bins.num_entries))
    tile_of = np.repeat(np.arange(len(per_tile)), np.diff(ts))
    by_slot = np.empty(bins.num_entries, dtype=np.int64)
    gauss_by_slot = np.empty(bins.num_entries, dtype=np.int64)
    by_slot[slot] = tile_of
    gauss_by_slot[slot] = ent
    for g, tiles in enumerate(per_gauss):
        assert (gauss_by_slot[gs[g]:gs[g + 1]] == g).all()
        assert by_slot[gs[g]:gs[g + 1]].tolist() == tiles, g
    # the work items: the tiles by descending list length (ties by index),
    # a tile with more than twice the mean entries as its two halves
    lengths = np.diff(ts)
    tiles = len(per_tile)
    items = bins.tile_items.tolist()
    assert len(items) == 2 * tiles + 1
    n = items[-1]
    assert all(i == -1 for i in items[n:-1])
    want = []
    for t in sorted(range(tiles), key=lambda t: (-lengths[t], t)):
        split = lengths[t] * tiles > 2 * bins.num_entries
        want += [4 * t + 1, 4 * t + 2] if split else [4 * t]
    assert items[:n] == want
    for t in (bins.tile_start, bins.tile_items, bins.entries, bins.slot,
              bins.gauss_start):
        assert t.dtype == torch.int32
    return bins


def _random_boxes(rng, p, dims, radius):
    centre = rng.integers(0, dims, size=(p, 3))
    rad = rng.integers(0, radius + 1, size=(p, 3))
    return np.concatenate([centre - rad, centre + rad], -1).astype(np.int32)


GRIDS = {"partial": (40, 30, 8), "whole_bricks": (16, 24, 16),
         "ragged": (13, 9, 21)}


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
def test_bins_match_brute_force_random_boxes(grid_name):
    """Mixed radii, some boxes reaching past the grid's edges."""
    dims = GRIDS[grid_name]
    rng = np.random.default_rng(0)
    box = _random_boxes(rng, 150, dims, 9)
    grid = SplatGridSpec(H=dims[0], W=dims[1], D=dims[2])
    bins = _assert_bins_match(box, grid)
    assert bins.num_entries > 150


def test_bins_boxes_outside_whole_grid_and_empty_tiles():
    """Boxes wholly outside the grid (no entry), one past every edge (the
    whole grid: every tile, COVERS everywhere), an inverted box, and a few
    small ones that leave most tiles without a Gaussian."""
    dims = (40, 30, 8)
    grid = SplatGridSpec(H=40, W=30, D=8)
    box = np.array([[-9, 0, 0, -1, 5, 5],         # below x
                    [40, 3, 3, 44, 6, 6],         # above x
                    [2, 2, 8, 5, 5, 12],          # above z
                    [-5, -5, -5, 100, 100, 100],  # the whole grid
                    [3, 3, 3, 2, 5, 5],           # inverted
                    [9, 9, 1, 10, 10, 2],
                    [0, 0, 0, 0, 0, 0],
                    [39, 29, 7, 39, 29, 7]], dtype=np.int32)
    bins = _assert_bins_match(box, grid)
    counts = np.diff(bins.gauss_start.numpy())
    tiles = bins.tile_start.numel() - 1
    assert counts.tolist() == [0, 0, 0, tiles, 0, 1, 1, 1]
    whole = bins.gaussians() == 3
    assert bins.covers()[whole].all() and not bins.covers()[~whole].any()
    per_tile = np.diff(bins.tile_start.numpy())
    assert (per_tile == 1).sum() == tiles - 3 and per_tile.max() == 2
    # no list is longer than twice the mean (23 / 20): every tile whole, the
    # three of two entries first
    items = bins.tile_items.tolist()
    assert items[-1] == tiles and items[:3] == [0, 4 * 5, 4 * 19]


def test_bins_split_a_crowded_tile():
    """Ten boxes in the first tile beside a whole-grid box: that tile's list
    (11 entries against a mean of 1.5) becomes two work items, first."""
    grid = SplatGridSpec(H=40, W=30, D=8)
    box = np.array([[-5, -5, -5, 100, 100, 100]]
                   + [[i % 5, i // 5, 0, i % 5 + 2, i // 5 + 2, 3]
                      for i in range(10)], dtype=np.int32)
    bins = _assert_bins_match(box, grid)
    items = bins.tile_items.tolist()
    assert items[:3] == [1, 2, 4] and items[-1] == 21


def test_bins_no_gaussians():
    grid = SplatGridSpec(H=16, W=16, D=16)
    bins = _assert_bins_match(np.zeros((0, 6), dtype=np.int32), grid)
    assert bins.num_entries == 0 and bins.tile_start.tolist() == [0] * 5


def _splat_case(seed, per_axis, variant="prob"):
    """A raster 40 x 30 x 8 grid (no tile whole) and 120 Gaussians of mixed
    radii from numpy, some boxes past the grid."""
    rng = np.random.default_rng(seed)
    grid = SplatGridSpec(H=40, W=30, D=8, pc_min=(-10.0, -7.5, -2.0),
                         grid_size=0.5, scale_multiplier=3.0)
    axes = [torch.arange(n) * 0.5 + 0.25 + lo
            for n, lo in zip((40, 30, 8), grid.pc_min)]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                      -1).reshape(-1, 3).contiguous()
    p, c = 120, 18
    f = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    means = f(np.array(grid.pc_min) + rng.random((p, 3))
              * np.array([20.0, 15.0, 4.0]))
    scales = f(rng.random((p, 3)) * 1.2 + 0.05)
    cov6 = build_covariance_inverse6(scales, f(rng.standard_normal((p, 4))))
    sem = torch.softmax(f(rng.standard_normal((p, c))), -1)
    opa = f(rng.random(p))
    tables = pack_gaussians(means, opa, sem, scales, cov6, grid, variant,
                            per_axis)
    return grid, pts, tables


@pytest.mark.parametrize("per_axis", [False, True])
def test_bins_of_packed_boxes_match_brute_force(per_axis):
    grid, _, (_, box, _) = _splat_case(1, per_axis)
    _assert_bins_match(box.numpy(), grid)


@pytest.mark.parametrize("variant", ["prob", "additive"])
@pytest.mark.parametrize("per_axis", [False, True])
def test_splat_summed_tile_by_tile_equals_plain(variant, per_axis):
    """The plain splat of each tile's voxels over that tile's Gaussians
    alone gives the whole-grid plain splat's sums (fp32 sums over the same
    pairs in another order: within 1e-5 of the largest |sum|) and, for
    prob, the same one_minus (a product of the same factors)."""
    grid, pts, (gdata, box, sem_aug) = _splat_case(2, per_axis, variant)
    bins = splat.bin_gaussians_plain(box, grid)
    ref = splat.splat_accumulate_plain(pts, gdata, box, sem_aug, grid,
                                       variant)
    acc = torch.zeros_like(ref[0])
    om = torch.ones_like(pts[:, 0])
    lin = torch.arange(grid.num_voxels).reshape(grid.H, grid.W, grid.D)
    nt = splat.tile_counts(grid)
    ts = bins.tile_start.tolist()
    g_all = bins.gaussians().long()
    for t in range(len(ts) - 1):
        tx, ty, tz = t // (nt[1] * nt[2]), (t // nt[2]) % nt[1], t % nt[2]
        vox = lin[tx * splat.TILE[0]:(tx + 1) * splat.TILE[0],
                  ty * splat.TILE[1]:(ty + 1) * splat.TILE[1],
                  tz * splat.TILE[2]:(tz + 1) * splat.TILE[2]].reshape(-1)
        g = g_all[ts[t]:ts[t + 1]]
        if not g.numel():
            continue
        out = splat.splat_accumulate_plain(pts[vox], gdata[g], box[g],
                                           sem_aug[g], grid, variant)
        acc[vox] = out[0]
        if variant == "prob":
            om[vox] = out[1]
    assert (acc - ref[0]).abs().max() <= 1e-5 * ref[0].abs().max()
    if variant == "prob":
        assert (om - ref[1]).abs().max() <= 1e-6
    assert (ref[0][:, -1] > 0).float().mean() > 0.5
