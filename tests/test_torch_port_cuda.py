"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small shapes with the edge cases the flagship path does not
reach: DCN offsets of several pixels (corners outside the image and, in
the backward, outside the kernel's shared-memory g_x window) and the
forward at the tower's own shapes, masked and exhausted FPS, FPS to
Prob-256's 19,200 anchors, its ties, both cluster sizes and the
points-per-thread boundaries, fp32 deformable features, K3 with one to
four levels and anchors outside every camera, K6 at every channel width
and level count with its pixel bins against the plain bins, a pixel list
split over warps, a splat with sparse and dense coverage, with per-axis
boxes and with the threshold label mode, the additive splat with the v1
head's whole-grid Gaussian, the splat's tile bins against their plain
version, on a grid where no tile is a whole brick, the splat's general
mode at any points (its points bins against their plain version; K4 and
K7 at finer, shuffled, outside, crowded and odd-sized point sets, and at
the raster grid's own points against the raster mode); the fused
submanifold conv and its voxel table at the gs144000 and Prob-64 shapes and
at narrow, ragged ones, with shared voxels, anchors clamped to the border
and a row tile whose every tap is empty; the frozen-BN epilogue in its
three forms at a tower's block-end shapes and in a bf16 tower; and the backward
kernels K5-K7 against their plain backward versions on random cotangents.
The splat kernels K4 and K7 (and their bins), K5, K6 and the spconv give
the same bits on every call, and the calls of K5 and K6 make no host sync. Marked ``cuda``; they skip
on a host without a CUDA device. On the card (``--noconftest``:
tests/conftest.py imports JAX):
``python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda``.

Tolerances: a bf16 output may differ by a rounding flip of its fp32 sum,
so 2^-7 max|ref| (two bf16 ulps at the top of the range); fp32 gradients
summed over thousands of terms in another order than the plain version's
get 1e-3 max|ref|."""
import ctypes
import math

import pytest
import torch

from gaussianformer_tpu_torch.kernels import (_lib, bn_epilogue, dcn,
                                              deformable, fps, spconv, splat)
from gaussianformer_tpu_torch.ops.covariance import build_covariance_inverse6
from gaussianformer_tpu_torch.ops.sparse_conv import voxel_indices
from gaussianformer_tpu_torch.utils import profiling
from gaussianformer_tpu_torch.ops.splat import SplatGridSpec, pack_gaussians

BF16_TOL = 2.0 ** -7
SUM_TOL = 1e-3

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def randn(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


@pytest.mark.parametrize("epilogue", [False, True])
def test_dcn_kernel_matches_plain(gen, epilogue):
    b, h, w, cin, cout = 2, 13, 21, 64, 136
    x = randn(gen, b, h, w, cin).bfloat16()
    om = randn(gen, b, h, w, 27, scale=3.0)       # offsets of several px
    offset, mask = om[..., :18], torch.sigmoid(om[..., 18:])
    weight = randn(gen, 3, 3, cin, cout, scale=0.05).bfloat16()
    epi = ((randn(gen, cout).abs() + 0.5, randn(gen, cout))
           if epilogue else None)
    got = dcn.deform_conv2d_cuda(x, offset, mask, weight, epi).float()
    ref = dcn.deform_conv2d_plain(x, offset, mask, weight, epi).float()
    # bf16 output: four bf16 ulps at the top of the range
    assert (got - ref).abs().max() <= 2.0 ** -6 * ref.abs().max()


@pytest.mark.parametrize("case", ["all_valid", "masked", "exhausted"])
def test_fps_kernel_matches_plain(gen, case):
    n = 20000
    pts = randn(gen, n, 3) * torch.tensor([20.0, 20.0, 2.0], device="cuda")
    valid, k = None, 500
    if case == "masked":
        valid = torch.rand(n, generator=gen, device="cuda") > 0.3
        valid[:7] = False
    elif case == "exhausted":
        valid = torch.rand(n, generator=gen, device="cuda") > 0.995
        k = int(valid.sum()) + 20
    got = fps.farthest_point_sampling_cuda(pts, k, valid)
    ref = fps.farthest_point_sampling_plain(pts, k, valid)
    assert torch.equal(got, ref)


def test_fps_kernel_at_prob_gs25600_size(gen):
    """Prob-256's lifter: 19,200 selections from 129,600 candidates
    (6 cameras x 108 x 200 pixels), a fifth of them masked out; the
    indices equal."""
    n, k = 129_600, 19_200
    pts = randn(gen, n, 3) * torch.tensor([25.0, 25.0, 2.0], device="cuda")
    valid = torch.rand(n, generator=gen, device="cuda") > 0.2
    got = fps.farthest_point_sampling_cuda(pts, k, valid)
    ref = fps.farthest_point_sampling_plain(pts, k, valid)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("offsets", [0.0, 3.0, 12.0])
@pytest.mark.parametrize("shape", [(6, 54, 100, 256, 256),
                                   (6, 27, 50, 512, 512),
                                   (1, 7, 9, 64, 136),
                                   (1, 11, 13, 128, 512)])
def test_dcn_kernel_tower_shapes(gen, shape, offsets, epilogue):
    """K1 at the flagship tower's stage-3 and stage-4 shapes (32,400 and
    8,100 pixels: neither a whole number of the kernel's 64-pixel blocks),
    a ragged 63-pixel case with C_out 136 (a column block only partly
    used) and C_out 512 (two column blocks); offsets of 0, up to 3 px and
    up to 12 px (corners far outside the image)."""
    b, h, w, cin, cout = shape
    x = randn(gen, b, h, w, cin).bfloat16()
    om = randn(gen, b, h, w, 27)
    om[..., :18] = (torch.rand(b, h, w, 18, generator=gen, device="cuda")
                    * 2 - 1) * offsets
    offset, mask = om[..., :18], torch.sigmoid(om[..., 18:])
    weight = randn(gen, 3, 3, cin, cout, scale=0.05).bfloat16()
    epi = ((randn(gen, cout).abs() + 0.5, randn(gen, cout))
           if epilogue else None)
    got = dcn.deform_conv2d_cuda(x, offset, mask, weight, epi).float()
    ref = dcn.deform_conv2d_plain(x, offset, mask, weight, epi).float()
    # bf16 output: four bf16 ulps at the top of the range
    assert (got - ref).abs().max() <= 2.0 ** -6 * ref.abs().max()


def _fps_equal(pts, k, valid=None, cluster_size=0):
    got = fps.farthest_point_sampling_cuda(pts, k, valid, cluster_size)
    ref = fps.farthest_point_sampling_plain(pts, k, valid)
    assert torch.equal(got, ref)
    return got


@pytest.mark.parametrize("case", ["duplicates", "equidistant"])
def test_fps_kernel_ties_take_the_first_index(gen, case):
    """Exact duplicates (every point four times, spread over the blocks)
    and equidistant points (a lattice, whose squared distances tie
    exactly): the first index of a tie wins, as in the plain loop."""
    if case == "duplicates":
        base = randn(gen, 5000, 3) * 10
        pts = base.repeat(4, 1)
    else:
        g = torch.arange(24, device="cuda", dtype=torch.float32)
        pts = torch.stack(torch.meshgrid(g, g, g[:16], indexing="ij"),
                          -1).reshape(-1, 3).contiguous()
    got = _fps_equal(pts, 600)
    assert got.unique().numel() == 600


def test_fps_kernel_every_point_invalid(gen):
    """No valid point: seed 0 and, every distance -inf, index 0 again."""
    pts = randn(gen, 3000, 3)
    valid = torch.zeros(3000, dtype=torch.bool, device="cuda")
    got = _fps_equal(pts, 40, valid)
    assert not got.any()


@pytest.mark.parametrize("n", [1, 100, 1000])
def test_fps_kernel_fewer_points_than_threads(gen, n):
    """N below one cluster's thread count (most threads hold no point)."""
    _fps_equal(randn(gen, n, 3), min(n, 64),
               torch.rand(n, generator=gen, device="cuda") > 0.3)


@pytest.mark.parametrize("past", [0, 1])
@pytest.mark.parametrize("doublings", [0, 1, 2, 3])
def test_fps_kernel_points_per_thread_boundaries(gen, doublings, past):
    """N at and one past each points-per-thread boundary of the card's
    cluster: cluster size x 1024 x 2^j (+ 1)."""
    n = fps.default_cluster_size() * 1024 * 2 ** doublings + past
    pts = randn(gen, n, 3) * torch.tensor([20.0, 20.0, 2.0], device="cuda")
    _fps_equal(pts, 64, torch.rand(n, generator=gen, device="cuda") > 0.2)


def test_fps_kernel_one_and_all_selections(gen):
    """S = 1 (the seed alone, the first valid index) and S = N (the valid
    points run out and the tail takes the rest)."""
    n = 3000
    pts = randn(gen, n, 3)
    valid = torch.rand(n, generator=gen, device="cuda") > 0.5
    valid[:3] = False
    first = int(valid.nonzero()[0])
    assert _fps_equal(pts, 1, valid).tolist() == [first]
    _fps_equal(pts, n, valid)


@pytest.mark.parametrize("cluster_size", [8, 16])
def test_fps_kernel_cluster_sizes(gen, cluster_size):
    """Both cluster sizes give the plain loop's indices at the lifter's
    129,600 candidates; the latency floor (the exchange alone) runs."""
    if cluster_size > fps.default_cluster_size():
        pytest.skip(f"this card takes clusters of "
                    f"{fps.default_cluster_size()}")
    n = 129_600
    pts = randn(gen, n, 3) * torch.tensor([25.0, 25.0, 2.0], device="cuda")
    _fps_equal(pts, 2000, torch.rand(n, generator=gen, device="cuda") > 0.2,
               cluster_size)
    fps.fps_step_floor_cuda(2000, pts.device, cluster_size)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deformable_kernel_matches_plain(gen, dtype):
    b, cams, c, g, k, p = 2, 3, 128, 4, 5, 300
    shapes = ((40, 72), (20, 36), (10, 18), (5, 9))
    feats = [randn(gen, b, cams, hh, ww, c).to(dtype) for hh, ww in shapes]
    loc = torch.rand(b, p * k, cams, 2, generator=gen,
                     device="cuda") * 1.2 - 0.1
    wts = torch.rand(b, p * k, cams, 4, g, generator=gen, device="cuda")
    got = deformable.deformable_aggregation_cuda(feats, loc, wts, k)
    ref = deformable.deformable_aggregation_plain(feats, loc, wts, k)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


def _splat_case(gen):
    """A raster 40 x 30 x 8 grid and 700 Gaussians of mixed radii, some
    boxes reaching past the grid."""
    grid = SplatGridSpec(H=40, W=30, D=8, pc_min=(-10.0, -7.5, -2.0),
                         grid_size=0.5, scale_multiplier=3.0)
    axes = [torch.arange(n, device="cuda") * 0.5 + 0.25 + lo
            for n, lo in zip((40, 30, 8), grid.pc_min)]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                      -1).reshape(-1, 3).contiguous()
    p, c = 700, 18
    lo = torch.tensor(grid.pc_min, device="cuda")
    means = lo + torch.rand(p, 3, generator=gen, device="cuda") \
        * torch.tensor([20.0, 15.0, 4.0], device="cuda")
    scales = torch.rand(p, 3, generator=gen, device="cuda") * 1.5 + 0.05
    cov6 = build_covariance_inverse6(scales, randn(gen, p, 4))
    sem = torch.softmax(randn(gen, p, c - 1), -1)
    sem = torch.cat([sem, torch.zeros(p, 1, device="cuda")], -1)
    opa = torch.rand(p, generator=gen, device="cuda")
    return grid, pts, means, opa, sem, scales, cov6


@pytest.mark.parametrize("per_axis", [False, True])
def test_splat_kernel_matches_plain(gen, per_axis):
    grid, pts, means, opa, sem, scales, cov6 = _splat_case(gen)
    tables = pack_gaussians(means, opa, sem, scales, cov6, grid,
                            per_axis=per_axis)
    got = splat.splat_accumulate_cuda(pts, *tables, grid)
    ref = splat.splat_accumulate_plain(pts, *tables, grid)
    assert (got[0] - ref[0]).abs().max() <= 1e-4 * ref[0].abs().max()
    assert (got[1] - ref[1]).abs().max() <= 1e-4
    assert (got[2] == ref[2]).float().mean() >= 0.999


def test_splat_threshold_labels_match_plain(gen):
    """K4's threshold label epilogue: the same sums as the combine mode,
    and labels equal to the plain version's except where the plain
    occupancy is within 1e-6 of the threshold, or above it with a top-two
    gap of the normalised semantics below 1e-6 (sums in another order may
    flip those). The case is dense, so the threshold is 0.95: a quarter of
    the voxels fall below it."""
    grid, pts, means, opa, sem, scales, cov6 = _splat_case(gen)
    tables = pack_gaussians(means, opa, sem, scales, cov6, grid)
    thresh = 0.95
    kw = dict(label_mode="threshold", thresh=thresh, empty_label=17)
    got = splat.splat_accumulate_cuda(pts, *tables, grid, **kw)
    ref = splat.splat_accumulate_plain(pts, *tables, grid, **kw)
    comb = splat.splat_accumulate_cuda(pts, *tables, grid)
    assert torch.equal(got[0], comb[0]) and torch.equal(got[1], comb[1])
    assert (got[0] - ref[0]).abs().max() <= 1e-4 * ref[0].abs().max()
    logits, bins, _ = splat.postprocess_prob(ref[0], ref[1])
    top = logits.topk(2, dim=-1).values
    near = ((bins - thresh).abs() < 1e-6) | (
        (bins > thresh) & (top[:, 0] - top[:, 1] < 1e-6))
    assert near.float().mean() < 1e-3
    assert torch.equal(got[2][~near], ref[2][~near])
    assert 0.05 < (got[2] == 17).float().mean() < 0.95
    assert not torch.equal(got[2], comb[2])


def _close(got, ref, tol, name):
    err = (got.float() - ref.float()).abs().max()
    assert err <= tol * ref.float().abs().max(), (name, err.item())


@pytest.mark.parametrize("shape", [(2, 30, 41, 128, 136),
                                   (1, 13, 27, 512, 512)])
@pytest.mark.parametrize("offsets",
                         ["fractional", "3px", "12px", "converging"])
def test_dcn_backward_kernel_matches_plain(gen, shape, offsets):
    """K5 for four offset regimes: fractional (every corner in the
    kernel's g_x window), up to 3 px, up to 12 px (far outside any window
    and off the image edges: the fallback records), and converging
    (every sample of an 8 x 8 tile near one point, so that the window
    cells' buckets overflow into the fallback). Shapes: tiles, C_out and
    the pixel splits of the weight gradient not whole (2460 pixels,
    C_out 136), and C_out 512 (the g_out tile at its largest, two
    output-channel halves of the weight gradient). A second call gives
    the same bits."""
    b, h, w, cin, cout = shape
    x = randn(gen, b, h, w, cin).bfloat16()
    om = randn(gen, b, h, w, 27)
    jitter = torch.rand(b, h, w, 18, generator=gen, device="cuda")
    if offsets == "converging":
        # sample (y - 1 + ky + dy, x - 1 + kx + dx) at the tile's centre
        tap = torch.arange(9, device="cuda")
        yy = torch.arange(h, device="cuda")[:, None, None]
        xx = torch.arange(w, device="cuda")[None, :, None]
        dy = (yy // 8) * 8 + 3.5 - (yy - 1 + tap // 3)
        dx = (xx // 8) * 8 + 3.5 - (xx - 1 + tap % 3)
        om[..., :18] = (torch.stack([dy.expand(h, w, 9), dx.expand(h, w, 9)],
                                    -1).reshape(h, w, 18) + jitter * 0.5)
    else:
        scale = {"fractional": 0.99, "3px": 3.0, "12px": 12.0}[offsets]
        om[..., :18] = (jitter * 2 - 1) * scale
    offset, mask = om[..., :18], torch.sigmoid(om[..., 18:])
    weight = randn(gen, 3, 3, cin, cout, scale=0.05).bfloat16()
    g_out = randn(gen, b, h, w, cout).bfloat16()
    outside, _ = dcn.window_outside_share(offset)
    assert (outside == 0) == (offsets in ("fractional", "converging"))
    got = dcn.deform_conv2d_backward_cuda(x, offset, mask, weight, g_out)
    again = dcn.deform_conv2d_backward_cuda(x, offset, mask, weight, g_out)
    ref = dcn.deform_conv2d_backward_plain(x, offset, mask, weight, g_out)
    for name, gt, ag, rf, tol in zip(
            ("g_x", "g_offset", "g_mask", "g_weight"), got, again, ref,
            (BF16_TOL, SUM_TOL, SUM_TOL, BF16_TOL)):
        assert gt.dtype == rf.dtype and gt.shape == rf.shape, name
        _close(gt, rf, tol, name)
        assert torch.equal(gt, ag), name


def test_dcn_backward_parts_split_the_outputs(gen):
    """K5's launches in two groups (as ``chip_smoke.py`` times them): the
    input gradients' launches give g_x, g_offset and g_mask and leave
    g_weight zero, the weight launch and its splits' sum the reverse;
    each gives the whole call's bits."""
    b, h, w, cin, cout = 2, 30, 41, 128, 136
    x = randn(gen, b, h, w, cin).bfloat16()
    offset = randn(gen, b, h, w, 18) * 3
    mask = torch.sigmoid(randn(gen, b, h, w, 9))
    weight = randn(gen, 3, 3, cin, cout, scale=0.05).bfloat16()
    g_out = randn(gen, b, h, w, cout).bfloat16()
    args = (x, offset, mask, weight, g_out)
    whole = dcn.deform_conv2d_backward_cuda(*args)
    inp = dcn.deform_conv2d_backward_cuda(*args, parts=dcn.INPUT_GRADS)
    wgt = dcn.deform_conv2d_backward_cuda(*args, parts=dcn.WEIGHT_GRADS)
    for i, name in enumerate(("g_x", "g_offset", "g_mask", "g_weight")):
        part, other = (wgt, inp) if name == "g_weight" else (inp, wgt)
        assert torch.equal(part[i], whole[i]), name
        assert not other[i].any(), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deformable_backward_kernel_matches_plain(gen, dtype):
    """K6: locations past the image edges (the strict-inside gate and the
    out-of-level corners) and both feature dtypes."""
    b, cams, c, g, k, p = 2, 3, 128, 4, 5, 300
    shapes = ((40, 72), (20, 36), (10, 18), (5, 9))
    feats = [randn(gen, b, cams, hh, ww, c).to(dtype) for hh, ww in shapes]
    loc = torch.rand(b, p * k, cams, 2, generator=gen,
                     device="cuda") * 1.2 - 0.1
    wts = torch.rand(b, p * k, cams, 4, g, generator=gen, device="cuda")
    g_out = randn(gen, b, p, c)
    got = deformable.deformable_aggregation_backward_cuda(feats, loc, wts,
                                                          k, g_out)
    ref = deformable.deformable_aggregation_backward_plain(feats, loc, wts,
                                                           k, g_out)
    feat_tol = BF16_TOL if dtype == torch.bfloat16 else SUM_TOL
    for lvl in range(4):
        assert got[0][lvl].dtype == dtype
        _close(got[0][lvl], ref[0][lvl], feat_tol, f"level {lvl}")
    _close(got[1], ref[1], SUM_TOL, "g_points_2d")
    _close(got[2], ref[2], SUM_TOL, "g_weights")


DEFORM_SHAPES = ((40, 72), (20, 36), (10, 18), (5, 9))


def _deformable_case(gen, dtype, levels=4, c=128, b=2, hot=0, outside=0):
    """Features, locations past the image edges (``hot`` pairs of camera 0
    of the first batch element on one location, the first ``outside``
    anchors outside every camera), weights, cotangents."""
    cams, g, k, p = 3, 4, 5, 300
    shapes = DEFORM_SHAPES[:levels]
    feats = [randn(gen, b, cams, hh, ww, c).to(dtype) for hh, ww in shapes]
    loc = torch.rand(b, p * k, cams, 2, generator=gen,
                     device="cuda") * 1.2 - 0.1
    if hot:
        loc[0, :hot, 0] = torch.tensor([0.43, 0.61], device="cuda")
    if outside:
        loc[:, :outside * k] = 1.5
    wts = torch.rand(b, p * k, cams, levels, g, generator=gen, device="cuda")
    g_out = randn(gen, b, p, c)
    return feats, loc, wts, k, g_out


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deformable_kernel_levels_and_outside_anchors(gen, dtype, levels):
    """K3 with one to four levels (a template parameter of the kernel) and
    anchors whose key points miss every camera (their rows are zero)."""
    feats, loc, wts, k, _ = _deformable_case(gen, dtype, levels, outside=7)
    got = deformable.deformable_aggregation_cuda(feats, loc, wts, k)
    ref = deformable.deformable_aggregation_plain(feats, loc, wts, k)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert not got[:, :7].any()


def _k6_close(got, ref, dtype):
    feat_tol = BF16_TOL if dtype == torch.bfloat16 else SUM_TOL
    for lvl, (a, r) in enumerate(zip(got[0], ref[0])):
        assert a.dtype == dtype
        _close(a, r, feat_tol, f"level {lvl}")
    _close(got[1], ref[1], SUM_TOL, "g_points_2d")
    _close(got[2], ref[2], SUM_TOL, "g_weights")


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("c", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deformable_backward_widths_and_levels(gen, dtype, c, levels):
    """K6 at every channel width the kernels take and one to four levels,
    B = 2: its bins equal the plain bins, its gradients the plain
    backward's."""
    feats, loc, wts, k, g_out = _deformable_case(gen, dtype, levels, c)
    shapes = [tuple(f.shape[2:4]) for f in feats]
    bins = deformable.bin_samples_cuda(loc, shapes)
    ref_bins = deformable.bin_samples_plain(loc, shapes)
    e = bins.num_entries
    assert e == ref_bins.num_entries
    assert torch.equal(bins.entries[:e], ref_bins.entries)
    assert torch.equal(bins.pixel_start, ref_bins.pixel_start)
    got = deformable.deformable_aggregation_backward_cuda(feats, loc, wts, k,
                                                          g_out)
    ref = deformable.deformable_aggregation_backward_plain(feats, loc, wts, k,
                                                           g_out)
    _k6_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deformable_backward_hot_pixel_repeats_its_bits(gen, dtype):
    """A pixel of 600 entries (split over the block's warps), and every
    pixel's list: K6 agrees with the plain backward and with the gradients
    gathered from the plain bins, and a second call gives the same bits."""
    feats, loc, wts, k, g_out = _deformable_case(gen, dtype, hot=600)
    shapes = [tuple(f.shape[2:4]) for f in feats]
    bins = deformable.bin_samples_cuda(loc, shapes)
    assert bins.stats()["longest_list"] >= 600
    got = deformable.deformable_aggregation_backward_cuda(feats, loc, wts, k,
                                                          g_out)
    again = deformable.deformable_aggregation_backward_cuda(
        feats, loc, wts, k, g_out, bins=bins)
    assert all(torch.equal(a, b) for a, b in zip(
        got[0] + [got[1], got[2]], again[0] + [again[1], again[2]]))
    ref = deformable.deformable_aggregation_backward_plain(feats, loc, wts, k,
                                                           g_out)
    _k6_close(got, ref, dtype)
    gathered = deformable.feature_grads_from_bins_plain(
        feats, loc, wts, k, g_out, bins)
    feat_tol = BF16_TOL if dtype == torch.bfloat16 else SUM_TOL
    for lvl, (a, r) in enumerate(zip(got[0], gathered)):
        _close(a, r, feat_tol, f"gathered level {lvl}")


def test_deformable_backward_makes_no_host_sync(gen):
    """K6's call (its binning included) reads nothing back to the host."""
    feats, loc, wts, k, g_out = _deformable_case(gen, torch.bfloat16)
    deformable.deformable_aggregation_backward_cuda(feats, loc, wts, k, g_out)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        deformable.deformable_aggregation_backward_cuda(feats, loc, wts, k,
                                                        g_out)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("per_axis", [False, True])
def test_splat_backward_kernel_matches_plain(gen, per_axis):
    """K7 on random per-voxel cotangents; and, at the raster grid's points
    in reverse order with their cotangent rows, its general mode against
    the plain version on the same rows (no refusal)."""
    grid, pts, means, opa, sem, scales, cov6 = _splat_case(gen)
    gdata, box, _ = pack_gaussians(means, opa, sem, scales, cov6, grid,
                                   per_axis=per_axis)
    n, c = pts.shape[0], sem.shape[1]
    gl = randn(gen, n, c)
    scalars = randn(gen, n, 3)
    args = (pts, gdata, opa, sem, box, gl, scalars, grid)
    got = splat.splat_backward_cuda(*args)
    ref = splat.splat_backward_plain(*args)
    for name, gt, rf in zip(("gmu", "gopa", "gsem", "gcov"), got, ref):
        _close(gt, rf, SUM_TOL, name)
    flip = [t.flip(0).contiguous() for t in (pts, gl, scalars)]
    rev = (flip[0], gdata, opa, sem, box, flip[1], flip[2], grid)
    _lib.reset_launches()
    got = splat.splat_backward_cuda(*rev)
    assert _lib.LAUNCHES["splat_points_bwd"] == 1
    for name, gt, rf in zip(("gmu", "gopa", "gsem", "gcov"), got,
                            splat.splat_backward_plain(*rev)):
        _close(gt, rf, SUM_TOL, name)


def _additive_case(gen):
    """The v1 head's shapes in small: many small boxes, one Gaussian whose
    box is the whole grid (an entry in every tile, each one COVERS) and
    softplus-like positive semantics with a zero empty channel."""
    grid, pts, means, opa, sem, scales, cov6 = _splat_case(gen)
    p, c = sem.shape
    scales = scales * 0.3
    scales[-1] = torch.tensor([100.0, 100.0, 8.0], device="cuda")
    means[-1] = torch.tensor([0.0, 0.0, -1.0], device="cuda")
    quat = torch.tensor([[1.0, 0.0, 0.0, 0.0]], device="cuda").expand(p, 4)
    cov6 = build_covariance_inverse6(scales, quat)
    sem = torch.cat([randn(gen, p, c - 1).abs(),
                     torch.zeros(p, 1, device="cuda")], -1)
    sem[-1] = 0.0
    sem[-1, -1] = 10.0
    assert grid.num_voxels > 8192
    return grid, pts, means, opa, sem, scales, cov6


@pytest.mark.parametrize("empty_semantics", [10.0, 0.0])
def test_splat_additive_kernel_matches_plain(gen, empty_semantics):
    """K4 additive: each class column of the sums within 1e-4 of its own
    largest value; labels equal where the two largest sums differ by more
    than their tolerances, and 0 where no Gaussian reaches the voxel. With
    the whole-grid Gaussian's semantics at 10 it decides every label; at 0
    the small Gaussians do, and part of the grid is unreached."""
    grid, pts, means, opa, sem, scales, cov6 = _additive_case(gen)
    sem[-1, -1] = empty_semantics
    if not empty_semantics:
        # the small Gaussians into the lower-x half: the other is unreached
        x0 = grid.pc_min[0]
        means[:-1, 0] = x0 + (means[:-1, 0] - x0) * 0.5
    tables = pack_gaussians(means, opa, sem, scales, cov6, grid, "additive")
    got = splat.splat_accumulate_cuda(pts, *tables, grid, "additive")
    ref = splat.splat_accumulate_plain(pts, *tables, grid, "additive")
    assert got[1] is None and ref[1] is None
    acc, ref_acc = got[0][:, :-2], ref[0][:, :-2]
    tol = 1e-4 * ref_acc.abs().amax(0)
    assert ((acc - ref_acc).abs().amax(0) <= tol).all()
    top = ref_acc.topk(2, dim=-1)
    clear = (top.values[:, 0] - top.values[:, 1]) > tol[top.indices].sum(-1)
    assert torch.equal(got[2][clear], ref[2][clear])
    unreached = (ref_acc == 0).all(-1)
    assert (got[2][unreached] == 0).all()
    if empty_semantics:
        assert clear.float().mean() > 0.9
    else:
        assert ref[2][clear].unique().numel() > 2
        assert unreached.any()


def test_splat_additive_backward_kernel_matches_plain(gen):
    """K7 additive; the small boxes' rows held to their own largest value,
    without the whole-grid Gaussian's row (summed over every tile), which
    dwarfs them and is held on its own."""
    grid, pts, means, opa, sem, scales, cov6 = _additive_case(gen)
    gdata, box, _ = pack_gaussians(means, opa, sem, scales, cov6, grid,
                                   "additive")
    gl = randn(gen, pts.shape[0], sem.shape[1])
    args = (pts, gdata, opa, sem, box, gl, None, grid, "additive")
    got = splat.splat_backward_cuda(*args)
    ref = splat.splat_backward_plain(*args)
    for name, gt, rf in zip(("gmu", "gopa", "gsem", "gcov"), got, ref):
        _close(gt[:-1], rf[:-1], SUM_TOL, name + " of the small boxes")
        _close(gt[-1], rf[-1], SUM_TOL, name + " of the whole-grid box")
    with pytest.raises(ValueError):
        splat.splat_backward_cuda(*args[:6], randn(gen, pts.shape[0], 3),
                                  grid, "additive")


def _bins_case(gen, case):
    """(grid, points, box) of a splat case for the bins: ``iso`` and
    ``per_axis`` boxes of the mixed-radius case, ``additive`` with the
    whole-grid Gaussian, ``wide`` with scales three times larger (boxes
    holding partial bricks whole: COVERS entries at the grid's edges)."""
    if case == "additive":
        grid, pts, means, opa, sem, scales, cov6 = _additive_case(gen)
    else:
        grid, pts, means, opa, sem, scales, cov6 = _splat_case(gen)
    if case == "wide":
        scales = scales * 3.0
    _, box, _ = pack_gaussians(means, opa, sem, scales, cov6, grid,
                               per_axis=case == "per_axis")
    return grid, pts, box


@pytest.mark.parametrize("case", ["iso", "per_axis", "additive", "wide"])
def test_splat_bins_match_plain(gen, case):
    """The binning launches (count, offsets, expand, columns, tiles,
    place) give the plain version's bins exactly, twice over: sized by the
    boxes' own tiles, and in arrays sized by the bound of any boxes (the
    first ``tile_start[-1]`` entries and slots are the bins); the tile
    edges and the Gaussian block of the CUDA source are the Python
    constants. A bound below the entries raises."""
    dims = (ctypes.c_int * 4)()
    _lib.lib().gf_splat_tile_dims(dims)
    assert tuple(dims) == splat.TILE + (splat.GBLOCK,)
    grid, pts, box = _bins_case(gen, case)
    ref = splat.bin_gaussians_plain(box.cpu(), grid)
    e = ref.num_entries
    for cap in (None, splat.entries_bound(box.shape[0], grid)):
        got = splat.bin_gaussians_cuda(pts, box, grid, max_entries=cap)
        assert got.capacity == (e if cap is None else cap)
        for name in ("tile_start", "tile_items", "entries", "slot",
                     "gauss_start"):
            a = getattr(got, name)
            if name in ("entries", "slot"):
                a = a[:e]
            assert torch.equal(a.cpu(), getattr(ref, name)), name
    assert got.num_entries > box.shape[0]
    with pytest.raises(ValueError, match="bound"):
        splat.bin_gaussians_cuda(pts, box, grid, max_entries=e - 1)
    if case in ("additive", "wide"):
        assert got.covers().any()


def test_splat_bins_in_a_cuda_graph(gen):
    """The binning reads nothing back while a CUDA graph is captured: the
    replay gives the eager bins, and the flag word, checked after the
    replay (``check_deferred_flags``), still refuses points declared the
    raster grid that are not it (the one refusal left: an eager call sends
    them to the general mode). Points not declared the grid take the
    general mode in the capture too: one points binning plus K4, replayed,
    equals the eager call."""
    grid, pts, box = _bins_case(gen, "iso")
    cap = splat.entries_bound(box.shape[0], grid)
    ref = splat.bin_gaussians_cuda(pts, box, grid, max_entries=cap)
    flipped = pts.flip(0).contiguous()
    for points, ok in ((pts, True), (flipped, False)):
        splat.DEFERRED_FLAGS.clear()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = splat.bin_splat_cuda(points, box, grid, max_entries=cap)
        assert len(splat.DEFERRED_FLAGS) == 1 and got.points is None
        graph.replay()
        torch.cuda.synchronize()
        if ok:
            splat.check_deferred_flags()
            e = ref.num_entries
            for name in ("tile_start", "tile_items", "entries", "slot",
                         "gauss_start"):
                a, b = getattr(got, name), getattr(ref, name)
                if name in ("entries", "slot"):
                    a, b = a[:e], b[:e]
                assert torch.equal(a, b), name
        else:
            with pytest.raises(ValueError, match="raster"):
                splat.check_deferred_flags()
    _, _, means, opa, sem, scales, cov6 = _splat_case(gen)
    tables = pack_gaussians(means, opa, sem, scales, cov6, grid)
    eager = splat.bin_splat_cuda(flipped, tables[1], grid, max_entries=cap)
    assert eager.points is not None
    want = splat.splat_accumulate_cuda(flipped, *tables, grid, bins=eager)
    _lib.reset_launches()
    splat.DEFERRED_FLAGS.clear()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        bins = splat.bin_splat_cuda(flipped, tables[1], grid,
                                    max_entries=cap, grid_ordered=False)
        out = splat.splat_accumulate_cuda(flipped, *tables, grid, bins=bins)
    assert bins.points is not None
    assert (_lib.LAUNCHES["splat_points_bin"], _lib.LAUNCHES["splat_points"],
            _lib.LAUNCHES["splat_bin"], _lib.LAUNCHES["splat"]) == (1, 1, 1,
                                                                     0)
    graph.replay()
    torch.cuda.synchronize()
    splat.check_deferred_flags()
    splat.DEFERRED_FLAGS.clear()
    assert _equal(out, want)


def test_splat_kernel_refuses_non_raster_points(gen):
    """K4 takes any points: at the grid's points in reverse order, or one
    fewer, it takes the general mode (the points binning and
    ``csrc/splat_points.cu``) and agrees with the plain version; the one
    refusal left is K4 handed raster bins for other points (no fallback)."""
    grid, pts, means, opa, sem, scales, cov6 = _splat_case(gen)
    for variant in ("prob", "additive"):
        tables = pack_gaussians(means, opa, sem, scales, cov6, grid, variant)
        for bad in (pts.flip(0).contiguous(), pts[:-1].contiguous()):
            _lib.reset_launches()
            got = splat.splat_accumulate_cuda(bad, *tables, grid, variant)
            key = "splat_points" if variant == "prob" else \
                "splat_points_additive"
            assert _lib.LAUNCHES[key] == 1
            assert _lib.LAUNCHES["splat_points_bin"] == 1
            ref = splat.splat_accumulate_plain(bad, *tables, grid, variant)
            assert (got[0] - ref[0]).abs().max() <= \
                1e-4 * ref[0].abs().max()
        raster = splat.bin_gaussians_cuda(pts, tables[1], grid)
        with pytest.raises(ValueError, match="voxel grid"):
            splat.splat_accumulate_cuda(pts[:-1].contiguous(), *tables, grid,
                                        variant, bins=raster)


def _equal(a, b):
    return all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(a, b))


@pytest.mark.parametrize("variant", ["prob", "additive"])
def test_splat_kernels_repeat_bit_equal(gen, variant):
    """K4 and K7 give the same bits on two calls: each voxel sums its
    Gaussians in index order, each Gaussian its tiles in raster order, with
    no atomics; for the additive variant this includes the whole-grid
    Gaussian's gradient row."""
    case = _additive_case if variant == "additive" else _splat_case
    grid, pts, means, opa, sem, scales, cov6 = case(gen)
    tables = pack_gaussians(means, opa, sem, scales, cov6, grid, variant)
    fwd = [splat.splat_accumulate_cuda(pts, *tables, grid, variant)
           for _ in range(2)]
    assert _equal(*fwd)
    n, c = pts.shape[0], sem.shape[1]
    gl = randn(gen, n, c)
    scalars = randn(gen, n, 3) if variant == "prob" else None
    args = (pts, tables[0], opa, sem, tables[1], gl, scalars, grid, variant)
    bwd = [splat.splat_backward_cuda(*args) for _ in range(2)]
    assert _equal(*bwd)
    assert all(t[-1].abs().max() > 0 for t in bwd[0])


@pytest.mark.parametrize("variant", ["prob", "additive"])
def test_splat_kernels_on_given_bins_equal_their_own(gen, variant):
    """K4 and K7 on bins built beforehand (as the autograd function hands
    the forward's bins to the backward) give the bits of K4 and K7 building
    their own."""
    case = _additive_case if variant == "additive" else _splat_case
    grid, pts, means, opa, sem, scales, cov6 = case(gen)
    tables = pack_gaussians(means, opa, sem, scales, cov6, grid, variant)
    bins = splat.bin_gaussians_cuda(pts, tables[1], grid)
    assert _equal(splat.splat_accumulate_cuda(pts, *tables, grid, variant,
                                              bins=bins),
                  splat.splat_accumulate_cuda(pts, *tables, grid, variant))
    gl = randn(gen, pts.shape[0], sem.shape[1])
    scalars = randn(gen, pts.shape[0], 3) if variant == "prob" else None
    args = (pts, tables[0], opa, sem, tables[1], gl, scalars, grid, variant)
    assert _equal(splat.splat_backward_cuda(*args, bins=bins),
                  splat.splat_backward_cuda(*args))
    other = splat.bin_gaussians_cuda(pts, tables[1][:-1].contiguous(), grid)
    with pytest.raises(ValueError):
        splat.splat_backward_cuda(*args, bins=other)


@pytest.mark.parametrize("variant", ["prob", "additive"])
def test_splat_kernels_no_whole_brick(gen, variant):
    """The 40 x 30 x 8 grid, where no tile is a whole brick (8 voxels of a
    tile's 16 along z, 6 of 8 along y in the last row), with boxes three
    times wider, so that many entries COVER a partial brick: K4 and K7
    against their plain versions with the tolerances above."""
    grid, pts, means, opa, sem, scales, cov6 = _splat_case(gen)
    assert grid.D < splat.TILE[2]
    scales = scales * 3.0
    cov6 = build_covariance_inverse6(scales, randn(gen, scales.shape[0], 4))
    tables = pack_gaussians(means, opa, sem, scales, cov6, grid, variant)
    bins = splat.bin_gaussians_cuda(pts, tables[1], grid)
    assert bins.covers().float().mean() > 0.2
    got = splat.splat_accumulate_cuda(pts, *tables, grid, variant)
    ref = splat.splat_accumulate_plain(pts, *tables, grid, variant)
    assert (got[0] - ref[0]).abs().max() <= 1e-4 * ref[0].abs().max()
    if variant == "prob":
        assert (got[1] - ref[1]).abs().max() <= 1e-4
    n, c = pts.shape[0], sem.shape[1]
    gl = randn(gen, n, c)
    scalars = randn(gen, n, 3) if variant == "prob" else None
    args = (pts, tables[0], opa, sem, tables[1], gl, scalars, grid, variant)
    got = splat.splat_backward_cuda(*args)
    ref = splat.splat_backward_plain(*args)
    for name, gt, rf in zip(("gmu", "gopa", "gsem", "gcov"), got, ref):
        _close(gt, rf, SUM_TOL, name)


@pytest.mark.parametrize("variant", ["prob", "additive"])
def test_splat_kernels_on_split_tiles(gen, variant):
    """A crowded tile (300 of the 700 Gaussians, small, near one corner of
    the grid) has more than twice the mean list length, so the bins give it
    as two work items (K4 takes its x planes in halves, K7 its entries):
    K4 and K7 against their plain versions, and twice the same bits."""
    case = _additive_case if variant == "additive" else _splat_case
    grid, pts, means, opa, sem, scales, cov6 = case(gen)
    lo = torch.tensor(grid.pc_min, device="cuda")
    means[:300] = lo + torch.rand(300, 3, generator=gen, device="cuda") * 2.0
    scales[:300] = scales[:300].clamp_max(0.4)
    cov6 = build_covariance_inverse6(scales, randn(gen, scales.shape[0], 4))
    tables = pack_gaussians(means, opa, sem, scales, cov6, grid, variant)
    bins = splat.bin_gaussians_cuda(pts, tables[1], grid)
    items = bins.tile_items.tolist()
    assert items[:2] == [1, 2]   # tile 0's halves come first
    got = splat.splat_accumulate_cuda(pts, *tables, grid, variant)
    ref = splat.splat_accumulate_plain(pts, *tables, grid, variant)
    assert (got[0] - ref[0]).abs().max() <= 1e-4 * ref[0].abs().max()
    if variant == "prob":
        assert (got[1] - ref[1]).abs().max() <= 1e-4
        assert (got[2] == ref[2]).float().mean() >= 0.999
    assert _equal(got, splat.splat_accumulate_cuda(pts, *tables, grid,
                                                   variant))
    gl = randn(gen, pts.shape[0], sem.shape[1])
    scalars = randn(gen, pts.shape[0], 3) if variant == "prob" else None
    args = (pts, tables[0], opa, sem, tables[1], gl, scalars, grid, variant)
    got = splat.splat_backward_cuda(*args)
    ref = splat.splat_backward_plain(*args)
    for name, gt, rf in zip(("gmu", "gopa", "gsem", "gcov"), got, ref):
        _close(gt, rf, SUM_TOL, name)
    assert _equal(got, splat.splat_backward_cuda(*args))


def _points_case(gen, case):
    """Query points of the splat's general mode on the 40 x 30 x 8 grid of
    :func:`_splat_case`: ``fine``, the voxel centres of a grid twice as
    fine (8 points a voxel, in its raster order); ``outside``, the grid's
    own centres shuffled with one in ten moved past ``pc_range`` (they fall
    into border voxels); ``crowded``, 3000 random points of which 2000 in
    one corner voxel (a tile of more than ``TILE_VOXELS`` points); ``odd``,
    1001 random points, some outside; ``pileup``, 6000 points in one voxel
    and 500 random ones (K7 cuts the boxes that hold the voxel into
    pieces)."""
    grid = _splat_case(gen)[0]
    lo = torch.tensor(grid.pc_min, device="cuda")
    span = torch.tensor([grid.H, grid.W, grid.D], device="cuda") * 0.5
    if case == "fine":
        axes = [torch.arange(2 * n, device="cuda") * 0.25 + 0.125 + l0
                for n, l0 in zip((grid.H, grid.W, grid.D), grid.pc_min)]
        return torch.stack(torch.meshgrid(*axes, indexing="ij"),
                           -1).reshape(-1, 3).contiguous()
    if case == "outside":
        pts = _splat_case(gen)[1]
        perm = torch.randperm(pts.shape[0], generator=gen, device="cuda")
        pts = pts[perm].clone()
        k = pts.shape[0] // 10
        pts[:k] += (torch.rand(k, 3, generator=gen, device="cuda") - 0.5) \
            * span * 3
        return pts.contiguous()
    if case == "pileup":
        pts = lo + torch.rand(6500, 3, generator=gen, device="cuda") * span
        pts[:6000] = lo + torch.tensor([3.2, 7.7, 1.4], device="cuda")
        return pts.contiguous()
    n = 3000 if case == "crowded" else 1001
    pts = lo - 0.2 * span + torch.rand(n, 3, generator=gen, device="cuda") \
        * span * 1.4
    if case == "crowded":
        pts[:2000] = lo + torch.rand(2000, 3, generator=gen,
                                     device="cuda") * 0.4
    return pts.contiguous()


POINTS_CASES = ["fine", "outside", "crowded", "odd", "pileup"]


@pytest.mark.parametrize("case", POINTS_CASES)
def test_splat_points_bins_match_plain(gen, case):
    """The points binning (two sort passes here: 60 tiles x 1024 places)
    gives the plain version's bins in every element, with no host read,
    and again on a second call."""
    grid = _splat_case(gen)[0]
    pts = _points_case(gen, case)
    ref = splat.bin_points_plain(pts, grid)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = splat.bin_points_cuda(pts, grid)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for name in ("order", "voxel_start", "items"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    again = splat.bin_points_cuda(pts, grid)
    assert torch.equal(again.order, got.order)
    if case in ("crowded", "pileup"):
        assert got.stats()["max_tile_points"] > splat.TILE_VOXELS
    if case == "pileup":
        assert got.stats()["max_voxel_points"] >= 6000


def test_splat_points_bins_two_passes(gen):
    """A grid of more than 1024 tiles sorts in three radix passes (21 key
    bits): the bins still equal the plain ones."""
    grid = SplatGridSpec(H=192, W=192, D=32, pc_min=(-48.0, -48.0, -8.0),
                         grid_size=0.5)
    assert math.prod(splat.tile_counts(grid)) > 1024
    pts = (torch.rand(200000, 3, generator=gen, device="cuda")
           * torch.tensor([104.0, 104.0, 18.0], device="cuda")
           - torch.tensor([52.0, 52.0, 9.0], device="cuda")).contiguous()
    got = splat.bin_points_cuda(pts, grid)
    ref = splat.bin_points_plain(pts, grid)
    for name in ("order", "voxel_start", "items"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def _points_tables(gen, variant, per_axis=False):
    case = _additive_case if variant == "additive" else _splat_case
    grid, _, means, opa, sem, scales, cov6 = case(gen)
    tables = pack_gaussians(means, opa, sem, scales, cov6, grid, variant,
                            per_axis)
    return grid, opa, sem, tables


@pytest.mark.parametrize("case", POINTS_CASES)
@pytest.mark.parametrize("variant", ["prob", "additive", "threshold",
                                     "per_axis"])
def test_splat_points_kernels_match_plain(gen, variant, case):
    """K4 and K7 in the general mode against their plain versions at any
    points: K4's sums within 1e-4 of the largest, ``one_minus`` within
    1e-4, labels equal but for near-ties (the combine scores' top two
    within 1e-6; additive: where the two largest sums differ by more than
    their columns' tolerances); K7 within 1e-3 of each output's largest
    (the additive whole-grid Gaussian's row on its own). A second call of
    each gives the same bits."""
    kind = "additive" if variant == "additive" else "prob"
    grid, opa, sem, tables = _points_tables(gen, kind, variant == "per_axis")
    pts = _points_case(gen, case)
    kw = (dict(label_mode="threshold", thresh=0.95, empty_label=17)
          if variant == "threshold" else {})
    bins = splat.bin_splat_cuda(pts, tables[1], grid, grid_ordered=False)
    assert bins.points is not None
    got = splat.splat_accumulate_cuda(pts, *tables, grid, kind, bins=bins,
                                      **kw)
    assert _equal(got, splat.splat_accumulate_cuda(pts, *tables, grid, kind,
                                                   bins=bins, **kw))
    ref = splat.splat_accumulate_plain(pts, *tables, grid, kind, **kw)
    c = sem.shape[1]
    if kind == "additive":
        acc, ref_acc = got[0][:, :c], ref[0][:, :c]
        tol = 1e-4 * ref_acc.abs().amax(0)
        assert ((acc - ref_acc).abs().amax(0) <= tol).all()
        top = ref_acc.topk(2, dim=-1)
        clear = (top.values[:, 0] - top.values[:, 1]) > \
            tol[top.indices].sum(-1)
        assert torch.equal(got[2][clear], ref[2][clear])
    else:
        assert (got[0] - ref[0]).abs().max() <= 1e-4 * ref[0].abs().max()
        assert (got[1] - ref[1]).abs().max() <= 1e-4
        logits, bins_p, _ = splat.postprocess_prob(ref[0], ref[1])
        if variant == "threshold":
            top = logits.topk(2, dim=-1).values
            near = ((bins_p - 0.95).abs() < 1e-6) | (
                (bins_p > 0.95) & (top[:, 0] - top[:, 1] < 1e-6))
        else:
            top = splat.combine_geosem(logits, bins_p).topk(2, -1).values
            near = top[:, 0] - top[:, 1] <= 1e-6
        assert torch.equal(got[2][~near], ref[2][~near])
    n = pts.shape[0]
    gl = randn(gen, n, c)
    scalars = randn(gen, n, 3) if kind == "prob" else None
    args = (pts, tables[0], opa, sem, tables[1], gl, scalars, grid, kind)
    got = splat.splat_backward_cuda(*args, bins=bins)
    assert _equal(got, splat.splat_backward_cuda(*args, bins=bins))
    ref = splat.splat_backward_plain(*args)
    for name, gt, rf in zip(("gmu", "gopa", "gsem", "gcov"), got, ref):
        if kind == "additive":
            _close(gt[:-1], rf[:-1], SUM_TOL, name + " of the small boxes")
            _close(gt[-1], rf[-1], SUM_TOL, name + " of the whole-grid box")
        else:
            _close(gt, rf, SUM_TOL, name)


@pytest.mark.parametrize("variant", ["prob", "additive"])
def test_splat_points_backward_in_pieces(gen, variant):
    """K7's general mode on 40,000 points piled into one voxel and 2000
    random ones, with the entries' room cut to their count, so that the
    pieces of the smallest size overflow the piece budget (twice the
    groups of entries the room holds) and a larger size is taken: the
    plain version's sums to 1e-3, a second call and a CUDA graph's replay
    give the same bits, and the piece launch's longest block is timed."""
    grid, opa, sem, tables = _points_tables(gen, variant)
    lo = torch.tensor(grid.pc_min, device="cuda")
    span = torch.tensor([grid.H, grid.W, grid.D], device="cuda") * 0.5
    pts = lo + torch.rand(42000, 3, generator=gen, device="cuda") * span
    pts[:40000] = lo + torch.tensor([6.2, 4.7, 1.4], device="cuda")
    pts = pts.contiguous()
    e = splat.bin_splat_cuda(pts, tables[1], grid,
                             grid_ordered=False).num_entries
    bins = splat.bin_splat_cuda(pts, tables[1], grid, e, grid_ordered=False)
    assert bins.capacity == e
    # the smallest pieces (1024 points) of every entry's box points
    vox = grid.voxelize(pts).long()
    lengths = (bins.tile_start[1:] - bins.tile_start[:-1]).long()
    tile = torch.repeat_interleave(torch.arange(lengths.shape[0],
                                                device="cuda"), lengths)
    nt = splat.tile_counts(grid)
    size = torch.tensor(splat.TILE, device="cuda")
    t_lo = torch.stack([tile // (nt[1] * nt[2]), tile // nt[2] % nt[1],
                        tile % nt[2]], -1) * size
    b = tables[1][bins.gaussians().long()].long()
    b_lo, b_hi = torch.maximum(b[:, :3], t_lo), torch.minimum(
        b[:, 3:], t_lo + size - 1)
    n_e = ((vox[None] >= b_lo[:, None]) & (vox[None] <= b_hi[:, None])
           ).all(-1).sum(-1)
    assert splat.points_piece_level(n_e, e, variant) > 0
    c = sem.shape[1]
    gl = randn(gen, pts.shape[0], c)
    scalars = randn(gen, pts.shape[0], 3) if variant == "prob" else None
    args = (pts, tables[0], opa, sem, tables[1], gl, scalars, grid, variant)
    times = {}
    got = splat.splat_backward_cuda(*args, bins=bins, block_times=times)
    assert 0.0 < splat.block_share(times["k7"]) <= 1.0
    ref = splat.splat_backward_plain(*args)
    for name, gt, rf in zip(("gmu", "gopa", "gsem", "gcov"), got, ref):
        if variant == "additive":
            _close(gt[:-1], rf[:-1], SUM_TOL, name)
            _close(gt[-1], rf[-1], SUM_TOL, name + " of the whole-grid box")
        else:
            _close(gt, rf, SUM_TOL, name)
    assert _equal(got, splat.splat_backward_cuda(*args, bins=bins))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = splat.splat_backward_cuda(*args, bins=bins)
    graph.replay()
    torch.cuda.synchronize()
    assert _equal(got, replayed)


@pytest.mark.parametrize("variant", ["prob", "additive"])
def test_splat_points_forward_block_times(gen, variant):
    """K4's general mode records each work item's block time on request;
    with and without the record it gives the same bits."""
    kind = variant
    grid, opa, sem, tables = _points_tables(gen, kind)
    pts = _points_case(gen, "pileup")
    bins = splat.bin_splat_cuda(pts, tables[1], grid, grid_ordered=False)
    times = {}
    got = splat.splat_accumulate_cuda(pts, *tables, grid, kind, bins=bins,
                                      block_times=times)
    assert times["k4"].shape[0] == splat.K4_BLOCKS_PER_ITEM[kind] * (
        bins.points.items.shape[0] - 1)
    assert 0.0 < splat.block_share(times["k4"]) <= 1.0
    assert _equal(got, splat.splat_accumulate_cuda(pts, *tables, grid, kind,
                                                   bins=bins))


@pytest.mark.parametrize("variant", ["prob", "additive"])
def test_splat_points_on_the_grid_equal_the_raster_mode(gen, variant):
    """The general mode at the raster grid's own points, permuted: K4's
    rows (put back in raster order) are the raster mode's to the prob
    tolerance, its labels equal but for near-ties, and K7 (on the permuted
    cotangent rows) the raster K7's to 1e-3: the sums run in another
    order."""
    grid, opa, sem, tables = _points_tables(gen, variant)
    pts = _splat_case(gen)[1]
    perm = torch.randperm(pts.shape[0], generator=gen, device="cuda")
    inv = torch.argsort(perm)
    raster = splat.splat_accumulate_cuda(pts, *tables, grid, variant)
    gen_out = splat.splat_accumulate_cuda(pts[perm].contiguous(), *tables,
                                          grid, variant)
    acc = gen_out[0][inv]
    assert (acc - raster[0]).abs().max() <= 1e-4 * raster[0].abs().max()
    same = (gen_out[2][inv] == raster[2]).float().mean()
    assert same >= 0.999
    c = sem.shape[1]
    gl = randn(gen, pts.shape[0], c)
    scalars = randn(gen, pts.shape[0], 3) if variant == "prob" else None
    args = (tables[0], opa, sem, tables[1])
    want = splat.splat_backward_cuda(pts, *args, gl, scalars, grid, variant)
    got = splat.splat_backward_cuda(
        pts[perm].contiguous(), *args, gl[perm].contiguous(),
        None if scalars is None else scalars[perm].contiguous(), grid,
        variant)
    for name, gt, rf in zip(("gmu", "gopa", "gsem", "gcov"), got, want):
        if variant == "additive":
            _close(gt[:-1], rf[:-1], SUM_TOL, name)
        else:
            _close(gt, rf, SUM_TOL, name)


PC_RANGE = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
#: (anchors, C_in, C_out, grid size, bias, layers through one table): the
#: gs144000 conv (blocks of 128 rows, P a multiple of 128), Prob-64's three
#: (blocks of 64 rows), a P that takes blocks of 128 rows with a partial
#: last one, narrow ones at a P that is no multiple of 64 (C_out 32 and
#: 96: a block's 128 channels past C_out are zeros) and C_out 288 (three
#: column blocks, the last one partial)
SPCONV_CASES = {
    "gs144000": (144000, 128, 128, (0.5, 0.5, 0.5), False, 1),
    "prob64": (6400, 128, 128, (1.0, 1.0, 1.0), True, 3),
    "ragged128": (40037, 128, 128, (0.5, 0.5, 0.5), False, 1),
    "wide": (3001, 64, 288, (1.0, 1.0, 1.0), True, 2),
    "narrow": (1000, 32, 32, (1.0, 1.0, 1.0), True, 1),
    "ragged": (1000, 64, 96, (2.0, 2.0, 0.5), False, 2),
}


def _spconv_coords(gen, p, grid_size, shared=0.05, outside=0.02):
    """int32 voxel coordinates of ``p`` anchors spread over pc_range,
    ``shared`` of them in another anchor's voxel and ``outside`` of them
    past the range (clamped to the border), and the grid's shape."""
    lo = torch.tensor(PC_RANGE[:3], device="cuda")
    span = torch.tensor(PC_RANGE[3:], device="cuda") - lo
    u = torch.rand(p, 3, generator=gen, device="cuda")
    n_out = int(p * outside)
    u[:n_out] = u[:n_out] * 1.4 - 0.2
    n_sh = int(p * shared)
    src = torch.randint(0, p, (n_sh,), generator=gen, device="cuda")
    u[p - n_sh:] = u[src]
    coords, shape = voxel_indices(lo + u * span, PC_RANGE, grid_size)
    return coords.to(torch.int32).contiguous(), shape


def _spconv_layers(gen, cin, cout, bias, layers):
    out = []
    for i in range(layers):
        ci = cin if i == 0 else cout
        w = randn(gen, cout, 5, 5, 5, ci, scale=(125 * ci) ** -0.5)
        out.append((w, randn(gen, cout, scale=0.1) if bias else None))
    return out


@pytest.mark.parametrize("case", list(SPCONV_CASES))
def test_spconv_kernel_matches_plain(gen, case):
    """The voxel table equals its plain version; each conv (every layer on
    the kernel's previous output, LayerNorm and ReLU between, as Prob's
    three) is held to the gather form twice. Against the gather form in
    fp32 on the same bf16 inputs (the kernel's arithmetic, sums in another
    order): SUM_TOL. Against the bf16 gather form: it rounds each chunk of
    25 taps' product to bf16 (half an ulp, 2^-8 of the chunk, five times)
    where the kernel sums all 125 taps in fp32, so 2^-5 max|ref|. Two calls
    give the same bits; one table launch and one conv launch a layer. The
    block height the kernel takes is the one the case names."""
    p, cin, cout, grid_size, bias, layers = SPCONV_CASES[case]
    assert spconv.block_rows(p, cout) == (
        64 if case in ("prob64", "narrow", "ragged", "wide") else 128)
    coords, shape = _spconv_coords(gen, p, grid_size)
    convs = _spconv_layers(gen, cin, cout, bias, layers)
    x = randn(gen, p, cin)
    _lib.reset_launches()
    table = spconv.voxel_table_cuda(coords, shape)
    assert torch.equal(table, spconv.voxel_table_plain(coords, shape))
    for w, b in convs:
        got = spconv.submanifold_conv3d_cuda(x, coords, table, shape, w, b)
        again = spconv.submanifold_conv3d_cuda(x, coords, table, shape, w, b)
        assert torch.equal(got, again)
        assert got.dtype == torch.float32 and got.shape == (p, cout)
        ref32 = spconv.submanifold_conv3d_table_plain(
            x.bfloat16().float(), coords, table, shape, w.bfloat16().float(),
            b, compute_dtype=torch.float32)
        _close(got, ref32, SUM_TOL, f"{case} fp32")
        ref = spconv.submanifold_conv3d_table_plain(x, coords, table, shape,
                                                    w, b)
        _close(got, ref, 2.0 ** -5, f"{case} bf16")
        x = torch.relu(torch.nn.functional.layer_norm(got, (cout,)))
    torch.cuda.synchronize()
    assert (_lib.LAUNCHES["spconv_table"], _lib.LAUNCHES["spconv"]) == (
        1, 2 * layers)


def test_spconv_kernel_skips_empty_taps(gen):
    """Row tile 0's anchors find no neighbour in the table (it was built
    from coordinates that put them far away): every tap of that tile is
    skipped and its rows are the bias. The counters equal the plain
    neighbour rule's non-empty pairs and per-tile empty taps."""
    p, c, X, Y, Z = 700, 64, 24, 10, 6
    shape = (X, Y, Z)
    rows = torch.stack([
        torch.randint(0, 3, (p,), generator=gen, device="cuda"),
        torch.randint(0, Y, (p,), generator=gen, device="cuda"),
        torch.randint(0, Z, (p,), generator=gen, device="cuda")], -1)
    rows[64:, 0] += 8                       # the other tiles at x >= 8
    in_table = rows.clone()
    in_table[:64, 0] = X - 1                # tile 0's own voxels far away
    rows = rows.to(torch.int32).contiguous()
    table = spconv.voxel_table_cuda(in_table.to(torch.int32).contiguous(),
                                    shape)
    w = randn(gen, c, 5, 5, 5, c, scale=0.02)
    b = randn(gen, c)
    x = randn(gen, p, c)
    profiling.enable()
    try:
        got = spconv.submanifold_conv3d_cuda(x, rows, table, shape, w, b)
        counters = profiling.collect()["counters"]
    finally:
        profiling.disable()
    assert torch.equal(got[:64], b.expand(64, c))
    ref = spconv.submanifold_conv3d_table_plain(x, rows, table, shape, w, b)
    _close(got, ref, 2.0 ** -5, "empty tile")
    nb = spconv.tap_neighbors_plain(rows, table, shape, 5)
    bm = spconv.block_rows(p, c)
    tiles = torch.nn.functional.pad((nb >= 0).int(), (0, 0, 0, -p % bm))
    empty_taps = (tiles.reshape(-1, bm, 125).sum(1) == 0).sum().item()
    assert (nb[:64] < 0).all()
    assert counters["spconv_pairs"] == (nb >= 0).sum().item()
    assert counters["spconv_taps_skipped"] == empty_taps >= 125


#: the block ends of a Prob-64 tower's layer1 and layer4 (6 cameras at 864
#: x 1600), and a ragged width whose C / 8 does not divide a block
BN_SHAPES = [(6, 256, 216, 400), (6, 2048, 27, 50), (3, 136, 7, 9)]


def _bn_stats(gen, c, eps):
    return (randn(gen, c).abs() + 0.5, randn(gen, c), randn(gen, c),
            randn(gen, c).abs() + 0.1, eps)


@pytest.mark.parametrize("shape", BN_SHAPES)
@pytest.mark.parametrize("form", ["relu", "identity", "downsample"])
def test_bn_epilogue_kernel_matches_plain(gen, form, shape):
    """The frozen-BN epilogue on bf16 channels-last tensors against its
    plain version (the same fp32 arithmetic, one rounding to bf16: at most a
    rounding flip, BF16_TOL), twice the same bits, one launch a call."""
    c = shape[1]
    a = randn(gen, *shape, scale=3.0).bfloat16().contiguous(
        memory_format=torch.channels_last)
    b = randn(gen, *shape, scale=3.0).bfloat16().contiguous(
        memory_format=torch.channels_last)
    args = {"relu": (a, _bn_stats(gen, c, 1e-5)),
            "identity": (a, _bn_stats(gen, c, 1e-5), b),
            "downsample": (a, _bn_stats(gen, c, 1e-5), b,
                           _bn_stats(gen, c, 1e-3))}[form]
    _lib.reset_launches()
    got = bn_epilogue.bn_epilogue_cuda(*args)
    again = bn_epilogue.bn_epilogue_cuda(*args)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["bn_epilogue"] == 2
    assert torch.equal(got, again)
    assert got.dtype == torch.bfloat16 and got.shape == a.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    ref = bn_epilogue.bn_epilogue_plain(*args)
    _close(got.float(), ref.float(), BF16_TOL, f"{form} {shape}")
    assert (got == 0).any() and (got > 0).any()


def test_bn_epilogue_in_the_tower(gen):
    """A bf16 ResNet-26 (DCN in stages 3-4) on the card: under inference
    mode its 11 epilogue launches (the stem, 4 bn1, 2 bn2 outside the DCN
    blocks, 4 block ends) against the same module with gradients on, whose
    PyTorch passes round to bf16 after each operation: within 2^-5 of each
    stage output's largest value."""
    from gaussianformer_tpu_torch.models.backbone.resnet import ResNet
    from gaussianformer_tpu_torch.models.segmentor import init_random_
    tower = ResNet(26, 16, (False, False, True, True), dtype=torch.bfloat16)
    with torch.no_grad():
        init_random_(tower, torch.Generator().manual_seed(0))
    tower = tower.cuda().eval()
    imgs = randn(gen, 2, 3, 128, 192)
    _lib.reset_launches()
    with torch.inference_mode():
        fused = tower(imgs)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["bn_epilogue"] == 11 and _lib.LAUNCHES["dcn"] == 2
    eager = tower(imgs)
    for f, e in zip(fused, eager):
        _close(f.float(), e.detach().float(), 2.0 ** -5, "tower")
