"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small shapes with the edge cases the flagship path does not
reach: DCN offsets of several pixels (corners outside the image), masked
and exhausted FPS, fp32 deformable features, a splat with sparse and dense
coverage, the additive splat with the v1 head's whole-grid Gaussian; and
the backward kernels K5-K7 against their plain backward versions on random
cotangents. Marked ``cuda``; they skip on a host
without a CUDA device. On the card (``--noconftest``: tests/conftest.py
imports JAX):
``python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda``.

Tolerances: a bf16 output may differ by a rounding flip of its fp32 sum,
so 2^-7 max|ref| (two bf16 ulps at the top of the range); fp32 gradients
summed over thousands of terms in another order (atomics, in an order that
changes from run to run) get 1e-3 max|ref|."""
import pytest
import torch

from gaussianformer_tpu_torch.kernels import dcn, deformable, fps, splat
from gaussianformer_tpu_torch.ops.covariance import build_covariance_inverse6
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


def test_splat_kernel_matches_plain(gen):
    grid, pts, means, opa, sem, scales, cov6 = _splat_case(gen)
    tables = pack_gaussians(means, opa, sem, scales, cov6, grid)
    got = splat.splat_accumulate_cuda(pts, *tables, grid)
    ref = splat.splat_accumulate_plain(pts, *tables, grid)
    assert (got[0] - ref[0]).abs().max() <= 1e-4 * ref[0].abs().max()
    assert (got[1] - ref[1]).abs().max() <= 1e-4
    assert (got[2] == ref[2]).float().mean() >= 0.999


def _close(got, ref, tol, name):
    err = (got.float() - ref.float()).abs().max()
    assert err <= tol * ref.float().abs().max(), (name, err.item())


def test_dcn_backward_kernel_matches_plain(gen):
    """K5: two input-channel chunks, C_out not a multiple of the tiles, and
    enough pixels (2460) that the weight gradient splits them."""
    b, h, w, cin, cout = 2, 30, 41, 128, 136
    x = randn(gen, b, h, w, cin).bfloat16()
    om = randn(gen, b, h, w, 27, scale=3.0)
    offset, mask = om[..., :18], torch.sigmoid(om[..., 18:])
    weight = randn(gen, 3, 3, cin, cout, scale=0.05).bfloat16()
    g_out = randn(gen, b, h, w, cout).bfloat16()
    got = dcn.deform_conv2d_backward_cuda(x, offset, mask, weight, g_out)
    ref = dcn.deform_conv2d_backward_plain(x, offset, mask, weight, g_out)
    for name, gt, rf, tol in zip(("g_x", "g_offset", "g_mask", "g_weight"),
                                 got, ref, (BF16_TOL, SUM_TOL, SUM_TOL,
                                            BF16_TOL)):
        assert gt.dtype == rf.dtype and gt.shape == rf.shape, name
        _close(gt, rf, tol, name)


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


def test_splat_backward_kernel_matches_plain(gen):
    """K7 on random per-voxel cotangents; and the wrapper refuses points
    that are not the raster grid."""
    grid, pts, means, opa, sem, scales, cov6 = _splat_case(gen)
    gdata, box, _ = pack_gaussians(means, opa, sem, scales, cov6, grid)
    n, c = pts.shape[0], sem.shape[1]
    gl = randn(gen, n, c)
    scalars = randn(gen, n, 3)
    args = (pts, gdata, opa, sem, box, gl, scalars, grid)
    got = splat.splat_backward_cuda(*args)
    ref = splat.splat_backward_plain(*args)
    for name, gt, rf in zip(("gmu", "gopa", "gsem", "gcov"), got, ref):
        _close(gt, rf, SUM_TOL, name)
    with pytest.raises(ValueError):
        splat.splat_backward_cuda(pts.flip(0).contiguous(), *args[1:])


def _additive_case(gen):
    """The v1 head's shapes in small: many small boxes, one Gaussian whose
    box is the whole grid (more than the kernel's 8192-voxel limit for a
    single block, so it is walked in segments) and softplus-like positive
    semantics with a zero empty channel."""
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
    without the whole-grid Gaussian's row (summed in segments with
    atomics), which is held on its own."""
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
