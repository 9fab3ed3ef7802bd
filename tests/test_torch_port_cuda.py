"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small shapes with the edge cases the flagship forward does not
reach: DCN offsets of several pixels (corners outside the image), masked
and exhausted FPS, fp32 deformable features, a splat with sparse and dense
coverage. Marked ``cuda``; they skip on a host without a CUDA device. On
the card (``--noconftest``: tests/conftest.py imports JAX):
``python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda``."""
import pytest
import torch

from gaussianformer_tpu_torch.kernels import dcn, deformable, fps, splat
from gaussianformer_tpu_torch.ops.covariance import build_covariance_inverse6
from gaussianformer_tpu_torch.ops.splat import SplatGridSpec, pack_gaussians

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


def test_splat_kernel_matches_plain(gen):
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
    tables = pack_gaussians(means, opa, sem, scales, cov6, grid)
    got = splat.splat_accumulate_cuda(pts, *tables, grid)
    ref = splat.splat_accumulate_plain(pts, *tables, grid)
    assert (got[0] - ref[0]).abs().max() <= 1e-4 * ref[0].abs().max()
    assert (got[1] - ref[1]).abs().max() <= 1e-4
    assert (got[2] == ref[2]).float().mean() >= 0.999
