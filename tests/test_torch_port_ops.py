"""The PyTorch port's kernel ops and geometry against the JAX package, on
the CPU at fp32 (where each op runs its plain PyTorch version; the CUDA
kernels are held against those on the card by chip_smoke.py).

Inputs are made with numpy from a seed and fed to both packages. The JAX
side runs its CPU paths: the exact DCN gather (ops/dcn.py), masked FPS in
XLA, the XLA deformable gather, the XLA splat and its label twin.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaussianformer_tpu.ops import coords as jcoords
from gaussianformer_tpu.ops.covariance import build_covariance_inverse6
from gaussianformer_tpu.ops.dcn import deform_conv2d as jax_dcn
from gaussianformer_tpu.ops.deformable import \
    deformable_aggregation as jax_deformable
from gaussianformer_tpu.ops.fps import farthest_point_sampling as jax_fps
from gaussianformer_tpu.ops.rotation import quaternion_to_rotation_matrix
from gaussianformer_tpu.ops.sparse_conv import (
    submanifold_conv3d as jax_subm, voxel_indices as jax_voxel_indices)
from gaussianformer_tpu.ops.splat import SplatGridSpec as JaxGrid
from gaussianformer_tpu.ops.splat import _labels_xla, splat as jax_splat

from gaussianformer_tpu_torch.kernels.dcn import deform_conv2d
from gaussianformer_tpu_torch.kernels.deformable import \
    deformable_aggregation
from gaussianformer_tpu_torch.kernels.fps import farthest_point_sampling
from gaussianformer_tpu_torch.ops import coords, covariance, rotation
from gaussianformer_tpu_torch.ops.sparse_conv import (neighbor_anchors,
                                                      submanifold_conv3d,
                                                      voxel_indices)
from gaussianformer_tpu_torch.ops.splat import SplatGridSpec, splat_prob

PC_RANGE = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
RTOL = ATOL = 1e-4   # fp32 on both sides, sums in another order


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", ["rotation", "cov_inv6", "cartesian",
                                  "reverse_cartesian"])
def test_geometry_matches_jax(name):
    rng = np.random.RandomState(0)
    quat = rng.randn(64, 4).astype(np.float32)
    scales = (rng.rand(64, 3) * 2 + 0.1).astype(np.float32)
    xyz = rng.randn(64, 3).astype(np.float32) * 3
    world = (rng.rand(64, 3) * 90 - 45).astype(np.float32)
    ref, got = {
        "rotation": (lambda: (quaternion_to_rotation_matrix(quat),
                              rotation.quaternion_to_rotation_matrix(
                                  t(quat)))),
        "cov_inv6": (lambda: (build_covariance_inverse6(scales, quat),
                              covariance.build_covariance_inverse6(
                                  t(scales), t(quat)))),
        "cartesian": (lambda: (jcoords.cartesian(xyz, PC_RANGE),
                               coords.cartesian(t(xyz), PC_RANGE))),
        "reverse_cartesian": (lambda: (
            jcoords.reverse_cartesian(world, PC_RANGE),
            coords.reverse_cartesian(t(world), PC_RANGE))),
    }[name]()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("epilogue", [False, True])
def test_dcn_matches_jax(epilogue):
    """Exact for any offset: offsets of several pixels push corners out of
    the image, which must contribute zero."""
    rng = np.random.RandomState(1)
    b, h, w, cin, cout = 2, 7, 9, 16, 8
    x = rng.randn(b, h, w, cin).astype(np.float32)
    offset = (rng.randn(b, h, w, 18) * 2.5).astype(np.float32)
    mask = (1 / (1 + np.exp(-rng.randn(b, h, w, 9)))).astype(np.float32)
    weight = (rng.randn(3, 3, cin, cout) / 12).astype(np.float32)
    ref = np.asarray(jax_dcn(x, offset, mask, weight))
    epi = None
    if epilogue:
        inv = (rng.rand(cout) + 0.5).astype(np.float32)
        shift = rng.randn(cout).astype(np.float32)
        ref = np.maximum(ref * inv + shift, 0.0)
        epi = (t(inv), t(shift))
    got = deform_conv2d(t(x), t(offset), t(mask), t(weight), epi)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["all_valid", "masked", "exhausted"])
def test_fps_matches_jax(case):
    """Indices equal (random points: no equidistant candidates). With
    "exhausted", more samples are drawn than there are valid points, so
    the -inf invalid points are taken last, in index order."""
    rng = np.random.RandomState(2)
    n = 400
    pts = (rng.randn(n, 3) * [20.0, 20.0, 2.0]).astype(np.float32)
    valid = None
    k = 64
    if case != "all_valid":
        valid = rng.rand(n) > 0.3
        valid[:5] = False               # the seed is not index 0
    if case == "exhausted":
        valid = rng.rand(n) > 0.9
        k = int(valid.sum()) + 10
    ref = np.asarray(jax_fps(jnp.asarray(pts), k,
                             None if valid is None else jnp.asarray(valid),
                             backend="xla"))
    got = farthest_point_sampling(t(pts), k,
                                  None if valid is None else t(valid))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_deformable_matches_jax():
    """Aggregation summed over each anchor's key points; locations spread
    past the image edges exercise the strict-inside gate and the
    out-of-level corners."""
    rng = np.random.RandomState(3)
    b, cams, c, g, k, p = 1, 3, 32, 4, 3, 20
    shapes = ((12, 20), (6, 10), (3, 5), (2, 3))
    feats = [rng.randn(b, cams, h, w, c).astype(np.float32)
             for h, w in shapes]
    loc = rng.uniform(-0.1, 1.1, (b, p * k, cams, 2)).astype(np.float32)
    wts = rng.rand(b, p * k, cams, 4, g).astype(np.float32)
    ref = np.asarray(jax_deformable(feats, loc, wts, g))
    ref = ref.reshape(b, p, k, c).sum(2)
    got = deformable_aggregation([t(f) for f in feats], t(loc), t(wts), k)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def _splat_inputs(seed):
    rng = np.random.RandomState(seed)
    grid = dict(H=12, W=10, D=4, pc_min=(-6.0, -5.0, -2.0), grid_size=1.0,
                scale_multiplier=3.0)
    axes = [np.arange(n) + 0.5 + lo for n, lo in
            zip((12, 10, 4), grid["pc_min"])]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(1, -1, 3)
    p, c = 40, 18
    means = (rng.rand(1, p, 3) * [12, 10, 4] + grid["pc_min"])
    scales = rng.rand(1, p, 3) * 1.2 + 0.2
    quat = rng.randn(1, p, 4)
    opa = rng.rand(1, p)
    sem = rng.rand(1, p, c - 1)
    sem = np.concatenate([sem / sem.sum(-1, keepdims=True),
                          np.zeros((1, p, 1))], -1)
    f32 = lambda a: np.asarray(a, np.float32)   # noqa: E731
    cov6 = np.asarray(build_covariance_inverse6(f32(scales), f32(quat)))
    return grid, [f32(a) for a in (pts, means, opa, sem, scales, cov6)]


def test_splat_matches_jax():
    """logits, bin_logits and density to 1e-4; labels (combine_geosem,
    first-index argmax) equal. Gaussians dense enough that most voxels are
    covered and labels vary."""
    grid, arrs = _splat_inputs(4)
    jgrid = JaxGrid(**grid)
    outs = jax_splat(*arrs, jgrid, variant="prob", per_axis_radii=False,
                     backend="xla")
    ref_labels = np.asarray(_labels_xla(outs, "prob", {"mode": "combine"}))
    logits, bins, dens, labels = splat_prob(*[t(a) for a in arrs],
                                            SplatGridSpec(**grid))
    for got, ref in zip((logits, bins, dens), outs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_array_equal(labels.numpy(), ref_labels)
    assert len(np.unique(ref_labels)) > 5


def test_sparse_conv_matches_jax():
    """One anchor per voxel (ROADMAP C5); neighbours past the grid edge
    and empty voxels contribute zero."""
    rng = np.random.RandomState(5)
    grid_size, pcr = (1.0, 1.0, 1.0), (0.0, 0.0, 0.0, 8.0, 8.0, 4.0)
    cells = rng.choice(8 * 8 * 4, 60, replace=False)
    vox = np.stack(np.unravel_index(cells, (8, 8, 4)), -1)
    xyz = (vox + rng.uniform(0.1, 0.9, vox.shape)).astype(np.float32)
    feats = rng.randn(60, 12).astype(np.float32)
    w = (rng.randn(5, 5, 5, 12, 16) / 30).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    jc, shape = jax_voxel_indices(jnp.asarray(xyz), pcr, grid_size)
    ref = np.asarray(jax_subm(feats, jc, shape, w, bias))
    tc, tshape = voxel_indices(t(xyz), pcr, grid_size)
    assert tshape == shape
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    nb = neighbor_anchors(tc, tshape, 5)
    got = submanifold_conv3d(t(feats), nb, t(w).permute(4, 0, 1, 2, 3),
                             t(bias))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
