"""The port's additive splat (the v1 models' variant of kernels K4 / K7,
here their plain versions) against the JAX package, on the CPU at fp32.

Forward: ``splat_additive`` against ``splat_dense_reference`` and against
the Pallas kernel in interpret mode with its label epilogue, as
tests/test_splat_pallas.py runs it. Backward: autograd through
``SplatAdditiveFunction`` against ``jax.grad`` of the dense reference and
against the hand-derived ``splat_backward``, as tests/test_splat_backward.py
does. Two cases: ``whole_grid`` ends with the v1 head's empty Gaussian
(scale (100, 100, 8), a box that clips to the whole grid); ``sparse`` keeps
every Gaussian in one half of the grid, so the other half's voxels lie in
no box, sum to zero and get label 0.

Tolerance: 1e-4 relative and absolute on the sums (fp32 sums of up to 65
terms in another order); gradients to 1e-4 of the largest |reference|.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussianformer_tpu.ops.covariance import build_covariance_inverse6
from gaussianformer_tpu.ops.splat import SplatGridSpec as JaxGrid
from gaussianformer_tpu.ops.splat import splat as jax_splat
from gaussianformer_tpu.ops.splat import splat_backward as jax_splat_bwd
from gaussianformer_tpu.ops.splat import (splat_deferred,
                                          splat_dense_reference)

from gaussianformer_tpu_torch.kernels.splat import (splat_accumulate,
                                                    splat_backward)
from gaussianformer_tpu_torch.ops.splat import (SplatGridSpec, pack_gaussians,
                                                splat_additive)

TOL = 1e-4
GRID = dict(H=16, W=16, D=8, pc_min=(-8.0, -8.0, -4.0), grid_size=1.0,
            scale_multiplier=3.0)
C = 18


def t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _case(name):
    rng = np.random.RandomState(21 if name == "sparse" else 22)
    axes = [np.arange(n) + 0.5 + lo for n, lo in
            zip((16, 16, 8), GRID["pc_min"])]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(1, -1, 3)
    p = 64
    span = [7.0, 16.0, 8.0] if name == "sparse" else [16.0, 16.0, 8.0]
    means = rng.rand(1, p, 3) * span + GRID["pc_min"]
    scales = rng.rand(1, p, 3) * 0.5 + 0.15        # radii of 1-2 voxels
    quat = rng.randn(1, p, 4)
    opa = rng.rand(1, p)
    # softplus-like positive semantics with a zero empty channel
    sem = np.concatenate([np.log1p(np.exp(rng.randn(1, p, C - 1))),
                          np.zeros((1, p, 1))], -1)
    if name == "whole_grid":
        means = np.concatenate([means, [[[0.0, 0.0, -1.0]]]], 1)
        scales = np.concatenate([scales, [[[100.0, 100.0, 8.0]]]], 1)
        quat = np.concatenate([quat, [[[1.0, 0.0, 0.0, 0.0]]]], 1)
        opa = np.concatenate([opa, [[1.0]]], 1)
        e_sem = np.zeros((1, 1, C))
        e_sem[..., C - 1] = 0.7
        sem = np.concatenate([sem, e_sem], 1)
    f32 = lambda a: np.asarray(a, np.float32)   # noqa: E731
    cov6 = np.asarray(build_covariance_inverse6(f32(scales), f32(quat)))
    g_logits = f32(rng.randn(1, pts.shape[1], C))
    return [f32(a) for a in (pts, means, opa, sem, scales, cov6)], g_logits


@pytest.fixture(scope="module", params=["whole_grid", "sparse"])
def case(request):
    arrs, g_logits = _case(request.param)
    leaves = [t(arrs[i], True) for i in (1, 2, 3, 5)]
    logits, labels = splat_additive(t(arrs[0]), leaves[0], leaves[1],
                                    leaves[2], t(arrs[4]), leaves[3],
                                    SplatGridSpec(**GRID))
    grads = torch.autograd.grad(logits, leaves, t(g_logits))
    return dict(name=request.param, arrs=arrs, g_logits=g_logits,
                logits=logits.detach().numpy(), labels=labels.numpy(),
                grads=[g.numpy() for g in grads])


def _assert_labels(got, ref_logits, ref_labels):
    """Equal labels wherever the reference's two largest sums differ by
    more than 1e-6: a voxel that only the far tails of a few Gaussians
    reach has sums near the smallest fp32 numbers, which the two packages
    round (or flush to zero) differently. The voxels no box holds are
    checked on their own."""
    top2 = np.sort(ref_logits, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-6
    assert clear.mean() > 0.25
    np.testing.assert_array_equal(got[clear], ref_labels[clear])


def test_additive_forward_matches_dense_reference(case):
    (ref,) = splat_dense_reference(*case["arrs"], JaxGrid(**GRID),
                                   variant="additive", per_axis_radii=False)
    ref = np.asarray(ref)
    assert case["logits"].shape == ref.shape == (1, 16 * 16 * 8, C)
    np.testing.assert_allclose(case["logits"], ref, rtol=TOL, atol=TOL)
    _assert_labels(case["labels"], ref, ref.argmax(-1))


def test_additive_forward_matches_pallas_interpret(case):
    """The TPU kernel itself, interpreted on the CPU: its sums and the
    labels of its in-kernel epilogue (mode "additive")."""
    kw = dict(variant="additive", per_axis_radii=False, backend="pallas",
              grid_ordered=True, interpret=True, pallas_tile_n=128,
              pallas_chunk_g=32)
    jgrid = JaxGrid(**GRID)
    (ref,) = jax_splat(*case["arrs"], jgrid, **kw)
    np.testing.assert_allclose(case["logits"], np.asarray(ref), rtol=TOL,
                               atol=TOL)
    outs, unpatch = splat_deferred(
        *case["arrs"], jgrid, emit_labels=dict(mode="combine", thresh=0.5,
                                               empty_label=C - 1), **kw)
    _assert_labels(case["labels"], np.asarray(ref),
                   np.asarray(unpatch(outs[-1])))


def test_additive_uncovered_voxels_and_whole_grid_box(case):
    """``sparse``: the voxels no box holds are exactly zero and labelled
    0. ``whole_grid``: the empty Gaussian's clipped box is the whole grid,
    so every voxel has a positive empty-channel sum."""
    pts, means, opa, sem, scales, cov6 = [t(a[0]) for a in case["arrs"]]
    grid = SplatGridSpec(**GRID)
    _, box, _ = pack_gaussians(means, opa, sem, scales, cov6, grid,
                               "additive")
    pint = grid.voxelize(pts)
    held = ((pint[:, None] >= box[None, :, :3])
            & (pint[:, None] <= box[None, :, 3:])).all(-1).any(-1).numpy()
    if case["name"] == "sparse":
        assert 0.2 < held.mean() < 0.8
        assert np.all(case["logits"][0][~held] == 0.0)
        assert np.all(case["labels"][0][~held] == 0)
        assert len(np.unique(case["labels"][0][held])) > 5
    else:
        assert held.all()
        assert box[-1, :3].min() < -100 and box[-1, 3:].max() > 100
        assert np.all(case["logits"][0][:, C - 1] > 0.0)


@pytest.mark.parametrize("reference", ["autodiff", "splat_backward"])
@pytest.mark.parametrize("index,name", [(0, "means"), (1, "opacities"),
                                        (2, "semantics"), (3, "cov_inv6")])
def test_additive_grads_match_jax(case, reference, index, name):
    pts, means, opa, sem, scales, cov6 = case["arrs"]
    jgrid = JaxGrid(**GRID)
    g = jnp.asarray(case["g_logits"])
    if reference == "autodiff":
        def loss(means, opa, sem, cov6):
            (out,) = splat_dense_reference(
                pts, means, opa, sem, scales, cov6, jgrid,
                variant="additive", per_axis_radii=False)
            return jnp.sum(out * g)
        ref = jax.grad(loss, argnums=(0, 1, 2, 3))(means, opa, sem, cov6)
    else:
        ref = jax_splat_bwd(pts, means, opa, sem, scales, cov6, jgrid, (),
                            (g,), variant="additive", per_axis_radii=False)
    ref = np.asarray(ref[index])
    got = case["grads"][index]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * np.abs(ref).max(),
                               err_msg=name)
    if case["name"] == "whole_grid":
        # the empty Gaussian's own row (only its semantics gradient
        # reaches a parameter, head.empty_scalar)
        np.testing.assert_allclose(
            got[0, -1], ref[0, -1], rtol=0,
            atol=TOL * max(np.abs(ref[0, -1]).max(), 1e-12), err_msg=name)


def test_wrappers_refuse_a_wrong_variant_or_stray_scalars():
    arrs, g_logits = _case("sparse")
    pts, means, opa, sem, scales, cov6 = [t(a[0]) for a in arrs]
    grid = SplatGridSpec(**GRID)
    gdata, box, sem_aug = pack_gaussians(means, opa, sem, scales, cov6, grid,
                                         "additive")
    with pytest.raises(ValueError, match="variant"):
        splat_accumulate(pts, gdata, box, sem_aug, grid, "threshold")
    with pytest.raises(ValueError, match="variant"):
        splat_backward(pts, gdata, opa, sem, box, t(g_logits[0]), None, grid,
                       "fast")
    acc, one_minus, labels = splat_accumulate(pts, gdata, box, sem_aug, grid,
                                              "additive")
    assert one_minus is None and acc.shape == (pts.shape[0], C + 2)
    # the appended columns: the sum of opa e, and of e
    assert torch.all(acc[:, C] <= acc[:, C + 1] + 1e-6)
