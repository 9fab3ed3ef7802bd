"""The backward of the port's three kernel ops against the JAX package, on
the CPU at fp32 (where each autograd Function runs its plain forward and
backward; the CUDA kernels K5-K7 are held against those on the card).

One cotangent, made with numpy from a seed, goes through ``jax.vjp`` and
through the port's autograd Function. The JAX side runs its CPU paths: the
exact DCN gather, the XLA deformable gather, the XLA splat (autodiff) and
the hand-derived ``splat_backward``. Tolerance: |port - jax| <= 1e-4 *
(1 + |jax|) elementwise (fp32 on both sides, sums in another order), or
1e-4 of the largest |jax| for the sums over many terms.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussianformer_tpu.ops.covariance import build_covariance_inverse6
from gaussianformer_tpu.ops.dcn import deform_conv2d as jax_dcn
from gaussianformer_tpu.ops.deformable import \
    deformable_aggregation as jax_deformable
from gaussianformer_tpu.ops.splat import SplatGridSpec as JaxGrid
from gaussianformer_tpu.ops.splat import splat as jax_splat
from gaussianformer_tpu.ops.splat import splat_backward as jax_splat_bwd

from gaussianformer_tpu_torch.kernels.dcn import (DeformConv2dFunction,
                                                  window_outside_share)
from gaussianformer_tpu_torch.kernels.deformable import \
    deformable_aggregation
from gaussianformer_tpu_torch.ops.splat import SplatGridSpec, splat_prob

TOL = 1e-4


def t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def close(got, ref, scale_tol=False, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, err_msg
    if scale_tol:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=TOL * np.abs(ref).max(),
                                   err_msg=err_msg)
    else:
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL,
                                   err_msg=err_msg)


@pytest.mark.parametrize("h,w,px", [(7, 9, 3), (20, 37, 12)])
def test_dcn_grads_match_jax(h, w, px):
    """g_x, g_offset, g_mask, g_weight. Offsets of up to ``px`` pixels push
    corners out of the image and, at 12 px, far outside the backward
    kernel's g_x window (8 x 8 tiles with a 3-pixel halo), the regime of
    its fallback records; every sample's fractional part lies in
    [0.1, 0.9], away from the integer positions where bilinear gradients
    jump."""
    rng = np.random.RandomState(11)
    b, cin, cout = 2, 16, 8
    x = rng.randn(b, h, w, cin).astype(np.float32)
    offset = (rng.randint(-px, px + 1, (b, h, w, 18))
              + rng.uniform(0.1, 0.9, (b, h, w, 18))).astype(np.float32)
    mask = (1 / (1 + np.exp(-rng.randn(b, h, w, 9)))).astype(np.float32)
    weight = (rng.randn(3, 3, cin, cout) / 12).astype(np.float32)
    g_out = rng.randn(b, h, w, cout).astype(np.float32)
    if px > 3:  # most corners in the image take the kernel's fallback
        assert window_outside_share(t(offset))[0] > 0.3
    out, vjp = jax.vjp(lambda *a: jax_dcn(*a), x, offset, mask, weight)
    refs = vjp(jnp.asarray(g_out))
    leaves = [t(a, True) for a in (x, offset, mask, weight)]
    got = DeformConv2dFunction.apply(*leaves)
    close(got, out)
    grads = torch.autograd.grad(got, leaves, t(g_out))
    for name, g, r in zip(("x", "offset", "mask", "weight"), grads, refs):
        close(g, r, scale_tol=True, err_msg=name)


def test_deformable_grads_match_jax():
    """Feature, location and weight gradients of the aggregation summed
    over key points; locations past the image edges exercise the
    strict-inside gate and the out-of-level corners."""
    rng = np.random.RandomState(12)
    b, cams, c, g, k, p = 1, 3, 32, 4, 3, 20
    shapes = ((12, 20), (6, 10), (3, 5), (2, 3))
    feats = [rng.randn(b, cams, h, w, c).astype(np.float32)
             for h, w in shapes]
    loc = rng.uniform(-0.1, 1.1, (b, p * k, cams, 2)).astype(np.float32)
    wts = rng.rand(b, p * k, cams, 4, g).astype(np.float32)
    g_out = rng.randn(b, p, c).astype(np.float32)

    def ref_fn(feats, loc, wts):
        out = jax_deformable(list(feats), loc, wts, g)
        return out.reshape(b, p, k, c).sum(2)

    out, vjp = jax.vjp(ref_fn, tuple(feats), loc, wts)
    r_feats, r_loc, r_wts = vjp(jnp.asarray(g_out))
    t_feats = [t(f, True) for f in feats]
    t_loc, t_wts = t(loc, True), t(wts, True)
    got = deformable_aggregation(t_feats, t_loc, t_wts, k)
    close(got, out)
    grads = torch.autograd.grad(got, t_feats + [t_loc, t_wts], t(g_out))
    for lvl in range(4):
        close(grads[lvl], r_feats[lvl], scale_tol=True,
              err_msg=f"level {lvl}")
    close(grads[4], r_loc, scale_tol=True, err_msg="loc")
    close(grads[5], r_wts, scale_tol=True, err_msg="weights")


def _splat_case(seed):
    """A raster voxel grid (x slowest, z fastest), Gaussians dense enough
    that most voxels are covered, and cotangents for the three outputs."""
    rng = np.random.RandomState(seed)
    grid = dict(H=12, W=10, D=4, pc_min=(-6.0, -5.0, -2.0), grid_size=1.0,
                scale_multiplier=3.0)
    axes = [np.arange(n) + 0.5 + lo for n, lo in
            zip((12, 10, 4), grid["pc_min"])]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(1, -1, 3)
    p, c = 40, 18
    f32 = lambda a: np.asarray(a, np.float32)   # noqa: E731
    means = rng.rand(1, p, 3) * [12, 10, 4] + grid["pc_min"]
    scales = rng.rand(1, p, 3) * 1.2 + 0.2
    quat = rng.randn(1, p, 4)
    opa = rng.rand(1, p)
    sem = rng.rand(1, p, c - 1)
    sem = np.concatenate([sem / sem.sum(-1, keepdims=True),
                          np.zeros((1, p, 1))], -1)
    cov6 = np.asarray(build_covariance_inverse6(f32(scales), f32(quat)))
    n = pts.shape[1]
    cots = (rng.randn(1, n, c), rng.randn(1, n), rng.randn(1, n))
    return (grid, [f32(a) for a in (pts, means, opa, sem, scales, cov6)],
            [f32(a) for a in cots])


@pytest.fixture(scope="module")
def splat_grads():
    grid, arrs, cots = _splat_case(13)
    pts, means, opa, sem, scales, cov6 = arrs
    jgrid = JaxGrid(**grid)

    def fwd(means, opa, sem, cov6):
        return jax_splat(pts, means, opa, sem, scales, cov6, jgrid,
                         variant="prob", per_axis_radii=False,
                         backend="xla")

    outs, vjp = jax.vjp(fwd, means, opa, sem, cov6)
    autodiff = vjp(tuple(jnp.asarray(x) for x in cots))
    # the residuals of splat_backward: logits, prob_sum, one_minus, from
    # the dense reference's pieces
    from gaussianformer_tpu.ops.splat import _NORM_3D, det_compact
    logits = outs[0]
    prob_sum = _prob_sum(pts, means, opa, scales, cov6, jgrid, _NORM_3D,
                         det_compact)
    one_minus = 1.0 - outs[1]
    hand = jax_splat_bwd(pts, means, opa, sem, scales, cov6, jgrid,
                         (logits, prob_sum, one_minus),
                         tuple(jnp.asarray(x) for x in cots),
                         variant="prob", per_axis_radii=False)
    leaves = [t(a, True) for a in (means, opa, sem, cov6)]
    logits_t, bins_t, dens_t, _ = splat_prob(
        t(pts), leaves[0], leaves[1], leaves[2], t(scales), leaves[3],
        SplatGridSpec(**grid))
    port = torch.autograd.grad((logits_t, bins_t, dens_t), leaves,
                               [t(x) for x in cots])
    return port, autodiff, hand


def _prob_sum(pts, means, opa, scales, cov6, jgrid, norm, det_compact):
    """sum_g w_g power_g per voxel, the forward's probability sum."""
    pts_i = np.asarray(jgrid.voxelize(jnp.asarray(pts)))
    mu_i = np.asarray(jgrid.voxelize(jnp.asarray(means)))
    rad = np.asarray(jgrid.radii(jnp.asarray(scales), per_axis=False))
    d = means[:, None] - pts[:, :, None]                     # [1, N, P, 3]
    xx, yy, zz, xy, yz, xz = np.moveaxis(cov6, -1, 0)
    logit = (-0.5 * (xx[:, None] * d[..., 0] ** 2
                     + yy[:, None] * d[..., 1] ** 2
                     + zz[:, None] * d[..., 2] ** 2)
             - (xy[:, None] * d[..., 0] * d[..., 1]
                + yz[:, None] * d[..., 1] * d[..., 2]
                + xz[:, None] * d[..., 0] * d[..., 2]))
    inside = np.all(np.abs(pts_i[:, :, None] - mu_i[:, None])
                    <= rad[:, None], -1)
    power = np.exp(np.minimum(logit, 30.0)) * inside
    w = norm * np.sqrt(np.maximum(np.asarray(det_compact(cov6)), 1e-30)) \
        * opa
    return jnp.asarray((power * w[:, None]).sum(-1), jnp.float32)


@pytest.mark.parametrize("reference", ["autodiff", "splat_backward"])
@pytest.mark.parametrize("index,name", [(0, "means"), (1, "opacities"),
                                        (2, "semantics"), (3, "cov_inv6")])
def test_splat_grads_match_jax(splat_grads, reference, index, name):
    """The port's splat backward (K7's plain version) against autodiff of
    the JAX XLA splat and against its hand-derived ``splat_backward``."""
    port, autodiff, hand = splat_grads
    ref = autodiff if reference == "autodiff" else hand
    close(port[index], ref[index], scale_tol=True, err_msg=name)
