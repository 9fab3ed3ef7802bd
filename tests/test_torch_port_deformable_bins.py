"""K6's pixel bins (``kernels/deformable.py``: ``bin_samples_plain``, the
plain version of ``csrc/deformable_bin.cu``) on the CPU: against a
brute-force walk over the samples in order, on points outside the images,
on the 0 / 1 edges, with corners outside their level, with many key points
on one pixel, over one to four levels and two batch elements; and the
feature gradients gathered from those bins
(``feature_grads_from_bins_plain``, the plain twin of K6's features
launch) against ``deformable_aggregation_backward_plain`` and JAX's VJP of
``gaussianformer_tpu.ops.deformable.deformable_aggregation``, at
``test_deformable_grads_match_jax``'s tolerance (1e-4 of the largest
|jax|). Inputs are made with numpy from a seed."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussianformer_tpu.ops.deformable import \
    deformable_aggregation as jax_deformable

from gaussianformer_tpu_torch.kernels import deformable

TOL = 1e-4
SHAPES = ((12, 20), (6, 10), (3, 5), (2, 3))


def _points(rng, b, q, cams, hot=0):
    """Locations in [-0.1, 1.1): some outside, a few exactly on the 0 / 1
    edges (outside by the strict gate) or just inside them (corners
    outside the level); ``hot`` pairs of one camera image on one
    location."""
    loc = rng.uniform(-0.1, 1.1, (b, q, cams, 2)).astype(np.float32)
    flat = loc.reshape(-1, 2)
    n = flat.shape[0]
    idx = rng.permutation(n)
    edges = np.array([0.0, 1.0, 1e-4, 1 - 1e-4, 0.5], np.float32)
    for i in idx[:min(40, n // 4)]:
        flat[i, rng.randint(2)] = edges[rng.randint(len(edges))]
    if hot:
        # pairs of camera 0 of the first batch element: one plane
        same = [i for i in idx[::-1] if i % cams == 0 and i < q * cams]
        flat[same[:hot]] = np.array([0.43, 0.61], np.float32)
    return loc


def _brute_force(loc, shapes):
    """Per pixel key, the entries (sample * 4 + corner) in sample order."""
    b, q, cams, _ = loc.shape
    levels = len(shapes)
    offsets, off = [], 0
    for h, w in shapes:
        offsets.append(off)
        off += b * cams * h * w
    lists = [[] for _ in range(off)]
    pair = 0
    for bi in range(b):
        for qi in range(q):
            for cam in range(cams):
                u, v = loc[bi, qi, cam]
                if 0 < u < 1 and 0 < v < 1:
                    for lvl, (h, w) in enumerate(shapes):
                        w_im = np.float32(u * np.float32(w)) - np.float32(0.5)
                        h_im = np.float32(v * np.float32(h)) - np.float32(0.5)
                        h0, w0 = int(np.floor(h_im)), int(np.floor(w_im))
                        for n in range(4):
                            hy, wx = h0 + (n >> 1), w0 + (n & 1)
                            if 0 <= hy < h and 0 <= wx < w:
                                key = (offsets[lvl]
                                       + ((bi * cams + cam) * h + hy) * w
                                       + wx)
                                lists[key].append(
                                    (pair * levels + lvl) * 4 + n)
                pair += 1
    return lists


@pytest.mark.parametrize("levels,b,hot", [(1, 1, 0), (2, 2, 0), (3, 1, 20),
                                          (4, 2, 24)])
def test_plain_bins_match_brute_force(levels, b, hot):
    rng = np.random.RandomState(21 + levels)
    shapes = SHAPES[:levels]
    loc = _points(rng, b, 24, 3, hot)
    bins = deformable.bin_samples_plain(torch.from_numpy(loc), shapes)
    want = _brute_force(loc, shapes)
    start = bins.pixel_start.tolist()
    ent = bins.entries.tolist()
    assert len(start) == len(want) + 1 and start[0] == 0
    assert start[-1] == len(ent) == bins.num_entries == sum(map(len, want))
    for key, lst in enumerate(want):
        assert ent[start[key]:start[key + 1]] == lst, key
    if hot:
        # the hot location's pixel holds every hot pair's entry
        assert bins.stats()["longest_list"] >= hot


def test_plain_bins_no_pair_inside():
    loc = np.full((1, 6, 2, 2), 1.5, np.float32)
    loc[0, :3] = 0.0                     # on the edge: outside
    bins = deformable.bin_samples_plain(torch.from_numpy(loc), SHAPES)
    assert bins.num_entries == 0
    assert bins.pixel_start.tolist() == [0] * (2 * sum(
        h * w for h, w in SHAPES) + 1)


def _case(seed, b, hot=0):
    rng = np.random.RandomState(seed)
    cams, c, g, k, p = 3, 32, 4, 3, 20
    feats = [rng.randn(b, cams, h, w, c).astype(np.float32)
             for h, w in SHAPES]
    loc = _points(rng, b, p * k, cams, hot)
    wts = rng.rand(b, p * k, cams, 4, g).astype(np.float32)
    g_out = rng.randn(b, p, c).astype(np.float32)
    return feats, loc, wts, g_out, k, g


@pytest.mark.parametrize("b,hot", [(1, 0), (2, 40)])
def test_gathered_feature_grads_match_plain_and_jax(b, hot):
    """Each pixel's sum over its list equals the autograd gradient of the
    plain aggregation and JAX's VJP."""
    feats, loc, wts, g_out, k, g = _case(12 + b, b, hot)
    p = g_out.shape[1]
    t_feats = [torch.from_numpy(f) for f in feats]
    t_loc, t_wts = torch.from_numpy(loc), torch.from_numpy(wts)
    t_gout = torch.from_numpy(g_out)
    bins = deformable.bin_samples_plain(t_loc, SHAPES)
    got = deformable.feature_grads_from_bins_plain(t_feats, t_loc, t_wts, k,
                                                   t_gout, bins)
    plain = deformable.deformable_aggregation_backward_plain(
        t_feats, t_loc, t_wts, k, t_gout)[0]

    def ref_fn(feats):
        out = jax_deformable(list(feats), jnp.asarray(loc), jnp.asarray(wts),
                             g)
        return out.reshape(b, p, k, -1).sum(2)

    _, vjp = jax.vjp(ref_fn, tuple(feats))
    ref = vjp(jnp.asarray(g_out))[0]
    for lvl in range(len(SHAPES)):
        r = np.asarray(ref[lvl])
        atol = TOL * np.abs(r).max()
        assert got[lvl].dtype == torch.float32
        np.testing.assert_allclose(got[lvl].numpy(), r, rtol=0, atol=atol,
                                   err_msg=f"level {lvl} vs jax")
        np.testing.assert_allclose(got[lvl].numpy(), plain[lvl].numpy(),
                                   rtol=0, atol=atol,
                                   err_msg=f"level {lvl} vs plain")


def test_gathered_feature_grads_in_bf16():
    """bf16 maps: the gathered sums are fp32 and cast once, as the plain
    backward casts its fp32 gradient."""
    feats, loc, wts, g_out, k, _ = _case(17, 1)
    t_feats = [torch.from_numpy(f).bfloat16() for f in feats]
    t_loc, t_wts = torch.from_numpy(loc), torch.from_numpy(wts)
    t_gout = torch.from_numpy(g_out)
    bins = deformable.bin_samples_plain(t_loc, SHAPES)
    got = deformable.feature_grads_from_bins_plain(t_feats, t_loc, t_wts, k,
                                                   t_gout, bins)
    plain = deformable.deformable_aggregation_backward_plain(
        t_feats, t_loc, t_wts, k, t_gout)[0]
    for a, r in zip(got, plain):
        assert a.dtype == torch.bfloat16
        tol = 2.0 ** -7 * r.float().abs().max().item()
        assert (a.float() - r.float()).abs().max().item() <= tol
