"""The parts of K2 (``kernels/fps.py``, ``csrc/fps.cu``) that hold on the
CPU: the wrapper's spatial order, and the fp32 argument behind the
kernel's pruning, that a warp's box distance, computed with the distance
pass's own operations, never exceeds the computed distance of a point in
the box (IEEE rounding to nearest is monotonic)."""
import numpy as np
import pytest
import torch

from gaussianformer_tpu_torch.kernels import fps


def test_spatial_order_is_a_permutation_in_morton_order():
    # the 8 corners of a cube: Morton code x | y << 1 | z << 2
    corners = torch.tensor([[x, y, z] for z in (0.0, 1.0) for y in (0.0, 1.0)
                            for x in (0.0, 1.0)])
    shuffled = corners[torch.tensor([5, 2, 7, 0, 3, 6, 1, 4])]
    order = fps.spatial_order(shuffled)
    assert order.dtype == torch.int32
    assert torch.equal(shuffled[order.long()], corners)
    # non-finite coordinates: still a permutation
    pts = torch.randn(1000, 3)
    pts[3] = float("inf")
    pts[7, 1] = float("nan")
    assert torch.equal(fps.spatial_order(pts).sort().values,
                       torch.arange(1000, dtype=torch.int32))


def test_spatial_order_makes_compact_runs():
    gen = torch.Generator().manual_seed(0)
    pts = torch.randn(32768, 3, generator=gen) * torch.tensor([25., 25., 2.])
    runs = pts[fps.spatial_order(pts).long()].reshape(-1, 256, 3)
    span = (runs.amax(1) - runs.amin(1)).median(0).values
    whole = pts.amax(0) - pts.amin(0)
    # 128 runs of a flat cloud: each spans about a tenth of the wide axes
    assert (span[:2] < whole[:2] / 10).all()


def _sq_dist(dx, dy, dz):
    """The kernel's squared distance in fp32: ((dx dx + dy dy) + dz dz)."""
    return (dx * dx + dy * dy) + dz * dz


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_distance_never_exceeds_a_point_distance_in_fp32(seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    for scale in (1e-3, 1.0, 37.0, 1e4):
        pts = (rng.normal(size=(256, 3)) * scale).astype(f)
        lo, hi = pts.min(0), pts.max(0)
        news = (rng.normal(size=(200, 3)) * scale * 3).astype(f)
        # points just outside a face, where rounding matters most
        news[:50] = lo - (np.abs(rng.normal(size=(50, 3))) * scale
                          * 1e-6).astype(f)
        for new in news:
            e = np.maximum(np.maximum(lo - new, new - hi), f(0))
            dbox = _sq_dist(e[0], e[1], e[2])
            d = pts - new
            dp = _sq_dist(d[:, 0], d[:, 1], d[:, 2])
            assert dbox.dtype == f and dp.dtype == f
            assert (dp >= dbox).all()
