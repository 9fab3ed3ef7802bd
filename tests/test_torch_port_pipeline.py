"""What a CUDA graph of the port's frame rests on, held on the CPU: the
lifter's draws made ahead give the bits of drawing inside the forward;
the bench's ``--pipeline`` has no CPU version; the splat bins' bound
(``kernels/splat.py::entries_bound``, which sizes the card's bins with no
host read) holds the entries of the tiny and full-width boxes; and the
binning's flag word, whose plain version is ``bin_flags_plain``, tells
the raster voxel grid from other points, which take the splat's general
mode (``raster_path``; on the card, a ``cuda`` case by the launch
counters)."""
import numpy as np
import pytest
import torch

from gaussianformer_tpu_torch import bench
from gaussianformer_tpu_torch.configs import get_config
from gaussianformer_tpu_torch.data.synthetic import synthetic_batch
from gaussianformer_tpu_torch.kernels import splat
from gaussianformer_tpu_torch.models.segmentor import build_segmentor
from gaussianformer_tpu_torch.ops.splat import pack_gaussians


def _tiny(seed=0):
    cfg = get_config("prob_gs6400_tiny")
    g = cfg.grid
    model = build_segmentor(cfg, device="cpu", seed=seed)
    batch = synthetic_batch(1, cfg.input_size, (g.H, g.W, g.D), seed=seed,
                            device="cpu")
    return cfg, model, batch


def test_predrawn_lifter_draws_equal_drawn_ones():
    """``GaussianLifterV2.draw`` draws what the forward draws, in its
    order: a frame on them equals, to the bit, the frame that draws from
    a generator of the same seed (the lifter's anchors and final_occ);
    another seed gives other anchors."""
    cfg, model, batch = _tiny()
    args = (batch["imgs"], batch["projection_mat"], batch["image_wh"],
            batch["occ_xyz"])

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def frame(seed=None, draws=None):
        """The lifter's anchors and the frame's labels, drawing from
        generators of ``seed`` or on ``draws``."""
        with torch.inference_mode():
            rep = model.lifter(*args[:3], draws=draws, generator=(
                None if seed is None else gen(seed)))["representation"]
            occ = model(*args, occ_only=True, lifter_draws=draws,
                        generator=None if seed is None else gen(seed))
        return rep, occ["final_occ"]

    drawn = frame(seed=3)
    draws = model.lifter.draw(batch["imgs"], gen(3))
    assert draws[2].shape == (1, cfg.num_cams, cfg.input_size[0] // 8,
                              cfg.input_size[1] // 8, 1)
    ahead = frame(draws=draws)
    assert torch.equal(drawn[0], ahead[0])
    assert torch.equal(drawn[1], ahead[1])
    other = frame(draws=model.lifter.draw(batch["imgs"], gen(4)))
    assert not torch.equal(drawn[0], other[0])
    with pytest.raises(ValueError, match="depth draws"):
        frame(draws=draws[:2] + (draws[2][..., :2, :],))


def test_deterministic_lifter_draws_no_depth_uniforms():
    """With top-1 depths the forward draws only the padding's numbers, and
    so does ``draw``."""
    _, model, batch = _tiny()
    model.lifter.deterministic_sampling = True
    pick, noise, u = model.lifter.draw(batch["imgs"],
                                       torch.Generator().manual_seed(1))
    assert u is None
    ref = torch.Generator().manual_seed(1)
    assert torch.equal(pick, torch.randint(0, pick.shape[1], pick.shape,
                                           generator=ref))


def test_pipeline_refuses_the_cpu():
    """``--pipeline`` captures a CUDA graph: on the CPU it raises before
    building anything, with no fallback to the loop."""
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run("prob_gs6400_tiny", 1, "cpu", pipeline_frames=2)


def _tiles_met(box, grid):
    """Per box, the tiles its clipped box meets (numpy)."""
    dims = np.array([grid.H, grid.W, grid.D])
    lo = np.maximum(box[:, :3], 0)
    hi = np.minimum(box[:, 3:], dims - 1)
    t = np.array(splat.TILE)
    n = np.where(lo <= hi, hi // t - lo // t + 1, 0)
    return n.prod(-1)


@pytest.mark.parametrize("name", ["prob_gs6400_tiny", "prob_gs6400",
                                  "prob_gs12800", "prob_gs25600",
                                  "gs25600_solid", "gs144000",
                                  "gs25600_solid_tiny"])
def test_bins_bound_holds_the_boxes(name):
    """The config's radius bound holds the radii of its largest scale
    (fp32, as the refinement makes it), and ``entries_bound`` the tiles
    of boxes of that radius anywhere in and around the grid, the v1 head's
    whole-grid Gaussian included; the most tiles one such box meets is the
    bound's per-box count."""
    cfg = get_config(name)
    grid = cfg.grid
    lo, hi = cfg.scale_range
    logit = torch.full((4, 3), 9.21)
    scales = lo + (hi - lo) * torch.sigmoid(logit)
    r = grid.radius_bound(hi)
    assert int(grid.radii(scales).max()) <= r
    rng = np.random.RandomState(0)
    p = 4000
    centre = np.stack([rng.randint(-r, n + r, p)
                       for n in (grid.H, grid.W, grid.D)], -1)
    rad = rng.randint(grid.radii_min, r + 1, (p, 1))
    rad[: p // 2] = r
    box = np.concatenate([centre - rad, centre + rad], -1)
    whole = int(cfg.with_empty)
    if whole:
        box = np.concatenate([box, [[-600, -600, -600, 600, 600, 600]]])
    tiles = _tiles_met(box, grid)
    bound = splat.entries_bound(box.shape[0], grid, r, whole)
    assert tiles.sum() <= bound
    per = splat.entries_bound(1, grid, r)
    assert tiles[: p // 2].max() == per
    plain = splat.bin_gaussians_plain(torch.from_numpy(box).int(), grid)
    assert plain.num_entries == tiles.sum()


def test_flags_refuse_non_raster_points():
    """The binning's flag word (plain version): the raster grid passes,
    points in another order or moved off their voxel set NOT_RASTER, too
    small a bound OVER_BOUND; ``check_flags`` raises ValueError for
    either, as a check after a CUDA graph's replay does. The routing of
    ``raster_path``: only points declared the grid, as many as its voxels
    and not flagged, take the raster mode; an eager call (the flag word
    read) sends flagged ones to the general mode, while a capture (no read)
    keeps the declared raster mode and its deferred check raises."""
    cfg = get_config("prob_gs6400_tiny")
    grid = cfg.grid
    batch = synthetic_batch(1, cfg.input_size, (grid.H, grid.W, grid.D),
                            seed=0, device="cpu")
    pts = batch["occ_xyz"].reshape(-1, 3).float()
    gen = torch.Generator().manual_seed(0)
    n = 40
    means = (torch.rand(n, 3, generator=gen) * torch.tensor(
        [100.0, 100.0, 8.0]) + torch.tensor([-50.0, -50.0, -5.0]))
    scales = torch.rand(n, 3, generator=gen) * 3.0 + 0.2
    _, box, _ = pack_gaussians(means, torch.rand(n, generator=gen),
                               torch.rand(n, 18, generator=gen), scales,
                               torch.rand(n, 6, generator=gen), grid)
    assert splat.bin_flags_plain(pts, box, grid) == 0
    splat.check_flags(torch.tensor([0]))
    moved = pts.clone()
    moved[5] += grid.grid_size
    nv = grid.num_voxels
    for bad in (pts.flip(0), moved):
        bits = splat.bin_flags_plain(bad, box, grid)
        assert bits == splat.NOT_RASTER
        with pytest.raises(ValueError, match="raster"):
            splat.check_flags(torch.tensor([bits]))
        # eager: the general mode; captured: the raster mode, then a raise
        assert not splat.raster_path(nv, grid, True, bits)
        assert splat.raster_path(nv, grid, True, None)
    assert splat.raster_path(nv, grid, True, 0)
    for n_pts, declared in ((nv, False), (nv - 1, True), (2 * nv, True)):
        for bits in (0, None):
            assert not splat.raster_path(n_pts, grid, declared, bits)
    e = splat.bin_gaussians_plain(box, grid).num_entries
    assert splat.bin_flags_plain(pts, box, grid, e) == 0
    bits = splat.bin_flags_plain(pts, box, grid, e - 1)
    assert bits == splat.OVER_BOUND
    with pytest.raises(ValueError, match="bound"):
        splat.check_flags(torch.tensor([bits]))


@pytest.mark.cuda
def test_declared_grid_that_is_not_one_takes_the_general_mode():
    """On the card, an eager ``splat_prob`` / ``splat_additive`` call that
    declares the raster grid at points that are not it (the grid reversed)
    raises nothing and takes the general mode, by the launch counters: one
    Gaussian binning (its raster check read once), one points binning and
    one general K4; the backward one general K7. Its outputs are those of
    the same call not declaring the grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gaussianformer_tpu_torch.kernels import _lib
    from gaussianformer_tpu_torch.ops.covariance import \
        build_covariance_inverse6
    from gaussianformer_tpu_torch.ops.splat import (splat_additive,
                                                    splat_prob)
    grid = get_config("prob_gs6400_tiny").grid
    gen = torch.Generator(device="cuda").manual_seed(0)
    axes = [torch.arange(n, device="cuda") * grid.grid_size
            + 0.5 * grid.grid_size + lo
            for n, lo in zip((grid.H, grid.W, grid.D), grid.pc_min)]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(
        1, -1, 3).flip(1).contiguous()
    p = 64
    span = torch.tensor([grid.H, grid.W, grid.D], device="cuda") \
        * grid.grid_size
    means = (torch.tensor(grid.pc_min, device="cuda")
             + torch.rand(1, p, 3, generator=gen, device="cuda") * span)
    scales = torch.rand(1, p, 3, generator=gen, device="cuda") * 2 + 0.3
    cov6 = build_covariance_inverse6(
        scales, torch.randn(1, p, 4, generator=gen, device="cuda"))
    sem = torch.softmax(torch.randn(1, p, 18, generator=gen, device="cuda"),
                        -1)
    opa = torch.rand(1, p, generator=gen, device="cuda")
    for fn, fwd, bwd in ((splat_prob, "splat_points", "splat_points_bwd"),
                         (splat_additive, "splat_points_additive",
                          "splat_points_bwd_additive")):
        outs = []
        for declared in (True, False):
            leaves = [t.clone().requires_grad_(True)
                      for t in (means, opa, sem, cov6)]
            _lib.reset_launches()
            out = fn(pts, *leaves[:3], scales, leaves[3], grid,
                     grid_ordered=declared)
            out[0].sum().backward()
            torch.cuda.synchronize()
            counts = {k: v for k, v in _lib.LAUNCHES.items() if v}
            assert counts == {"splat_bin": 1, "splat_points_bin": 1,
                              fwd: 1, bwd: 1}, counts
            outs.append([o.detach() for o in out]
                        + [t.grad for t in leaves])
        for a, b in zip(*outs):
            assert torch.equal(a, b)
