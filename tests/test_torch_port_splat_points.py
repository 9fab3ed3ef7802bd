"""The splat at query points that are not the splat grid, the general mode
of kernels K4 and K7, held on the CPU at fp32 against the JAX package.

- ``bin_points_plain`` (the plain twin of the card's points binning,
  ``csrc/splat_points_bin.cu``) against a brute-force binning: points past
  ``pc_range`` (they fall into border voxels), empty tiles, a tile of more
  than ``TILE_VOXELS`` points, and point counts that are multiples of
  nothing.
- The port's plain ``prob`` splat (both label modes) and ``additive``
  splat at a shuffled grid twice as fine as the splat grid, with points
  outside the range, against the TPU kernel in its ``zrun = 0`` mode
  (``splat(..., backend="pallas", interpret=True, grid_ordered=False)``,
  its labels from the kernel's own epilogue) and against the XLA path.
- The plain backward (autograd through the port's splat functions) against
  ``jax.grad`` of the same Pallas splat, whose VJP runs the TPU backward
  kernel in interpret mode, at the same points.
- With weights carried over by ``utils.convert.jax_to_state_dict``: the
  tiny ``prob_gs6400`` forward with an ``occ_xyz`` twice as fine as its
  grid, and one tiny ``gs25600_solid`` train step at such points, against
  the JAX model (whose head declares no grid order there either).

Tolerances: sums and the model's outputs to 1e-4 (fp32 sums in another
order); labels equal wherever the reference's top two scores differ by
more than 1e-6 (near-ties may flip); gradients to 1e-4 of the largest
|reference| (the splat) or 2e-3 by relative norm per leaf (a whole train
step, as tests/test_torch_port_v1_train.py holds it); losses to 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussianformer_tpu.configs import get_config as jax_get_config
from gaussianformer_tpu.ops.covariance import build_covariance_inverse6
from gaussianformer_tpu.ops.splat import SplatGridSpec as JaxGrid
from gaussianformer_tpu.ops.splat import (_labels_xla, _splat_pallas_fwd_only,
                                          splat as jax_splat)
from gaussianformer_tpu.train.step import build_loss as jax_build_loss
from gaussianformer_tpu.train.step import optax_global_norm

from gaussianformer_tpu_torch.configs import get_config
from gaussianformer_tpu_torch.data.synthetic import finer_points
from gaussianformer_tpu_torch.kernels import splat as ksplat
from gaussianformer_tpu_torch.ops.splat import (SplatGridSpec, pack_gaussians,
                                                splat_additive, splat_prob)
from gaussianformer_tpu_torch.train.step import build_loss
from gaussianformer_tpu_torch.utils.convert import jax_to_state_dict

from test_torch_port_model import tiny_pair
from test_torch_port_v1_model import jax_batch, v1_pair

TOL = 1e-4
GRAD_REL = 2e-3
GRID = dict(H=16, W=16, D=8, pc_min=(-8.0, -8.0, -4.0), grid_size=1.0,
            scale_multiplier=3.0)
C = 18
PALLAS = dict(backend="pallas", interpret=True, grid_ordered=False,
              pallas_tile_n=128, pallas_chunk_g=32, per_axis_radii=False)


def t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# ---------------------------------------------------------------------------
# the points binning


def _brute_bins(points, grid):
    """Each voxel's points in input order, tile-major (a tile's voxels by
    their place x | y | z, z fastest), each key's first place and each
    tile's work items, by loops over the points and voxels."""
    nt = ksplat.tile_counts(grid)
    tiles = nt[0] * nt[1] * nt[2]
    tv = ksplat.TILE_VOXELS
    per_key = [[] for _ in range(tiles * tv)]
    for i, v in enumerate(grid.voxelize(points).tolist()):
        tx, ty, tz = (v[a] // ksplat.TILE[a] for a in range(3))
        lx, ly, lz = (v[a] % ksplat.TILE[a] for a in range(3))
        tile = (tx * nt[1] + ty) * nt[2] + tz
        per_key[tile * tv + (lx * 8 + ly) * 16 + lz].append(i)
    order, vstart, items = [], [], []
    for t in range(tiles):
        first = len(order)
        for k in range(t * tv, (t + 1) * tv):
            vstart.append(len(order))
            order += per_key[k]
        items += list(range(first, len(order), tv))
    vstart.append(len(order))
    bound = ksplat.points_items_bound(points.shape[0], grid)
    items = items + [-1] * (bound - len(items)) + [len(items)]
    return order, vstart, items


@pytest.mark.parametrize("case", ["outside", "crowded", "odd", "none"])
def test_bin_points_plain_matches_brute_force(case):
    """Border tiles collect the clamped points, a crowded tile gives more
    than one work item, empty tiles give none, each voxel's points keep
    their input order, and every array has the length its bound gives."""
    rng = np.random.RandomState(3)
    grid = SplatGridSpec(H=20, W=12, D=20, pc_min=(-5.0, -3.0, -5.0),
                         grid_size=0.5)
    lo = np.array(grid.pc_min)
    span = np.array([10.0, 6.0, 10.0])
    n = {"outside": 3001, "crowded": 2777, "odd": 997, "none": 0}[case]
    pts = lo - 0.3 * span + rng.rand(n, 3) * span * 1.6
    if case == "crowded":
        pts[:1500] = lo + rng.rand(1500, 3) * 0.4
    if case == "odd":
        pts[:, 0] = lo[0] + rng.rand(n) * 3.0   # the far x tiles stay empty
    if case == "outside":
        # past the range below y: the border tiles collect them, the far y
        # tiles stay empty
        pts[:, 1] = lo[1] - 2.0 + rng.rand(n) * 4.0
    points = torch.from_numpy(pts.astype(np.float32))
    got = ksplat.bin_points_plain(points, grid)
    order, vstart, items = _brute_bins(points, grid)
    assert got.order.tolist() == order
    assert got.voxel_start.tolist() == vstart
    assert got.items.tolist() == items
    counts = np.diff(got.tile_start.numpy())
    if case == "crowded":
        assert counts.max() > ksplat.TILE_VOXELS
        assert got.num_items > (counts > 0).sum()
        assert got.stats()["max_voxel_points"] > 100
    if case in ("outside", "odd"):
        assert (counts == 0).any() and (counts > 0).any()
    if case == "outside":
        outside = ((pts < lo) | (pts >= lo + span)).any(-1)
        assert outside.mean() > 0.3
    assert all(x.dtype == torch.int32 for x in (got.order, got.voxel_start,
                                                 got.items))


def _numpy_bins(pts, pc_min, gs, dims):
    """The sorted order and each key's first place by numpy alone: the
    voxel by floor and clamp, the key by the tile and the place in it, a
    stable argsort and a count a key."""
    v = np.clip(np.floor((pts - np.asarray(pc_min)) / gs).astype(np.int64),
                0, np.asarray(dims) - 1)
    nt = [-(-d // t) for d, t in zip(dims, (8, 8, 16))]
    tile = (v[:, 0] // 8 * nt[1] + v[:, 1] // 8) * nt[2] + v[:, 2] // 16
    key = tile * 1024 + ((v[:, 0] % 8) * 8 + v[:, 1] % 8) * 16 + v[:, 2] % 16
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=nt[0] * nt[1] * nt[2] * 1024)
    return order, np.concatenate([[0], np.cumsum(counts)])


@pytest.mark.parametrize("dims", [(16, 16, 16), (20, 12, 20), (9, 17, 33),
                                  (40, 8, 5)])
def test_voxel_runs_match_numpy(dims):
    """The sorted order and ``voxel_start`` against a numpy brute force at
    grids of full and partial tiles, with points past every face of
    ``pc_range`` (each clamped into its border voxel) and a pile-up in one
    voxel; every box's points within a tile are its columns' runs."""
    rng = np.random.RandomState(sum(dims))
    gs = 0.5
    grid = SplatGridSpec(H=dims[0], W=dims[1], D=dims[2],
                         pc_min=(-2.0, -3.0, -1.0), grid_size=gs)
    lo = np.array(grid.pc_min)
    span = np.array(dims) * gs
    inside = lo + rng.rand(3000, 3) * span
    faces = []
    for axis in range(3):
        for side in (-1.0, 1.0):
            p = lo + rng.rand(200, 3) * span
            p[:, axis] = (lo[axis] - 1.0 - rng.rand(200) * 5.0 if side < 0
                          else lo[axis] + span[axis] + rng.rand(200) * 5.0)
            faces.append(p)
    pile = np.repeat(lo[None] + 0.25 * gs, 700, 0)
    pts = np.concatenate([inside, *faces, pile])[rng.permutation(4900)]
    pts = pts.astype(np.float32)
    got = ksplat.bin_points_plain(torch.from_numpy(pts), grid)
    order, vstart = _numpy_bins(pts, grid.pc_min, gs, dims)
    np.testing.assert_array_equal(got.order.numpy(), order)
    np.testing.assert_array_equal(got.voxel_start.numpy(), vstart)
    assert got.stats()["max_voxel_points"] >= 700
    # a box's points in one tile: one run a column
    v = np.clip(np.floor((pts - lo) / gs).astype(np.int64), 0,
                np.array(dims) - 1)
    for _ in range(20):
        b_lo = rng.randint(0, 8, 3) * [1, 1, 2]
        b_hi = np.minimum(b_lo + rng.randint(0, 6, 3), [7, 7, 15])
        b_hi = np.minimum(b_hi, np.array(dims) - 1)
        want = np.flatnonzero(((v >= b_lo) & (v <= b_hi)).all(-1))
        runs = []
        for x in range(b_lo[0], b_hi[0] + 1):
            for y in range(b_lo[1], b_hi[1] + 1):
                k0 = (x * 8 + y) * 16 + b_lo[2]
                k1 = (x * 8 + y) * 16 + b_hi[2] + 1
                runs += order[vstart[k0]:vstart[k1]].tolist()
        assert sorted(runs) == want.tolist()


# ---------------------------------------------------------------------------
# the splat at arbitrary points


def _points_case(variant):
    """A grid twice as fine as GRID, shuffled and cut to an odd count,
    with 150 points past pc_range; Gaussians of mixed radii (prob: softmax
    semantics with a zero empty channel; additive: softplus-like ones)."""
    rng = np.random.RandomState(7 if variant == "prob" else 8)
    axes = [np.arange(2 * n) * 0.5 + 0.25 + lo
            for n, lo in zip((16, 16, 8), GRID["pc_min"])]
    fine = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    fine = fine[rng.permutation(fine.shape[0])[:2851]]
    lo = np.array(GRID["pc_min"])
    span = np.array([16.0, 16.0, 8.0])
    far = lo + (rng.rand(150, 3) * 2.0 - 0.5) * span
    far[:, 0] = np.where(far[:, 0] < 0, lo[0] - 3.0, lo[0] + span[0] + 3.0)
    pts = np.concatenate([fine, far])[rng.permutation(3001)][None]
    p = 48
    means = rng.rand(1, p, 3) * span + lo
    scales = rng.rand(1, p, 3) * 1.0 + 0.3
    quat = rng.randn(1, p, 4)
    opa = rng.rand(1, p)
    if variant == "prob":
        sem = rng.rand(1, p, C - 1)
        sem = np.concatenate([sem / sem.sum(-1, keepdims=True),
                              np.zeros((1, p, 1))], -1)
    else:
        sem = np.concatenate([np.log1p(np.exp(rng.randn(1, p, C - 1))),
                              np.zeros((1, p, 1))], -1)
    f32 = lambda a: np.asarray(a, np.float32)   # noqa: E731
    cov6 = np.asarray(build_covariance_inverse6(f32(scales), f32(quat)))
    return [f32(a) for a in (pts, means, opa, sem, scales, cov6)]


def _assert_labels(got, scores, ref):
    """Equal wherever the reference's top two scores differ by more than
    1e-6."""
    top2 = np.sort(scores, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-6
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[clear], ref[clear])


def _combine(logits, bins):
    return np.concatenate([logits[..., :-1] * bins[..., None],
                           1.0 - bins[..., None]], -1)


@pytest.fixture(scope="module")
def prob_case():
    return _points_case("prob")


@pytest.mark.parametrize("mode", ["combine", "threshold"])
def test_prob_splat_matches_the_tpu_kernel_at_any_points(prob_case, mode):
    """The port's plain prob splat against the Pallas kernel with zrun = 0
    (sums and its in-kernel labels) and against the XLA path with its
    label twin."""
    arrs = prob_case
    jgrid = JaxGrid(**GRID)
    emit = dict(mode=mode, thresh=0.6, empty_label=C - 1)
    got = splat_prob(*[t(a) for a in arrs], SplatGridSpec(**GRID),
                     label_mode=mode, thresh=0.6, empty_label=C - 1)
    got = [g.numpy() for g in got]
    pallas = jax_splat(*arrs, jgrid, variant="prob", **PALLAS)
    kernel = _splat_pallas_fwd_only(
        *[jnp.asarray(a) for a in arrs], jgrid, "prob", False, 128, 32,
        True, zrun=0, emit_labels=emit)
    xla = jax_splat(*arrs, jgrid, variant="prob", per_axis_radii=False,
                    backend="xla")
    for ref in (pallas, xla):
        for g, r in zip(got[:3], ref):
            np.testing.assert_allclose(g, np.asarray(r), rtol=TOL, atol=TOL)
    logits, bins = np.asarray(xla[0]), np.asarray(xla[1])
    scores = _combine(logits, bins) if mode == "combine" else logits
    for labels in (kernel[-1], _labels_xla(xla, "prob", emit)):
        labels = np.asarray(labels)
        if mode == "threshold":
            # near the threshold the occupancy decides, not the scores
            near = np.abs(bins - 0.6) < 1e-6
            assert not near.any()
        _assert_labels(got[3], scores, labels)
    assert len(np.unique(got[3])) > 4
    if mode == "threshold":
        assert 0.05 < (got[3] == C - 1).mean() < 0.95


def test_additive_splat_matches_the_tpu_kernel_at_any_points():
    """The port's plain additive splat against the Pallas kernel with
    zrun = 0 (its first-index argmax labels from the kernel) and the XLA
    path; points that no box reaches sum to zero and get label 0."""
    arrs = _points_case("additive")
    jgrid = JaxGrid(**GRID)
    logits, labels = splat_additive(*[t(a) for a in arrs],
                                    SplatGridSpec(**GRID))
    logits, labels = logits.numpy(), labels.numpy()
    (pallas,) = jax_splat(*arrs, jgrid, variant="additive", **PALLAS)
    _, kernel_labels = _splat_pallas_fwd_only(
        *[jnp.asarray(a) for a in arrs], jgrid, "additive", False, 128, 32,
        True, zrun=0, emit_labels=dict(mode="combine", thresh=0.5,
                                       empty_label=C - 1))
    (xla,) = jax_splat(*arrs, jgrid, variant="additive",
                       per_axis_radii=False, backend="xla")
    for ref in (pallas, xla):
        np.testing.assert_allclose(logits, np.asarray(ref), rtol=TOL,
                                   atol=TOL)
    ref = np.asarray(xla)
    _assert_labels(labels, ref, np.asarray(kernel_labels))
    # the points whose voxel no box holds (XLA on the CPU flushes the
    # denormal sums of a far tail, so they are found by the boxes)
    grid = SplatGridSpec(**GRID)
    pts, means, opa, sem, scales, cov6 = [t(a[0]) for a in arrs]
    _, box, _ = pack_gaussians(means, opa, sem, scales, cov6, grid,
                               "additive")
    vox = grid.voxelize(pts)
    held = ((vox[:, None] >= box[None, :, :3])
            & (vox[:, None] <= box[None, :, 3:])).all(-1).any(-1).numpy()
    assert (~held).any() and held.mean() > 0.5
    assert (logits[0][~held] == 0).all() and (labels[0][~held] == 0).all()


@pytest.mark.parametrize("variant", ["prob", "additive"])
def test_splat_grads_match_the_tpu_kernels_at_any_points(variant):
    """Autograd through the port's splat (the plain backward of K7's
    general mode) against ``jax.grad`` of the Pallas splat, whose VJP runs
    the TPU backward kernel in interpret mode, at the same points."""
    arrs = _points_case(variant)
    pts, means, opa, sem, scales, cov6 = arrs
    rng = np.random.RandomState(11)
    n = pts.shape[1]
    cots = [rng.randn(1, n, C).astype(np.float32)]
    if variant == "prob":
        cots += [rng.randn(1, n).astype(np.float32) for _ in range(2)]
    leaves = [t(a, True) for a in (means, opa, sem, cov6)]
    fn = splat_prob if variant == "prob" else splat_additive
    outs = fn(t(pts), *leaves[:3], t(scales), leaves[3],
              SplatGridSpec(**GRID))
    got = torch.autograd.grad(outs[:len(cots)], leaves,
                              [t(c) for c in cots])
    jgrid = JaxGrid(**GRID)

    def loss(means, opa, sem, cov6):
        outs = jax_splat(pts, means, opa, sem, scales, cov6, jgrid,
                         variant=variant, **PALLAS)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))
    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(means, opa, sem, cov6)
    for name, g, r in zip(("means", "opacities", "semantics", "cov_inv6"),
                          got, ref):
        r = np.asarray(r)
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=TOL * np.abs(r).max(), err_msg=name)


def test_crowded_tile_matches_the_tpu_kernels():
    """A tile of more than three work items (3600 points in the voxels of
    one tile, a third of them piled into one voxel): the port's plain prob
    splat against the Pallas kernel with zrun = 0 and the plain backward of
    both variants against ``jax.grad`` of the Pallas splat, at the
    tolerances above."""
    rng = np.random.RandomState(21)
    arrs = _points_case("prob")
    lo = np.array(GRID["pc_min"])
    crowd = lo + rng.rand(3600, 3) * np.array([8.0, 8.0, 8.0])
    crowd[:1200] = lo + np.array([2.3, 3.6, 1.1])
    pts = np.concatenate([crowd, arrs[0][0, :400]])[rng.permutation(4000)]
    pts = pts.astype(np.float32)[None]
    grid = SplatGridSpec(**GRID)
    bins = ksplat.bin_points_plain(t(pts[0]), grid)
    counts = np.diff(bins.tile_start.numpy())
    assert counts.max() > 3 * ksplat.TILE_VOXELS
    assert bins.num_items >= (counts > 0).sum() + 3
    jgrid = JaxGrid(**GRID)
    arrs = [pts] + arrs[1:]
    got = splat_prob(*[t(a) for a in arrs], grid)
    ref = jax_splat(*arrs, jgrid, variant="prob", **PALLAS)
    for g, r in zip(got[:3], ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=TOL,
                                   atol=TOL)
    n = pts.shape[1]
    for variant in ("prob", "additive"):
        case = _points_case(variant)
        means, opa, sem, scales, cov6 = case[1:]
        cots = [rng.randn(1, n, C).astype(np.float32)]
        if variant == "prob":
            cots += [rng.randn(1, n).astype(np.float32) for _ in range(2)]
        leaves = [t(a, True) for a in (means, opa, sem, cov6)]
        fn = splat_prob if variant == "prob" else splat_additive
        outs = fn(t(pts), *leaves[:3], t(scales), leaves[3], grid)
        grads = torch.autograd.grad(outs[:len(cots)], leaves,
                                    [t(c) for c in cots])

        def loss(means, opa, sem, cov6):
            outs = jax_splat(pts, means, opa, sem, scales, cov6, jgrid,
                             variant=variant, **PALLAS)
            return sum(jnp.sum(o * c) for o, c in zip(outs, cots))
        refs = jax.grad(loss, argnums=(0, 1, 2, 3))(means, opa, sem, cov6)
        for name, g, r in zip(("means", "opacities", "semantics",
                               "cov_inv6"), grads, refs):
            r = np.asarray(r)
            assert np.abs(r).max() > 0, (variant, name)
            np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                       atol=TOL * np.abs(r).max(),
                                       err_msg=f"{variant} {name}")


# ---------------------------------------------------------------------------
# the models at finer points


def test_prob_forward_at_finer_points_matches_jax():
    """The tiny prob_gs6400 forward with occ_xyz twice as fine as its grid
    (8 points a voxel; neither head declares a grid order): pred_occ,
    bin_logits and density to 1e-4, final_occ equal but for near-ties."""
    jmodel, variables, port, batch = tiny_pair()
    fine = finer_points(batch, 2)
    g = get_config("prob_gs6400_tiny").grid
    assert fine["occ_xyz"].shape[1:4] == (2 * g.H, 2 * g.W, 2 * g.D)
    jb = jax_batch(fine)
    jout = jax.jit(lambda v: jmodel.apply(
        v, jb["imgs"], jb["projection_mat"], jb["image_wh"],
        occ_xyz=jb["occ_xyz"], occ_label=jb["occ_label"],
        occ_cam_mask=jb["occ_cam_mask"], training=False,
        rng=jax.random.PRNGKey(0)))(variables)
    with torch.inference_mode():
        tout = port(fine["imgs"], fine["projection_mat"], fine["image_wh"],
                    fine["occ_xyz"])
    for key in ("pred_occ", "bin_logits", "density"):
        got, ref = tout[key][-1].numpy(), np.asarray(jout[key][-1])
        assert got.shape == ref.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL,
                                   err_msg=key)
    n = 8 * g.num_voxels
    assert tout["final_occ"].shape == (1, n)
    _assert_labels(tout["final_occ"].numpy(), np.asarray(jout["pred_occ"][-1]),
                   np.asarray(jout["final_occ"]))


def test_v1_train_step_at_finer_points_matches_jax():
    """One tiny gs25600_solid train step (OccupancyLoss as CE on logits
    plus Lovasz-softmax, backward through the additive splat's plain
    backward) with occ_xyz, occ_label and occ_cam_mask twice as fine as
    the grid: the loss terms and the gradient norm to 1e-4, every
    gradient leaf by relative norm within 2e-3 (the lifter's bank and the
    head's empty_scalar among them)."""
    cfg = dataclasses.replace(get_config("gs25600_solid_tiny"),
                              attn_drop=0.0, ffn_drop=0.0)
    jmodel, variables, port, batch = v1_pair(cfg)
    fine = finer_points(batch, 2)
    jb = jax_batch(fine)
    loss_fn = jax_build_loss(jax_get_config("gs25600_solid"))
    key = jax.random.PRNGKey(0)

    def compute_loss(params):
        out = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jb["imgs"], jb["projection_mat"], jb["image_wh"],
            occ_xyz=jb["occ_xyz"], occ_label=jb["occ_label"],
            occ_cam_mask=jb["occ_cam_mask"], training=True, rng=key,
            rngs={"dropout": key})
        return loss_fn(out)

    (jloss, jlogs), jgrads = jax.jit(jax.value_and_grad(
        compute_loss, has_aux=True))(variables["params"])
    ref = {"loss": float(jloss), "grad_norm": float(optax_global_norm(jgrads)),
           **{k: float(v) for k, v in jlogs.items()}}
    jgrads = jax_to_state_dict({"params": jgrads})

    out = port(fine["imgs"], fine["projection_mat"], fine["image_wh"],
               fine["occ_xyz"], fine["occ_label"], fine["occ_cam_mask"],
               training=True, generator=torch.Generator().manual_seed(0))
    loss, logs = build_loss(cfg)(out)
    loss.backward()
    grads = {n: p.grad for n, p in port.named_parameters()
             if p.grad is not None}
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    got = {"loss": loss.item(), "grad_norm": norm.item(),
           **{k: v.item() for k, v in logs.items()}}
    assert out["pred_occ"][-1].shape == (1, 8 * cfg.grid.num_voxels, C)
    assert set(got) == set(ref)
    for k in ref:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], ref[k], rtol=TOL, err_msg=k)
    assert set(grads) == set(jgrads)
    assert {"lifter.anchor", "lifter.instance_feature",
            "head.empty_scalar"} <= set(grads)
    bad = {}
    for name, r in jgrads.items():
        g = grads[name]
        rel = ((g - r).norm() / r.norm().clamp_min(1e-12)).item()
        if not (rel <= GRAD_REL or (g - r).abs().max() <= 1e-9):
            bad[name] = rel
    assert not bad, bad
