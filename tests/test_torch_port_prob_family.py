"""The GaussianFormer-2 family in the PyTorch port (Prob-64, Prob-128,
Prob-256) and the prob head's two further modes, against the JAX package
on the CPU at fp32:

- the threshold label mode (``combine_geosem=False``): the plain version of
  K4's label epilogue against the JAX package's ``_labels_xla``, the head
  in that mode, and a whole tiny forward;
- per-axis splat radii (``use_localaggprob_fast``): ``SplatGridSpec.radii``
  and the head with them;
- ``prob_gs25600`` at full width: every leaf of the JAX init (shapes from
  ``jax.eval_shape``, no weights) lands on a port parameter of its shape.

Inputs come from numpy seeds. Tolerances: the head's float outputs to 1e-5
relative and absolute (fp32 sums of a few hundred terms in another order);
labels, radii and boxes exactly, except the labels of near-ties (below)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussianformer_tpu.configs import get_config as jax_get_config
from gaussianformer_tpu.models import BEVSegmentor as JaxSegmentor
from gaussianformer_tpu.models.encoder.modules import \
    GaussianPrediction as JaxPrediction
from gaussianformer_tpu.models.head.gaussian_head import \
    GaussianHead as JaxHead
from gaussianformer_tpu.ops.splat import SplatGridSpec as JaxGrid
from gaussianformer_tpu.ops.splat import _labels_xla, _postprocess_prob

from gaussianformer_tpu_torch.configs import get_config
from gaussianformer_tpu_torch.kernels.splat import (labels_from_acc,
                                                    splat_accumulate)
from gaussianformer_tpu_torch.models.encoder.modules import \
    GaussianPrediction
from gaussianformer_tpu_torch.models.head.gaussian_head import GaussianHead
from gaussianformer_tpu_torch.models.segmentor import BEVSegmentor
from gaussianformer_tpu_torch.ops.splat import SplatGridSpec, pack_gaussians
from gaussianformer_tpu_torch.utils.convert import (jax_paths,
                                                    jax_to_state_dict)

from test_torch_port_model import tiny_pair

C, EMPTY, THRESH = 18, 17, 0.5
# a label may differ where the occupancy is within this of the threshold,
# or where it is above and the two largest normalised semantics are within
# it of each other: the two packages round the sums that decide it
# differently
NEAR = 1e-6
GRID = dict(H=20, W=20, D=8, pc_min=(-50.0, -50.0, -5.0), grid_size=5.0,
            scale_multiplier=4.0)


def near_ties(logits, bins):
    """Voxels whose threshold label the rounding of their sums may flip."""
    top2 = np.sort(logits, -1)[..., -2:]
    return ((np.abs(bins - THRESH) < NEAR)
            | ((bins > THRESH) & (top2[..., 1] - top2[..., 0] < NEAR)))


def _accumulators(seed: int = 3, n: int = 4000):
    """acc [N, C + 2] and one_minus [N] as a prob splat leaves them: zero
    semantics in the empty lane, rows below the 1e-9 probability sum
    (uniform fallback), rows with two equal top semantics (the first
    index wins in both packages) and rows at the threshold exactly."""
    rng = np.random.RandomState(seed)
    ps = rng.rand(n) * 3.0
    sem = rng.dirichlet(np.ones(C - 1), n) * ps[:, None]
    sem[:50] = 0.0
    ps[:50] = rng.rand(50) * 1e-9                 # uncovered
    sem[50:100, 4] = sem[50:100, 9] = sem[50:100].max(-1) + 0.5
    acc = np.concatenate([sem, np.zeros((n, 1)), ps[:, None],
                          rng.rand(n, 1) * 4.0], -1).astype(np.float32)
    one_minus = rng.rand(n).astype(np.float32)
    one_minus[100:150] = 0.5                      # bins == thresh
    return acc, one_minus


def test_threshold_labels_match_jax_labels_xla():
    """``labels_from_acc(mode="threshold")`` against ``_labels_xla`` on
    the same accumulators: equal everywhere but near-ties, which include
    none of the exact ties, uncovered rows or rows at the threshold."""
    acc, one_minus = _accumulators()
    got = labels_from_acc(torch.from_numpy(acc), torch.from_numpy(one_minus),
                          mode="threshold", thresh=THRESH,
                          empty_label=EMPTY).numpy()
    logits, bins, _ = _postprocess_prob(jnp.asarray(acc),
                                        jnp.asarray(one_minus), C)
    ref = np.asarray(_labels_xla(
        (logits, bins), "prob",
        dict(mode="threshold", thresh=THRESH, empty_label=EMPTY)))
    assert got.dtype == np.int32 and got.shape == ref.shape
    skip = near_ties(np.asarray(logits), np.asarray(bins))
    skip[:150] = False     # ties and threshold rows are exact in both
    assert skip.sum() <= 5
    np.testing.assert_array_equal(got[~skip], ref[~skip])
    assert np.all(got[100:150] == EMPTY)          # 0.5 is not > 0.5
    assert np.all(got[50:100][bins[50:100] > THRESH] == 4)
    uncovered = got[:50][np.asarray(bins[:50]) > THRESH]
    assert uncovered.size and np.all(uncovered == 0)
    assert 0.2 < np.mean(got == EMPTY) < 0.8
    # the combine mode is the default and still matches
    comb = labels_from_acc(torch.from_numpy(acc), torch.from_numpy(one_minus))
    ref_comb = np.asarray(_labels_xla((logits, bins), "prob",
                                      dict(mode="combine")))
    np.testing.assert_array_equal(comb.numpy()[~skip], ref_comb[~skip])


@pytest.mark.parametrize("per_axis", [True, False])
def test_radii_match_jax(per_axis):
    """``SplatGridSpec.radii`` against the JAX package's, exactly: scales
    on the boundaries of whole voxels, below one voxel and up to 8 m."""
    rng = np.random.RandomState(5)
    scales = (rng.rand(600, 3) * 8.0).astype(np.float32)
    scales[:100] = rng.randint(1, 40, (100, 3)) * 0.125   # whole voxels
    scales[100:150] *= 1e-3
    spec = dict(GRID, grid_size=0.5)
    got = SplatGridSpec(**spec).radii(torch.from_numpy(scales), per_axis)
    ref = JaxGrid(**spec).radii(jnp.asarray(scales), per_axis=per_axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.min() == 1
    if per_axis:
        assert (got != got.amax(-1, keepdim=True)).any()
    else:
        assert (got == got[:, :1]).all()


def test_per_axis_boxes_sit_inside_the_isotropic_ones():
    rng = np.random.RandomState(6)
    p = 200
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    means = t(rng.uniform(-40, 40, (p, 3)) * [1.0, 1.0, 0.1])
    scales = t(rng.uniform(0.1, 4.0, (p, 3)))
    cov6 = t(np.tile([1.0, 1.0, 1.0, 0.0, 0.0, 0.0], (p, 1)))
    args = (means, t(rng.rand(p)), t(rng.rand(p, C)), scales, cov6,
            SplatGridSpec(**GRID))
    _, iso, _ = pack_gaussians(*args)
    _, axis, _ = pack_gaussians(*args, per_axis=True)
    assert (axis[:, :3] >= iso[:, :3]).all()
    assert (axis[:, 3:] <= iso[:, 3:]).all()
    assert (axis != iso).any()


def test_label_mode_is_a_keyword_of_the_prob_splat():
    """The threshold mode rides on the prob variant only; an unknown mode
    or a mode for the additive splat is refused."""
    rng = np.random.RandomState(7)
    p = 40
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    grid = SplatGridSpec(**GRID)
    axes = [torch.arange(n) * 5.0 + 2.5 + lo
            for n, lo in zip((20, 20, 8), GRID["pc_min"])]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    tables = pack_gaussians(
        t(rng.uniform(-40, 40, (p, 3)) * [1.0, 1.0, 0.1]), t(rng.rand(p)),
        t(rng.dirichlet(np.ones(C), p)), t(rng.uniform(1.0, 6.0, (p, 3))),
        t(np.tile([0.2, 0.2, 0.2, 0.0, 0.0, 0.0], (p, 1))), grid)
    acc, om, labels = splat_accumulate(pts, *tables, grid,
                                       label_mode="threshold", thresh=0.3,
                                       empty_label=EMPTY)
    np.testing.assert_array_equal(
        labels.numpy(), labels_from_acc(acc, om, "threshold", 0.3,
                                        EMPTY).numpy())
    assert (labels == EMPTY).any() and (labels != EMPTY).any()
    with pytest.raises(ValueError, match="label mode"):
        splat_accumulate(pts, *tables, grid, label_mode="argmax")
    with pytest.raises(ValueError, match="additive"):
        splat_accumulate(pts, *tables, grid, "additive",
                         label_mode="threshold")


def _prediction(rng, p, cls):
    """A refine layer's Gaussians inside the tiny grid: anisotropic
    scales of 0.5-6 m (boxes of 1-5 voxels a side), raw semantics."""
    fields = dict(
        means=rng.uniform(-1, 1, (1, p, 3)) * [45.0, 45.0, 3.5] + [0, 0, -1],
        scales=rng.uniform(0.5, 6.0, (1, p, 3)),
        rotations=rng.randn(1, p, 4),
        opacities=rng.rand(1, p, 1),
        semantics=rng.randn(1, p, C - 1) * 2.0)
    conv = (lambda a: torch.from_numpy(np.asarray(a, np.float32))) \
        if cls is GaussianPrediction else \
        (lambda a: jnp.asarray(a, jnp.float32))
    return cls(**{k: conv(v) for k, v in fields.items()})


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("combine_geosem,per_axis",
                         [(True, False), (False, False), (False, True),
                          (True, True)])
def test_prob_head_modes_match_jax(combine_geosem, per_axis, training):
    """The prob head in combine and threshold label modes, with isotropic
    and per-axis radii, at inference and in training (the JAX head labels
    through its XLA twin there; the port always through K4's epilogue):
    pred_occ, bin_logits, density to 1e-5, final_occ equal but near-ties."""
    axes = [np.arange(n, dtype=np.float32) * 5.0 + 2.5 + lo
            for n, lo in zip((20, 20, 8), GRID["pc_min"])]
    occ_xyz = np.stack(np.meshgrid(*axes, indexing="ij"), -1)[None]
    occ_label = np.zeros((1, 20, 20, 8), np.int32)
    occ_mask = np.ones((1, 20, 20, 8), bool)
    kw = dict(apply_loss_type="random_1", num_classes=C, empty_label=EMPTY,
              use_localaggprob=True, combine_geosem=combine_geosem,
              per_axis_radii=per_axis, sigmoid_thresh=THRESH)
    p = 300
    jrep = [_prediction(np.random.RandomState(31 + i), p, JaxPrediction)
            for i in range(2)]
    jmod = JaxHead(grid=JaxGrid(**GRID), **kw)
    ref = jmod.apply({}, jrep, occ_xyz, occ_label, occ_mask,
                     training=training)
    port = GaussianHead(SplatGridSpec(**GRID), **kw)
    trep = [_prediction(np.random.RandomState(31 + i), p, GaussianPrediction)
            for i in range(2)]
    got = port(trep, torch.from_numpy(occ_xyz), torch.from_numpy(occ_label),
               torch.from_numpy(occ_mask), training=training)
    for key in ("pred_occ", "bin_logits", "density"):
        assert len(got[key]) == 1
        np.testing.assert_allclose(got[key][-1].detach().numpy(),
                                   np.asarray(ref[key][-1]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    bins = np.asarray(ref["bin_logits"][-1])
    pred = np.asarray(ref["pred_occ"][-1])
    if combine_geosem:
        top2 = np.sort(pred, -1)[..., -2:]
        skip = top2[..., 1] - top2[..., 0] < NEAR
    else:
        skip = near_ties(pred, bins)
    assert skip.mean() < 0.01
    labels = got["final_occ"].numpy()
    np.testing.assert_array_equal(labels[~skip],
                                  np.asarray(ref["final_occ"])[~skip])
    if not combine_geosem:
        # pred_occ is the normalised semantics (zero empty lane), and both
        # sides of the threshold are populated
        np.testing.assert_allclose(pred[bins > 1e-3].sum(-1), 1.0, rtol=1e-4)
        assert 0.05 < np.mean(labels == EMPTY) < 0.95
        assert len(np.unique(labels)) > 4


@pytest.fixture(scope="module")
def threshold_slice():
    cfg = dataclasses.replace(get_config("prob_gs6400_tiny"),
                              combine_geosem=False,
                              use_localaggprob_fast=True)
    jmodel, variables, port, batch = tiny_pair(seed=0, cfg=cfg)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jout = jax.jit(lambda v: jmodel.apply(
        v, jb["imgs"], jb["projection_mat"], jb["image_wh"],
        occ_xyz=jb["occ_xyz"], occ_label=jb["occ_label"],
        occ_cam_mask=jb["occ_cam_mask"], training=False,
        rng=jax.random.PRNGKey(0)))(variables)
    with torch.inference_mode():
        tout = port(batch["imgs"], batch["projection_mat"],
                    batch["image_wh"], batch["occ_xyz"])
    return cfg, jout, tout


def test_threshold_per_axis_slice_matches_jax(threshold_slice):
    """The whole tiny prob forward with the threshold label mode and
    per-axis radii: pred_occ (the normalised semantics), bin_logits and
    density to 1e-4 (as the combine slice's test), final_occ equal but
    near-ties."""
    cfg, jout, tout = threshold_slice
    assert tout["final_occ"].shape == (1, cfg.grid.num_voxels)
    for key in ("pred_occ", "bin_logits", "density"):
        np.testing.assert_allclose(tout[key][-1].numpy(),
                                   np.asarray(jout[key][-1]), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    pred = np.asarray(jout["pred_occ"][-1])
    bins = np.asarray(jout["bin_logits"][-1])
    skip = near_ties(pred, bins)
    assert skip.mean() < 0.01
    got = tout["final_occ"].numpy()
    np.testing.assert_array_equal(got[~skip],
                                  np.asarray(jout["final_occ"])[~skip])
    assert np.any(got == cfg.empty_label) and np.any(got != cfg.empty_label)


def test_prob_gs25600_places_every_jax_leaf():
    """Full width (19,200 FPS anchors + 6,400 random ones, two ResNet-101
    towers): the JAX init's leaves, from ``jax.eval_shape``, convert onto
    the port's state_dict key for key and shape for shape, and
    ``jax_paths`` names each leaf once. The port is built on the meta
    device: no weights are made."""
    name = "prob_gs25600"
    cfg, jcfg = get_config(name), jax_get_config(name)
    jmodel = JaxSegmentor(**jcfg.segmentor_cfg())
    g = cfg.grid
    f32 = jnp.float32
    args = (jax.ShapeDtypeStruct((1, 6) + cfg.input_size + (3,), f32),
            jax.ShapeDtypeStruct((1, 6, 4, 4), f32),
            jax.ShapeDtypeStruct((1, 6, 2), f32))
    occ = dict(occ_xyz=jax.ShapeDtypeStruct((1, g.H, g.W, g.D, 3), f32),
               occ_label=jax.ShapeDtypeStruct((1, g.H, g.W, g.D), jnp.int32),
               occ_cam_mask=jax.ShapeDtypeStruct((1, g.H, g.W, g.D), bool))
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda *a, **k: jmodel.init(
        {"params": key, "dropout": key}, *a, training=False, rng=key, **k),
        *args, **occ)
    # zero-stride stand-ins: the converter only moves axes
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
        dict(shapes))
    assert zeros["params"]["lifter"]["anchor"].shape[0] == 19200
    assert zeros["params"]["lifter"]["random_anchors"].shape[0] == 6400
    paths = jax_paths(zeros)
    n_leaves = len(jax.tree_util.tree_leaves(zeros))
    assert len(paths) == n_leaves and len(set(paths.values())) == n_leaves
    sd = jax_to_state_dict(zeros)
    with torch.device("meta"):
        port = BEVSegmentor(cfg)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert set(sd) == set(want)
    bad = {k: (tuple(v.shape), want[k]) for k, v in sd.items()
           if tuple(v.shape) != want[k]}
    assert not bad
